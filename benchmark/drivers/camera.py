"""Cells of the camera experiment: the program's
``experiments.opt_camera.CameraExperiment`` built from its command line,
as a user's run builds it, and its training step driven through
``experiments.common.StepChain`` (captured and replayed for ``chain`` > 1,
eager at 1), at one tau for every step, the poses and Adam restarted from
the starting poses every ``restart`` steps as the command line's settings
do.

The three steps that ``correct`` compares run through the window's own
StepChain and captured graph at the traffic's ``check_tau`` where it has
one (the anneal runs that graph at every tau, the vector of each step
being an input row): at the window's tau the first step alone is
compared, its loss, and the poses and Adam then restart.

The benchmark hands the program, and its reference, the mesh (an OBJ file
under TMPDIR, loaded through ``--model_obj``), the goal poses and the
starting poses, all drawn from the seed."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import problem
from benchmark.reference import camera as ref
from benchmark.reference import geometry as G
from benchmark.reference import raster as R


def mesh(cfg):
    """The teapot-scale stand-in: icosphere(level), deformed by the
    two-lobe formula at the configuration's fixed parameters."""
    m = cfg['mesh']
    v, f = G.icosphere(m['level'])
    return G.peanut(v, m['scale'], m['pinch']), f


def draw_poses(B, seed, a_min, a_max):
    """(goal poses, starting poses) [B, 4] as numpy float32: the goals as
    the command line draws them (distance 2.5-4, elevation and azimuth
    N(0, 60) degrees, fov 20), the starts a_min..a_max degrees off the
    goal in a random direction (distance 2-10, fov 10-30)."""
    rng = np.random.RandomState(seed % 2 ** 32)
    goal = np.zeros((B, 4), np.float32)
    goal[:, 0] = 2.5 + rng.rand(B) * 1.5
    goal[:, 1] = rng.randn(B) * 60
    goal[:, 2] = rng.randn(B) * 60
    goal[:, 3] = 20.0
    start = np.zeros((B, 4), np.float32)
    start[:, 0] = 2.0 + rng.rand(B) * 8.0
    start[:, 1] = rng.randn(B)
    start[:, 2] = rng.randn(B)
    ang = np.sqrt(start[:, 1] ** 2 + start[:, 2] ** 2)
    initial = a_min + rng.rand(B) * (a_max - a_min)
    start[:, 1] *= initial / ang
    start[:, 2] *= initial / ang
    start[:, 3] = 10.0 + rng.rand(B) * 20.0
    return goal, start


class Cell:
    """One run's system under test.  ``faults`` plants a fault in the
    program (for the benchmark's tests and calibration only): 'frozen',
    a step that leaves the poses unchanged; 'half_batch', a loss over half
    of the poses, scaled to the whole."""

    def __init__(self, cfg, traffic, seed, device, tmp, fault=None):
        from gendr_tpu_torch.experiments import opt_camera as OC
        self.cfg = cfg
        self.device = torch.device(device)
        self.tau = traffic['tau']
        self.check_tau = traffic.get('check_tau', self.tau)
        self.chain = traffic['chain']
        self.restart = traffic['restart']
        v, f = mesh(cfg)
        self.obj = os.path.join(tmp, 'standin.obj')
        G.write_obj(self.obj, v, f)
        argv = ['--model_obj', self.obj, '-bs', str(cfg['batch_size']),
                '-is', str(cfg['image_size']), '--dist-func',
                cfg['dist_func'], '--aggr-func', cfg['aggr_func'],
                '-de', str(cfg['dist_eps']), '-lr',
                str(cfg['learning_rate']), '--chain', str(self.chain),
                '--device', self.device.type]
        if fault == 'half_batch':
            whole = OC.iou_loss

            def half(p, t, reduce='mean'):
                h = p.shape[0] // 2
                return whole(p[:h], t[:h], reduce) * (2 if reduce == 'sum'
                                                      else 1)
            OC.iou_loss = half
            self._restore = lambda: setattr(OC, 'iou_loss', whole)
        else:
            self._restore = lambda: None
        self.exp = OC.CameraExperiment(OC.parse_args(argv), self.device)
        a_min, a_max = traffic['angles']
        self.goal, self.start = draw_poses(cfg['batch_size'], seed, a_min,
                                           a_max)
        exp = self.exp
        with torch.no_grad():
            exp.poses_gt.copy_(torch.as_tensor(self.goal))
            exp.goal = exp.render(exp.hard_renderer, exp.poses_gt)
        exp.begin(self.start)
        if fault == 'frozen':
            exp.opt.step = lambda *a, **k: None
        self.steps = exp.chain('iou')
        # every step's [16] render vector, at tau
        self.rows = self._rows(self.tau)
        self.done = 0

    def _rows(self, tau):
        return self.exp.diff_renderer.params_vector(
            dist_scale=tau)[None].repeat(self.chain, 1)

    def run(self, n, rows=None):
        """n steps through the StepChain (with ``rows``, at another tau):
        their losses, on the host, and how many were not finite."""
        if self.done and self.done % self.restart == 0:
            self.exp.begin(self.start)
        rows = self.rows if rows is None else rows
        losses = self.steps.run({'par': rows[:n]})[:, 0]
        self.done += n
        return losses, int((~torch.isfinite(losses)).sum())

    def block(self):
        """One block of the loop: at most ``chain`` steps, none across a
        restart."""
        return self.run(min(self.chain, self.restart
                            - self.done % self.restart))

    def first_steps(self, steps=3):
        """The first ``steps`` steps at check_tau, through the window's own
        call: the program's readings, dict(losses, grads {'poses': the
        first gradient, as Adam's state holds it after step 1}, change
        {'poses': after ``steps``}), and, where check_tau is not the
        window's tau, timed_loss: the loss of a first step at the
        window's tau, taken before them (it captures the graph)."""
        exp = self.exp
        out = {}
        rows = self.rows
        if self.check_tau != self.tau:
            out['timed_loss'] = float(self.run(1)[0][0])
            self._restart()
            rows = self._rows(self.check_tau)
        losses = self.run(1, rows)[0].tolist()
        state = exp.opt.state.get(exp.poses, {})
        b1 = exp.opt.param_groups[0]['betas'][0]
        grad = (state['exp_avg'].detach().cpu() / (1.0 - b1)
                if 'exp_avg' in state else torch.zeros(exp.poses.shape))
        losses += self.run(steps - 1, rows)[0].tolist()
        change = exp.poses.detach().cpu() - torch.as_tensor(self.start)
        if self.check_tau != self.tau:
            self._restart()
        out.update(losses=losses, grads={'poses': grad},
                   change={'poses': change})
        return out

    def _restart(self):
        self.exp.begin(self.start)
        self.done = 0

    def free(self):
        self._restore()
        del self.exp, self.steps

    def reference(self, steps=3, dtype=torch.float32):
        """The plain reference's readings over the same first steps."""
        out = ref.follow(self.obj, self.goal, self.start, self.cfg,
                         self.check_tau, steps, self.device, dtype)
        if self.check_tau != self.tau:
            out['timed_loss'] = ref.follow(
                self.obj, self.goal, self.start, self.cfg, self.tau, 1,
                self.device, dtype)['losses'][0]
        return out

    def work(self):
        """The step's work from the problem: the render's gated pairs at
        the starting poses, transformed by the reference side."""
        v, f = G.read_obj(self.obj)
        v = torch.as_tensor(v, device=self.device)
        xy = R.face_xy(ref.camera_vertices(
            v, torch.as_tensor(self.start, device=self.device),
            torch.as_tensor(self.goal, device=self.device)),
            torch.as_tensor(f, device=self.device))
        pairs = R.count_pairs(xy, self.cfg['image_size'], R.cull_margin(
            self.cfg['dist_func'], self.tau, self.cfg['dist_eps']))
        w = problem.render_work(pairs, self.cfg['batch_size'], f.shape[0],
                                self.cfg['image_size'])
        w['pairs'] = pairs
        w['step_flops'] = w['fwd_flops'] + w['bwd_flops']
        return w
