"""The cell of the textured fit: the program's
``experiments.fit_textured.TexturedFit`` built from its command line, as a
user's run builds it, and its training step driven through
``experiments.common.StepChain`` (captured and replayed for ``chain`` > 1,
eager at 1), at one tau for every step, the parameters and Adam restarted
from the template every ``restart`` steps.

The benchmark hands the program, and its reference, the goal mesh (the
camera configurations' pinched icosphere), its texel colours drawn from
the seed and the eyes of the view set; each side lights and renders its
own goal images.  The three steps that ``correct`` compares are the
window's first, through its own StepChain."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry as G
from benchmark.reference import raster as R
from benchmark.reference import textured as ref

# the view set's distance (opt_shape's cameras.npy)
DISTANCE = 2.732
# float operations a gated pair costs the render kernels with softmax RGB
# over a surface texture of more than one texel, counted in
# csrc/rasterize_{fwd,bwd}.cu as chip_smoke.py counts them (one per add,
# multiply, divide, compare, floor, min/max or transcendental): the
# softmax counts of one texel, 121 and 190, plus the texel of the folded
# grid (surface_texel_index: two multiplies, two floors, an add, a
# multiply, two subtracts and a compare, 9), which the forward takes once
# (sample_color) and the backward twice (sample_color, add_tex_grad)
FWD_FLOPS_PER_PAIR = 121 + 9
BWD_FLOPS_PER_PAIR = 190 + 2 * 9
NAMES = ('displace', 'center', 'texture')


def goal_mesh(cfg):
    """The camera configurations' stand-in: icosphere(level) deformed by
    the two-lobe formula at the configuration's fixed parameters."""
    m = cfg['mesh']
    v, f = G.icosphere(m['level'])
    return G.peanut(v, m['scale'], m['pinch']), f


def goal_textures(num_faces, TS, seed):
    """Per-texel colours [nf, TS, 3] in [0, 1) drawn from the seed."""
    rng = np.random.RandomState(seed % 2 ** 32)
    return rng.rand(num_faces, TS, 3).astype(np.float32)


def eyes(views, device):
    """'N@E' -> N eyes [N, 3] at elevation E degrees and distance 2.732,
    azimuths 0, -360 / N, ... (24: opt_shape's -15 degree steps)."""
    n, elev = views.split('@')
    n = int(n)
    az = -torch.arange(n, dtype=torch.float32) * (360.0 / n)
    return G.points_from_angles(torch.full((n,), DISTANCE),
                                torch.full((n,), float(elev)), az).to(device)


def template(num_vertices):
    """The sphere template (vertices [nv, 3], faces [nf, 3]) of
    ShapeModel(num_vertices): the icosphere of that many vertices."""
    level = {162: 2, 642: 3, 2562: 4}[num_vertices]
    return G.icosphere(level)


def start_pairs(cfg, tau, views, device):
    """The gated pairs of the first step's render: the template at its
    start (the sphere halved) seen from the view set at the render's size
    (twice image_size with anti-aliasing), at the uniform CDF's margin."""
    v, f = template(cfg['num_vertices'])
    v = torch.as_tensor(v, device=device) * 0.5
    xyz = ref.screen_faces(v[None], torch.as_tensor(f, device=device,
                                                    dtype=torch.long),
                           eyes(views, device))
    S = cfg['image_size'] * (2 if cfg['anti_aliasing'] else 1)
    return R.count_pairs(xyz[..., :2], S, R.cull_margin(
        cfg['dist_func'], tau, cfg['dist_eps']))


def render_work(pairs, batch, faces, TS, size):
    """{'fwd_flops', 'fwd_bytes', 'bwd_flops', 'bwd_bytes'} of one softmax
    RGB render over surface textures and its gradient: each input read
    once, each output written once (the faces' vertices, their textures,
    the [16] parameter vector, the RGBA image; in the backward also the
    image's gradient and the vertices' and textures' gradients;
    float32)."""
    fv = batch * faces * 9 * 4
    tex = batch * faces * TS * 3 * 4
    image = batch * 4 * size * size * 4
    return dict(fwd_flops=FWD_FLOPS_PER_PAIR * pairs,
                fwd_bytes=fv + tex + 64 + image,
                bwd_flops=BWD_FLOPS_PER_PAIR * pairs,
                bwd_bytes=fv + tex + 64 + 2 * image + fv + tex)


class Cell:
    """One run's system under test.  ``fault`` plants a fault in the
    program (for the benchmark's tests and calibration only): 'frozen',
    a step that leaves the parameters unchanged; 'half_batch', a loss over
    half of the views."""

    def __init__(self, cfg, traffic, seed, device, tmp, fault=None):
        from gendr_tpu_torch.experiments import fit_textured as FT
        self.cfg = cfg
        self.device = torch.device(device)
        self.tau = traffic['tau']
        self.chain = traffic['chain']
        self.restart = traffic['restart']
        self.views = traffic['views']
        v, f = goal_mesh(cfg)
        self.goal = (v, f, goal_textures(f.shape[0], cfg['texture_res'] ** 2,
                                         seed))
        argv = ['--texture-res', str(cfg['texture_res']),
                '-is', str(cfg['image_size']),
                '-nv', str(cfg['num_vertices']),
                '-lr', repr(cfg['learning_rate']),
                '--chain', str(self.chain), '--device', self.device.type]
        if fault == 'half_batch':
            whole = (FT.iou_loss, FT.mse_loss)

            def half(loss):
                return lambda p, t: loss(p[:p.shape[0] // 2],
                                         t[:t.shape[0] // 2])
            FT.iou_loss, FT.mse_loss = (half(f) for f in whole)

            def restore():
                FT.iou_loss, FT.mse_loss = whole
            self._restore = restore
        else:
            self._restore = lambda: None
        self.fit = FT.TexturedFit(FT.parse_args(argv), self.device)
        self.start = {k: torch.zeros(p.shape)
                      for k, p in zip(NAMES, self.fit.parameters())}
        self.eyes = eyes(self.views, self.device)
        targets = self.fit.goal_images(*self.goal, self.eyes)
        self.fit.begin(self.eyes, targets)
        if fault == 'frozen':
            self.fit.opt.step = lambda *a, **k: None
        self.steps = self.fit.steps
        # every step's [16] render vector, at tau
        self.rows = self.fit.renderer.params_vector(
            dist_scale=self.tau)[None].repeat(self.chain, 1)
        self.done = 0

    def run(self, n):
        """n steps through the StepChain: their losses, on the host, and
        how many were not finite."""
        if self.done and self.done % self.restart == 0:
            self.fit.begin(self.fit.eyes, self.fit.targets)
        res = self.steps.run({'par': self.rows[:n]})
        self.done += n
        bad = (~torch.isfinite(res[:, 0])) | (res[:, 1] == 0)
        return res[:, 0], int(bad.sum())

    def block(self):
        """One block of the loop: at most ``chain`` steps, none across a
        restart."""
        return self.run(min(self.chain, self.restart
                            - self.done % self.restart))

    def first_steps(self, steps=3):
        """The first ``steps`` steps, through the window's own call: the
        program's readings, dict(losses, grads {leaf: the first gradient,
        as Adam's state holds it after step 1}, change {leaf: after
        ``steps``}); the parameters start at 0."""
        fit = self.fit
        params = dict(zip(NAMES, fit.parameters()))
        losses = self.run(1)[0].tolist()
        b1 = fit.opt.param_groups[0]['betas'][0]
        grads = {}
        for k, p in params.items():
            state = fit.opt.state.get(p, {})
            grads[k] = (state['exp_avg'].detach().cpu() / (1.0 - b1)
                        if 'exp_avg' in state else torch.zeros(p.shape))
        losses += self.run(steps - 1)[0].tolist()
        change = {k: p.detach().cpu() - self.start[k]
                  for k, p in params.items()}
        return dict(losses=losses, grads=grads, change=change)

    def free(self):
        self._restore()
        del self.fit, self.steps

    def reference(self, steps=3, dtype=torch.float32):
        """The plain reference's readings over the same first steps."""
        cfg = dict(self.cfg, dist_scale=self.tau)
        return ref.follow(template(self.cfg['num_vertices']), self.goal,
                          self.eyes, self.start, cfg, steps, self.device,
                          dtype)

    def work(self):
        """The step's work from the problem: the render's gated pairs at
        the template's start, transformed by the reference side."""
        cfg = self.cfg
        pairs = start_pairs(cfg, self.tau, self.views, self.device)
        nf = template(cfg['num_vertices'])[1].shape[0]
        w = render_work(pairs, self.eyes.shape[0], nf,
                        cfg['texture_res'] ** 2,
                        cfg['image_size'] * (2 if cfg['anti_aliasing']
                                             else 1))
        w['pairs'] = pairs
        w['step_flops'] = w['fwd_flops'] + w['bwd_flops']
        return w
