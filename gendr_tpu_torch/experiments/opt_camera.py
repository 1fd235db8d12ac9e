"""Camera-pose recovery from silhouettes.

Port of ``experiments/opt_camera.py``: a batch of 200 candidate poses
[distance, elevation, azimuth, fov] is optimized to match a hard-rendered
goal silhouette, with tau annealed over np.logspace(-1, -7) across the run
(opt_camera.py:291-293).  The pose batch is pure data parallelism: one
Adam step renders all poses at once.  The soft renderer renders with the
parameter vector of the experiment's static buffer ``par``; the run
derives the whole anneal's vectors on the host up front, and each step
reads its row.

``--chain N`` (default 20, as the JAX script's; forced to 1 by ``--gif``)
runs N steps a block and fetches their losses once a block, where the
stop on a non-finite loss is checked (``common.StepChain``): on the card
one step captured as a CUDA graph per loss and replayed, the poses and the
Adam state reset in place between settings; with ``--chain 1`` the step
runs eagerly.  On the CPU the block is a plain loop.

On CUDA tensors the render and its gradient run through the hand-written
kernels (``backend='cuda'``, alpha only); on CPU tensors through the plain
``torch`` backend.

Usage (from the repo root):
    python -m gendr_tpu_torch.experiments.opt_camera -sq --quick
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gendr_tpu_torch import GenDR, Lighting, Mesh
from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.experiments.common import (GifWriter, StepChain,
                                                chain_capture, iou_loss,
                                                load_or_make_mesh, make_adam,
                                                make_grid,
                                                require_gif_support,
                                                reset_optimizer)
from gendr_tpu_torch.geometry import transforms as T
from gendr_tpu_torch.utils import profiling

SEED = 0
THRESHOLD = 5.0   # degrees: a pose whose angles end inside it has succeeded


def transform_cameras(vertices, poses, additional_poses=None):
    """Apply pose batch [N,4] = (distance, elev, azim, fov) to vertices
    (opt_camera.py:46-65): optional extra rotation by the GT poses, then
    look_at from the candidate eyes and per-pose perspective."""
    if additional_poses is not None:
        extra_eyes = T.get_points_from_angles(
            additional_poses[:, 0], additional_poses[:, 1],
            additional_poses[:, 2])
        vertices = T.look_at(vertices, extra_eyes, only_rotate=True)
    eyes = T.get_points_from_angles(poses[:, 0], poses[:, 1], poses[:, 2])
    vertices = T.look_at(vertices, eyes)
    return T.perspective(vertices, poses[:, 3])


def goal_poses(B, seed=SEED):
    """The ground-truth poses [B, 4] as numpy (opt_camera.py:180-185)."""
    rng = np.random.RandomState(seed + 1)
    poses = np.zeros((B, 4), np.float32)
    poses[:, 0] = 2.5 + rng.rand(B) * 1.5
    poses[:, 1] = rng.randn(B) * 60
    poses[:, 2] = rng.randn(B) * 60
    poses[:, 3] = 20.0
    return poses


def initial_poses(B, a_min, a_max, seed=SEED):
    """The starting poses [B, 4] as numpy: angles a_min..a_max degrees off
    the goal, in a random direction."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((B, 4), np.float32)
    poses[:, 0] = 2.0 + rng.rand(B) * 8.0
    poses[:, 1] = rng.randn(B)
    poses[:, 2] = rng.randn(B)
    ang = np.sqrt(poses[:, 1] ** 2 + poses[:, 2] ** 2)
    initial = a_min + rng.rand(B) * (a_max - a_min)
    poses[:, 1] *= initial / ang
    poses[:, 2] *= initial / ang
    poses[:, 3] = 10.0 + rng.rand(B) * 20.0
    return poses


def build_renderers(args, backend=None):
    """(soft renderer, hard renderer), both silhouette-only."""
    diff_renderer = GenDR(
        image_size=args.image_size, dist_func=args.dist_func,
        dist_scale=1.0, dist_squared=args.squared,
        dist_shape=args.dist_shape, dist_shift=args.dist_shift,
        dist_eps=args.dist_eps, aggr_alpha_func=args.aggr_func,
        aggr_alpha_t_conorm_p=args.t_conorm_p, aggr_rgb_func='hard',
        backend=backend, channels='alpha')
    hard_renderer = GenDR(
        image_size=args.image_size, dist_func=0, dist_scale=1e-4,
        dist_squared=True, dist_shape=0., dist_shift=0., dist_eps=10,
        aggr_alpha_func=0, aggr_alpha_t_conorm_p=0., aggr_rgb_func='hard',
        backend=backend, channels='alpha')
    return diff_renderer, hard_renderer


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class CameraExperiment:
    """The mesh, the lighting, the two renderers, the goal poses and their
    hard-rendered silhouettes of one run, and the steps of
    opt_camera.py:120-248 (JAX experiment).

    ``par`` is the soft renderer's parameter vector on the device, a static
    buffer (a chained block writes its rows); ``poses`` the leaf the steps
    optimize and the optimizer are made by the first run and kept; so are
    the StepChains, one per loss (``chains``)."""

    def __init__(self, args, device, backend=None, data_dir=None):
        self.args = args
        self.device = torch.device(device)
        self.batch_size = args.batch_size
        self.lighting = Lighting().to(self.device)
        self.diff_renderer, self.hard_renderer = build_renderers(args,
                                                                 backend)
        mv, mf = load_or_make_mesh(args.model_obj, data_dir)
        self.base_mesh = Mesh.create(mv, mf, device=self.device) \
            .with_incidence().repeat(self.batch_size)
        self.poses_gt = torch.as_tensor(goal_poses(self.batch_size),
                                        device=self.device)
        with torch.no_grad():
            self.goal = self.render(self.hard_renderer, self.poses_gt)
        self.par = to_device(self.diff_renderer.params_vector(),
                             self.device)
        self.poses = self.opt = self.pred = None
        self.chains = {}

    def render(self, renderer, poses, additional_poses=None, par=None):
        mesh = self.lighting(self.base_mesh)
        verts = transform_cameras(mesh.vertices, poses, additional_poses)
        return renderer(mesh.with_vertices(verts), par=par)

    def loss_fn(self, poses, sigma=None, loss_name='iou'):
        """(loss, rendered batch [B, 4, H, W]) of the candidate poses;
        sigma (a number) is written into ``par`` first, None renders with
        ``par`` as it is."""
        if sigma is not None:
            self.par.copy_(to_device(self.diff_renderer.params_vector(
                dist_scale=sigma), self.device))
        pred = self.render(self.diff_renderer, poses, par=self.par,
                           additional_poses=self.poses_gt)
        profiling.mark('loss')
        if loss_name == 'mse':
            # opt_camera.py:25-26: sum over batch, mean over pixels
            loss = ((pred[:, 3] - self.goal[:, 3]) ** 2).sum(0).mean()
        else:
            loss = iou_loss(pred[:, 3], self.goal[:, 3], reduce='sum')
        return loss, pred

    def make_optimizer(self, poses, lr):
        # optax.adam(1.0, b1=0.5, b2=0.99) with its updates scaled by lr
        return make_adam([poses], lr, betas=(0.5, 0.99))

    def train_step(self, opt, poses, sigma=None, loss_name='iou'):
        """One Adam step on poses (a leaf that requires grad); returns
        (loss, rendered batch)."""
        profiling.mark('geometry')
        opt.zero_grad(set_to_none=True)
        loss, pred = self.loss_fn(poses, sigma, loss_name)
        profiling.mark('loss.bwd')
        loss.backward()
        profiling.mark('adam')
        opt.step()
        return loss.detach(), pred.detach()

    def begin(self, poses0):
        """poses0 [B, 4] (numpy or tensor) in the leaf the steps optimize,
        and a fresh Adam state: in place after the first run."""
        p0 = torch.as_tensor(np.asarray(poses0), dtype=torch.float32)
        if self.poses is None:
            self.poses = p0.to(self.device).clone().requires_grad_(True)
            self.opt = self.make_optimizer(self.poses,
                                           self.args.learning_rate)
        else:
            with torch.no_grad():
                self.poses.copy_(to_device(p0, self.device))
            reset_optimizer(self.opt, self.args.learning_rate)

    def chain(self, loss_name):
        """The StepChain of one step of loss_name on ``poses``, with the
        vector in ``par``: [the step's loss]."""
        if loss_name not in self.chains:
            def step():
                loss, self.pred = self.train_step(self.opt, self.poses,
                                                  None, loss_name)
                return loss[None]
            self.chains[loss_name] = StepChain(
                step, {'par': self.par},
                chain_capture(self.device, self.args.chain),
                state=[self.poses], optimizer=self.opt)
        return self.chains[loss_name]

    def run(self, poses0, loss_name='iou', num_iterations=None, writer=None,
            verbose=False):
        """Anneal from poses0 [B, 4] (numpy or tensor), --chain steps a
        block (1 with a writer): dict(poses [B, 4] numpy,
        losses per step, seconds, iterations done).  Stops after a block
        with a loss that is not finite."""
        n = num_iterations or self.args.num_iterations
        chain = 1 if writer is not None else max(1, self.args.chain)
        self.begin(poses0)
        steps = self.chain(loss_name)
        sigmas = np.logspace(-1, -7, n)
        # every step's vector, derived on the host at once
        pars = self.diff_renderer.params_vector(
            dist_scale=torch.from_numpy(sigmas))
        losses, done = [], 0
        B = self.batch_size
        _sync(self.device)
        t0 = time.perf_counter()
        while done < n:
            nb = min(chain, n - done)
            ls = steps.run({'par': pars[done:done + nb]})[:, 0].tolist()
            losses += ls
            if writer is not None and done % 20 == 0:
                gx, gy = (4, B // 4) if B % 4 == 0 else (1, B)
                writer.append(make_grid(self.pred[:, 3], self.goal[:, 3],
                                        gx, gy))
            for j, lv in enumerate(ls):
                if verbose and (done + j) % 100 == 0:
                    print(f'  iter {done + j}: loss {lv:.4f} '
                          f'sigma {sigmas[done + j]:.2e}')
            done += nb
            if not np.isfinite(ls).all():
                print('Stopping the loop because loss is NaN.')
                break
        _sync(self.device)
        seconds = time.perf_counter() - t0
        return dict(poses=self.poses.detach().cpu().numpy(), losses=losses,
                    seconds=seconds, iterations=done)

    def execute_setting(self, a_min, a_max, loss_name, gif_path=None):
        """The share of poses whose elevation and azimuth end within
        THRESHOLD degrees of the goal (opt_camera.py:163-248); the printed
        line also gives the median of that angle over the poses."""
        writer = GifWriter(gif_path) if gif_path else None
        rec = self.run(initial_poses(self.batch_size, a_min, a_max),
                       loss_name, writer=writer, verbose=True)
        if writer:
            writer.close()
        p = rec['poses']
        success = (p[:, 1] ** 2 + p[:, 2] ** 2) < THRESHOLD ** 2
        angle = np.sqrt(p[:, 1] ** 2 + p[:, 2] ** 2)
        setting = f'a{a_min}-{a_max}-l{loss_name}'
        print({f'{setting}_success_{int(THRESHOLD)}': float(success.mean()),
               'median_angle_error': round(float(np.median(angle)), 4),
               'iters_per_sec': round(rec['iterations'] / rec['seconds'], 2),
               'device': str(self.device)})
        return float(success.mean())


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--dist-func', type=str, default='logistic')
    parser.add_argument('--aggr-func', type=str, default='probabilistic')
    parser.add_argument('--dist_shape', type=float, default=0.)
    parser.add_argument('--dist_shift', type=float, default=0.)
    parser.add_argument('--t_conorm_p', type=float, default=0.)
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--model_obj', type=str, default='teapot.obj')
    parser.add_argument('-lr', '--learning-rate', type=float, default=0.3)
    parser.add_argument('-ni', '--num-iterations', type=int, default=1000)
    parser.add_argument('-is', '--image-size', type=int, default=64)
    parser.add_argument('-bs', '--batch-size', type=int, default=200)
    parser.add_argument('-de', '--dist-eps', type=float, default=100)
    parser.add_argument('-lo', '--losses', type=str, nargs='+',
                        default=['iou'])
    parser.add_argument('-gif', '--gif', action='store_true')
    parser.add_argument('--chain', type=int, default=20,
                        help='training steps a block, their losses fetched '
                        'once a block: on the card one step captured as a '
                        'CUDA graph and replayed; 1 = step by step; forced '
                        'to 1 with --gif, which samples frames every 20 '
                        'steps')
    parser.add_argument('--backend', type=str, default=None,
                        help="'cuda' (the kernels), 'torch' (plain), or "
                        'the default for the device')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default: the card) or 'cpu'")
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--out-dir', type=str, default='./results')
    args = parser.parse_args(argv)
    if args.quick:
        # shrink, but never override an explicitly smaller value
        args.num_iterations = min(args.num_iterations, 50)
        args.batch_size = min(args.batch_size, 16)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise SystemExit('opt_camera: --device cuda needs a CUDA device '
                         '(torch.cuda.is_available() is False); pass '
                         '--device cpu to run on the CPU')
    if args.gif:
        require_gif_support('opt_camera')
    os.makedirs(args.out_dir, exist_ok=True)
    print('Generating goals...')
    exp = CameraExperiment(args, args.device, args.backend,
                           os.environ.get('GENDR_DATA_DIR'))
    print('done.')

    initial_angles = [(15, 35), (35, 55), (55, 75)]
    if args.quick:
        initial_angles = [(15, 35)]

    results = {}
    for a_min, a_max in initial_angles:
        for loss_name in args.losses:
            results[(a_min, a_max, loss_name)] = exp.execute_setting(
                a_min, a_max, loss_name)
            if args.gif:
                exp.execute_setting(
                    a_min, a_max, loss_name,
                    gif_path=os.path.join(
                        args.out_dir, 'opt_camera_a{}-{}-l{}_{}.gif'.format(
                            a_min, a_max, loss_name,
                            os.path.basename(
                                args.model_obj).split('.')[0])))
    return results


if __name__ == '__main__':
    main()
