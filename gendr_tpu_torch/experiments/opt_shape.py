"""Multi-view silhouette shape optimization.

Port of ``experiments/opt_shape.py``: a sphere template is deformed to
match 24 hard-rendered target silhouettes per view set.  One training step
is model -> lighting -> look_at -> differentiable render (``channels=
'alpha'``) -> IoU/MSE + Laplacian + flatten regularizers -> Adam; after each
step a hard render scores the shape.  The lr x sigma grid search
(opt_shape.py:326-337) re-uses the renderers: the soft renderer renders
with the parameter vector of the experiment's static buffer ``par``, into
which each setting's sigma is written.

``--chain N`` (default 10, as the JAX script's; forced to 1 by ``--gif``)
runs N (train step + hard eval) pairs a block and fetches their hard
losses once a block (``common.StepChain``): on the card one pair captured
as a CUDA graph and replayed N times, captured once per run and reused by
every (lr, sigma) setting, whose parameters and Adam state are reset in
place; with ``--chain 1`` the pair runs eagerly.  On the CPU the block is
a plain loop.

On CUDA tensors the render and its gradient run through the hand-written
kernels (``backend='cuda'``); on CPU tensors through the plain ``torch``
backend.

Usage (from the repo root):
    python -m gendr_tpu_torch.experiments.opt_shape --quick --device cuda
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
from torch import nn

from gendr_tpu_torch import GenDR, Lighting, LookAt, Mesh, data
from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.experiments.common import (GifWriter, StepChain,
                                                chain_capture, iou_loss,
                                                load_or_make_mesh, make_adam,
                                                make_grid, mse_loss,
                                                require_gif_support,
                                                reset_optimizer)
from gendr_tpu_torch.geometry import core
from gendr_tpu_torch.geometry.losses import FlattenLoss, LaplacianLoss
from gendr_tpu_torch.geometry.transforms import get_points_from_angles
from gendr_tpu_torch.utils import profiling

ELEVATION_INDEX = {'-60': 0, '-30': 1, '0': 2, '30': 3, '60': 4}


class ShapeModel(nn.Module):
    """Sigmoid-reparametrized displacement + tanh centroid on a sphere
    template (opt_shape.py:39-68 of the JAX experiment)."""

    def __init__(self, num_vertices=642):
        super().__init__()
        v, f = data.sphere(num_vertices)
        base = torch.as_tensor(v) * 0.5
        self.register_buffer('base_vertices', base)
        self.register_buffer('faces', torch.as_tensor(f))
        # the faces are fixed: the table of their fixed-order sums, once
        core.register_incidence(self, core.incidence(self.faces,
                                                     base.shape[0]))
        self.laplacian = LaplacianLoss(base.numpy(), f)
        self.flatten = FlattenLoss(f)
        self.displace = nn.Parameter(torch.zeros(1, *base.shape))
        self.center = nn.Parameter(torch.zeros(1, 1, 3))

    def reset_parameters(self):
        with torch.no_grad():
            self.displace.zero_()
            self.center.zero_()

    def forward(self, batch_size):
        """-> (vertices [B, nv, 3], faces [B, nf, 3], laplacian, flatten)."""
        vb = self.base_vertices[None]
        base = torch.log(vb.abs() / (1 - vb.abs()))
        centroid = torch.tanh(self.center)
        vertices = torch.sigmoid(base + self.displace) * torch.sign(vb)
        vertices = torch.relu(vertices) * (1 - centroid) \
            - torch.relu(-vertices) * (centroid + 1)
        vertices = vertices + centroid

        lap = self.laplacian(vertices).mean()
        flat = self.flatten(vertices).mean()
        verts = vertices.repeat(batch_size, 1, 1)
        faces = self.faces[None].repeat(batch_size, 1, 1)
        return verts, faces, lap, flat


def build_renderers(args, backend=None):
    """(soft renderer, hard renderer), both silhouette-only."""
    diff_renderer = GenDR(
        image_size=args.image_size,
        dist_func=args.dist_func,
        dist_scale=1.0,  # set per run: the sigma of the grid
        dist_squared=args.squared,
        dist_shape=args.dist_shape,
        dist_shift=args.dist_shift,
        dist_eps=args.dist_eps,
        aggr_alpha_func=args.aggr_func,
        aggr_alpha_t_conorm_p=args.t_conorm_p,
        aggr_rgb_func='hard',
        backend=backend,
        channels='alpha',
    )
    hard_renderer = GenDR(
        image_size=args.image_size,
        dist_func=0, dist_scale=1e-4, dist_squared=True, dist_shape=0.,
        dist_shift=0., dist_eps=1, aggr_alpha_func=0,
        aggr_alpha_t_conorm_p=0., aggr_rgb_func='hard', backend=backend,
        channels='alpha',
    )
    return diff_renderer, hard_renderer


class ShapeExperiment:
    """The model, the camera, the lighting and the two renderers of one
    run, and the steps of opt_shape.py:160-242 (JAX experiment).

    ``par`` is the soft renderer's parameter vector on the device, a static
    buffer: a number given as a step's dist_scale is written into it, and
    a chained block writes its rows.  ``steps`` (the StepChain of one train
    step + hard eval), the optimizer and the view set's ``eyes`` and
    ``targets`` buffers are made by the first run and kept."""

    def __init__(self, args, device, backend=None):
        self.args = args
        self.device = torch.device(device)
        self.model = ShapeModel(args.num_vertices).to(self.device)
        self.lighting = Lighting().to(self.device)
        self.transform = LookAt(viewing_angle=15).to(self.device)
        self.diff_renderer, self.hard_renderer = build_renderers(args,
                                                                 backend)
        self.sil_loss_fn = mse_loss if args.loss == 'mse' else iou_loss
        self.par = to_device(self.diff_renderer.params_vector(),
                             self.device)
        self.opt = self.steps = self.eyes = self.targets = None
        self.images = None

    @torch.no_grad()
    def goal_mesh(self, model_obj, data_dir=None):
        """(cameras [120, 3] numpy, the target mesh seen from each): the
        camera poses of data.camera_grid() (opt_shape.py:143-155)."""
        cameras = data.camera_grid()
        tv, tf = load_or_make_mesh(model_obj, data_dir)
        mesh = Mesh.create(tv, tf, device=self.device).repeat(len(cameras))
        self.transform.set_eyes_from_angles(*(torch.from_numpy(cameras[:, i])
                                              for i in range(3)))
        return cameras, self.transform(self.lighting(mesh))

    @torch.no_grad()
    def goals(self, model_obj, data_dir=None):
        """Hard-render the target mesh from the 120 camera poses: (cameras
        [120, 3] numpy, silhouettes [120, H, W])."""
        cameras, mesh = self.goal_mesh(model_obj, data_dir)
        return cameras, self.hard_renderer(mesh)[:, 3]

    def view_set(self, cameras, images, views):
        """'24@30' -> (eyes [24, 3], targets [24, H, W]) of that
        elevation."""
        _, elev = views.split('@')
        j = ELEVATION_INDEX[elev]
        cams = torch.from_numpy(cameras[j * 24:(j + 1) * 24])
        eyes = get_points_from_angles(cams[:, 0], cams[:, 1], cams[:, 2])
        return eyes.to(self.device), images[j * 24:(j + 1) * 24]

    def model_mesh(self, eyes):
        """(the model's mesh seen from eyes [B, 3], laplacian, flatten)."""
        verts, faces, lap, flat = self.model(eyes.shape[0])
        mesh = self.lighting(Mesh.create(
            verts, faces, incidence=core.module_incidence(self.model)))
        self.transform.set_eyes(eyes)
        return self.transform(mesh), lap, flat

    def set_dist_scale(self, dist_scale):
        """Write the soft renderer's vector at dist_scale into ``par``."""
        self.par.copy_(to_device(self.diff_renderer.params_vector(
            dist_scale=dist_scale), self.device))

    def loss_fn(self, eyes, targets, dist_scale=None):
        """(loss, soft silhouettes); dist_scale None renders with ``par``
        as it is."""
        if dist_scale is not None:
            self.set_dist_scale(dist_scale)
        mesh, lap, flat = self.model_mesh(eyes)
        images = self.diff_renderer(mesh, par=self.par)[:, 3]
        profiling.mark('loss')
        sil = self.sil_loss_fn(images, targets)
        return sil + 0.03 * lap + 0.0003 * flat, images

    def make_optimizer(self, lr):
        # optax.adam(1.0, b1=0.5, b2=0.95) with its updates scaled by lr
        return make_adam(self.model.parameters(), lr, betas=(0.5, 0.95))

    def train_step(self, opt, eyes, targets, dist_scale=None):
        """One Adam step; returns (loss, images, every gradient finite)."""
        profiling.mark('geometry')
        opt.zero_grad(set_to_none=True)
        loss, images = self.loss_fn(eyes, targets, dist_scale)
        profiling.mark('loss.bwd')
        loss.backward()
        profiling.mark('finite')
        finite = torch.stack([torch.isfinite(p.grad).all()
                              for p in self.model.parameters()]).all()
        profiling.mark('adam')
        opt.step()
        return loss.detach(), images.detach(), finite

    @torch.no_grad()
    def hard_eval(self, eyes, targets):
        profiling.mark('eval')
        # one phase: its render's own marks would file it under the step's
        with profiling.recording(None):
            mesh, _, _ = self.model_mesh(eyes)
            return self.sil_loss_fn(self.hard_renderer(mesh)[:, 3], targets)

    def chained_step(self):
        """One train step + hard eval on the view set's buffers, with the
        vector in ``par``: [soft loss, hard loss after the step, every
        gradient finite (1.0)], the JAX train_block's scan body."""
        loss, images, ok = self.train_step(self.opt, self.eyes,
                                           self.targets)
        self.images = images
        hard = self.hard_eval(self.eyes, self.targets)
        return torch.stack([loss, hard, ok.to(loss.dtype)])

    def begin(self, lr, eyes, targets):
        """The template's parameters, a fresh Adam state at lr and the view
        set (eyes, targets) in the buffers the chained step reads: in
        place after the first run, so a captured step stays valid."""
        self.model.reset_parameters()
        if self.opt is None:
            self.opt = self.make_optimizer(lr)
            self.eyes, self.targets = eyes.clone(), targets.clone()
            self.steps = StepChain(
                self.chained_step, {'par': self.par},
                chain_capture(self.device, self.args.chain),
                state=self.model.parameters(), optimizer=self.opt)
        else:
            reset_optimizer(self.opt, lr)
            self.eyes.copy_(eyes)
            self.targets.copy_(targets)

    def run(self, lr, sigma, eyes, targets, num_iterations, writer=None):
        """Train from the template, --chain steps a block (1 with a
        writer): per step the soft loss, the hard loss after
        it and its wall time (its block's, host clock to the block's
        fetch, over the block's steps), and whether every gradient was
        finite."""
        chain = 1 if writer is not None else max(1, self.args.chain)
        self.begin(lr, eyes, targets)
        par = self.diff_renderer.params_vector(dist_scale=sigma)
        losses, hard_losses, step_s = [], [], []
        finite = True
        i = 0
        while i < num_iterations:
            n = min(chain, num_iterations - i)
            t0 = time.perf_counter()
            res = self.steps.run({'par': par.repeat(n, 1)})
            step_s += [(time.perf_counter() - t0) / n] * n
            losses += res[:, 0].tolist()
            hard_losses += res[:, 1].tolist()
            finite &= bool(res[:, 2].all())
            if writer is not None:
                writer.append(make_grid(self.images, self.targets, 4, 6))
            i += n
        return dict(losses=losses, hard_losses=hard_losses, step_s=step_s,
                    grads_finite=finite)

    def execute_setting(self, lr, sigma, eyes, targets, gif_path=None):
        """The grid's score of one (lr, sigma): the best hard loss, or the
        first step below --loss-threshold (opt_shape.py:211-242)."""
        args = self.args
        writer = GifWriter(gif_path) if gif_path else None
        rec = self.run(lr, sigma, eyes, targets, args.num_iterations, writer)
        if writer:
            writer.close()
        if args.criterion == 'loss':
            return min(rec['hard_losses'])
        below = [i for i, h in enumerate(np.minimum.accumulate(
            rec['hard_losses'])) if h < args.loss_threshold]
        return below[0] if below else int(1e10)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--dist-func', type=str, default='logistic')
    parser.add_argument('--aggr-func', type=str, default='probabilistic')
    parser.add_argument('--dist_shape', type=float, default=0.)
    parser.add_argument('--dist_shift', type=float, default=0.)
    parser.add_argument('--t_conorm_p', type=float, default=0.)
    parser.add_argument('-sq', '--squared', action='store_true')
    parser.add_argument('--model_obj', type=str, default='airplane.obj')
    parser.add_argument('-ni', '--num-iterations', type=int, default=100)
    parser.add_argument('-nv', '--num-vertices', type=int, default=642,
                        choices=[642, 1352])
    parser.add_argument('-is', '--image-size', type=int, default=64)
    parser.add_argument('-de', '--dist-eps', type=float, default=100)
    parser.add_argument('-lo', '--loss', type=str, default='iou',
                        choices=['mse', 'iou'])
    parser.add_argument('-lt', '--loss-threshold', type=float, default=.1)
    parser.add_argument('-cr', '--criterion', type=str, default='loss',
                        choices=['loss', 'steps_to_threshold'])
    parser.add_argument('-gif', '--gif', action='store_true')
    parser.add_argument('--chain', type=int, default=10,
                        help='training steps a block, their hard losses '
                        'fetched once a block: on the card one step '
                        'captured as a CUDA graph and replayed; 1 = step '
                        'by step; forced to 1 with --gif, which needs every '
                        'frame')
    parser.add_argument('--backend', type=str, default=None,
                        help="'cuda' (the kernels), 'torch' (plain), or "
                        'the default for the device')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default: the card) or 'cpu'")
    parser.add_argument('--quick', action='store_true',
                        help='tiny grid for smoke testing')
    parser.add_argument('--views', type=str, nargs='+',
                        default=['24@-60', '24@-30', '24@0', '24@30',
                                 '24@60'])
    parser.add_argument('--out-dir', type=str, default='./results')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise SystemExit('opt_shape: --device cuda needs a CUDA device '
                         '(torch.cuda.is_available() is False); pass '
                         '--device cpu to run on the CPU')
    if args.gif:
        require_gif_support('opt_shape')
    os.makedirs(args.out_dir, exist_ok=True)
    data_dir = os.environ.get('GENDR_DATA_DIR')
    exp = ShapeExperiment(args, args.device, args.backend)

    print('Generating goals...')
    cameras, all_images = exp.goals(args.model_obj, data_dir)
    print('done. all_images.shape', tuple(all_images.shape))

    results = {}
    for views in args.views:
        eyes, targets = exp.view_set(cameras, all_images, views)

        # lr x sigma grid search, then refine sigma (opt_shape.py:322-337)
        if args.quick:
            lrs = [10 ** -1.5]
            sigmas = np.logspace(-1, -3, 2)
        else:
            lrs = np.logspace(-1.25, -1.75, 3)
            sigmas = np.logspace(-1, -7, 7)

        best = [None, None, 1e10]
        # warm up: the first render on the card builds the kernels, and
        # with --chain N > 1 the first block captures the step
        exp.run(lrs[0], sigmas[0], eyes, targets, 1)
        t0 = time.time()
        n_runs = 0
        for lr in lrs:
            for sigma in sigmas:
                res = exp.execute_setting(lr, sigma, eyes, targets)
                n_runs += 1
                if res < best[2]:
                    best = [lr, sigma, res]
        if best[0] is None:
            # steps_to_threshold and no setting crossed the threshold
            print({f'{args.criterion}_{views}': 'not reached',
                   'loss_threshold': args.loss_threshold})
            results[views] = best
            continue
        if not args.quick:
            rng = np.logspace(math.log10(best[1]) - 1,
                              math.log10(best[1]) + 1, 21)
            for sigma in rng:
                res = exp.execute_setting(best[0], sigma, eyes, targets)
                n_runs += 1
                if res < best[2]:
                    best = [best[0], sigma, res]
        dt = time.time() - t0
        iters_per_sec = n_runs * args.num_iterations / dt
        print({f'learning_rate_{views}': best[0],
               f'sigma_{views}': best[1],
               f'{args.criterion}_{views}': best[2],
               'iters_per_sec': round(iters_per_sec, 1),
               'device': str(exp.device)})
        results[views] = best

        if args.gif:
            exp.execute_setting(
                best[0], best[1], eyes, targets,
                gif_path=os.path.join(
                    args.out_dir, 'shape_{}_{}.gif'.format(
                        views, os.path.basename(
                            args.model_obj).split('.')[0])))
    return results


if __name__ == '__main__':
    main()
