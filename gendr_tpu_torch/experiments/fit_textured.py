"""Multi-view fitting of a lit, textured mesh at GenDR's renderer defaults.

The shape optimizer of ``opt_shape`` (its sphere template and sigmoid
displacement, ``ShapeModel``; a view set of 24 cameras at one elevation;
its IoU loss with 0.03 Laplacian and 0.0003 flatten; Adam with betas
(0.5, 0.95) at lr 10^-1.5), fitting colour too: a learnable surface
texture of texture_res^2 texels a face, through a sigmoid, and a mean
squared error of the RGB (weight 1) beside the IoU of the alpha.  One
training step is model -> texture lit by ``Lighting()`` and repeated over
the views -> look_at -> ``GenDR`` at its constructor's defaults (uniform
CDF at tau 1e-2, probabilistic t-conorm, softmax RGB over surface
textures) with 2x anti-aliasing -> loss -> Adam.  The goal is a mesh with
a colour per texel, lit by the same ``Lighting()`` and rendered once by
the same renderer.

``--chain N`` (default 20) runs N training steps a block and fetches their
losses once a block (``common.StepChain``): on the card one step captured
as a CUDA graph and replayed N times; with ``--chain 1`` the step runs
eagerly.  On CUDA tensors the render and its gradient run through the
hand-written kernels (``backend='cuda'``); on CPU tensors through the plain
``torch`` backend.

Usage (from the repo root):
    python -m gendr_tpu_torch.experiments.fit_textured --chain 20
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from gendr_tpu_torch import GenDR, Lighting, LookAt, Mesh, data
from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.experiments.common import (StepChain, chain_capture,
                                                iou_loss, load_or_make_mesh,
                                                make_adam, mse_loss,
                                                reset_optimizer)
from gendr_tpu_torch.experiments.opt_shape import ELEVATION_INDEX, ShapeModel
from gendr_tpu_torch.geometry import core
from gendr_tpu_torch.geometry.transforms import get_points_from_angles
from gendr_tpu_torch.utils import profiling

# opt_shape's camera (LookAt(viewing_angle=15)) and loss weights
VIEWING_ANGLE = 15
LAMBDA_LAPLACIAN, LAMBDA_FLATTEN = 0.03, 0.0003


def pinched_sphere(level=3, scale=(0.8, 0.56, 0.56), pinch=0.5):
    """The default goal: icosphere(level) scaled per axis and pinched in y
    and z near x = 0 (the reconstruction's two-lobe family at fixed
    parameters).  (vertices [nv, 3], faces [nf, 3]) as numpy."""
    v, f = data.icosphere(level)
    v = v.astype(np.float64)
    r = 1.0 - pinch * np.exp(-(v[:, 0] / 0.35) ** 2)
    out = v * np.asarray(scale, np.float64)[None, :]
    out[:, 1] *= r
    out[:, 2] *= r
    return out.astype(np.float32), f


def view_eyes(views):
    """'24@30' -> eyes [24, 3] of data.camera_grid()'s poses at that
    elevation (opt_shape.ShapeExperiment.view_set's cameras)."""
    _, elev = views.split('@')
    j = ELEVATION_INDEX[elev]
    cams = torch.from_numpy(data.camera_grid()[j * 24:(j + 1) * 24])
    return get_points_from_angles(cams[:, 0], cams[:, 1], cams[:, 2])


class TexturedFit:
    """The model (``ShapeModel`` and the texture parameter [1, nf, TS, 3],
    zero at the start: grey through the sigmoid), ``Lighting()``, the
    camera and the renderer of one run, and its training step.

    ``par`` is the renderer's parameter vector on the device, a static
    buffer a chained block writes its rows into.  The optimizer, the
    ``steps`` (the StepChain of one training step) and the ``eyes`` and
    ``targets`` buffers are made by the first ``begin`` and kept."""

    def __init__(self, args, device, backend=None):
        self.args = args
        self.device = torch.device(device)
        self.model = ShapeModel(args.num_vertices).to(self.device)
        nf = self.model.faces.shape[0]
        self.texture = nn.Parameter(torch.zeros(
            1, nf, args.texture_res ** 2, 3, device=self.device))
        self.lighting = Lighting().to(self.device)
        self.transform = LookAt(viewing_angle=VIEWING_ANGLE).to(self.device)
        self.renderer = GenDR(image_size=args.image_size, anti_aliasing=True,
                              backend=backend)
        self.par = to_device(self.renderer.params_vector(), self.device)
        self.opt = self.steps = self.eyes = self.targets = None

    def parameters(self):
        """The leaves the steps optimize: displacement, centre, texture."""
        return [*self.model.parameters(), self.texture]

    @torch.no_grad()
    def goal_images(self, vertices, faces, textures, eyes):
        """The targets [B, 4, S, S]: the mesh (vertices [nv, 3], faces
        [nf, 3], surface textures [nf, TS, 3]) lit and rendered from eyes
        [B, 3] by the renderer of the steps."""
        mesh = self.lighting(Mesh.create(vertices, faces, textures,
                                         device=self.device))
        self.transform.set_eyes(eyes.to(self.device))
        return self.renderer(self.transform(mesh.repeat(eyes.shape[0])),
                             par=self.par)

    def model_mesh(self, eyes):
        """(the model's lit mesh seen from eyes [B, 3], laplacian,
        flatten).  The texture's sigmoid, the lighting and the repeat over
        the views are the step's phase ``shade``; their backward, from the
        lit textures' gradient, phase ``shade.bwd``."""
        verts, faces, lap, flat = self.model(1)
        # the backward of the model's vertices after the lighting's
        verts = profiling.grad_mark(verts, 'geometry.bwd')
        profiling.mark('shade')
        mesh = self.lighting(Mesh.create(
            verts, faces, torch.sigmoid(self.texture),
            incidence=core.module_incidence(self.model)))
        mesh = mesh.with_textures(profiling.grad_mark(
            mesh.textures, 'shade.bwd')).repeat(eyes.shape[0])
        profiling.mark('geometry')
        self.transform.set_eyes(eyes)
        return self.transform(mesh), lap, flat

    def loss_fn(self, eyes, targets):
        """The IoU of the alpha, the mean squared error of the RGB and the
        regularizers."""
        mesh, lap, flat = self.model_mesh(eyes)
        images = self.renderer(mesh, par=self.par)
        profiling.mark('loss')
        return iou_loss(images[:, 3], targets[:, 3]) \
            + mse_loss(images[:, :3], targets[:, :3]) \
            + LAMBDA_LAPLACIAN * lap + LAMBDA_FLATTEN * flat

    def make_optimizer(self):
        # optax.adam(1.0, b1=0.5, b2=0.95) with its updates scaled by lr
        return make_adam(self.parameters(), self.args.learning_rate,
                         betas=(0.5, 0.95))

    def train_step(self, eyes, targets):
        """One Adam step on the view set (eyes [B, 3], targets [B, 4, S,
        S]); returns (loss, every gradient finite)."""
        profiling.mark('geometry')
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_fn(eyes, targets)
        profiling.mark('loss.bwd')
        loss.backward()
        profiling.mark('finite')
        finite = torch.stack([torch.isfinite(p.grad).all()
                              for p in self.parameters()]).all()
        profiling.mark('adam')
        self.opt.step()
        return loss.detach(), finite

    def chained_step(self):
        """One train step on the buffers, with the vector in ``par``:
        [loss, every gradient finite (1.0)]."""
        loss, ok = self.train_step(self.eyes, self.targets)
        return torch.stack([loss, ok.to(loss.dtype)])

    def begin(self, eyes, targets):
        """The template's parameters and the texture zeroed, a fresh Adam
        state, and the view set (eyes, targets) in the buffers the chained
        step reads: in place after the first call, so a captured step stays
        valid."""
        self.model.reset_parameters()
        with torch.no_grad():
            self.texture.zero_()
        if self.opt is None:
            self.opt = self.make_optimizer()
            self.eyes = eyes.to(self.device).clone()
            self.targets = targets.to(self.device).clone()
            self.steps = StepChain(
                self.chained_step, {'par': self.par},
                chain_capture(self.device, self.args.chain),
                state=self.parameters(), optimizer=self.opt)
        else:
            reset_optimizer(self.opt, self.args.learning_rate)
            self.eyes.copy_(eyes)
            self.targets.copy_(targets)

    def run(self, num_iterations):
        """num_iterations steps from the last ``begin``, --chain a block:
        per step the loss, and whether every gradient was finite."""
        row = self.renderer.params_vector()
        losses, finite = [], True
        i = 0
        while i < num_iterations:
            n = min(max(1, self.args.chain), num_iterations - i)
            res = self.steps.run({'par': row.repeat(n, 1)})
            losses += res[:, 0].tolist()
            finite &= bool(res[:, 1].all())
            i += n
        return dict(losses=losses, grads_finite=finite)


def goal_textures(num_faces, texture_res, seed):
    """Per-texel colours [nf, texture_res^2, 3] in [0, 1) from the seed."""
    rng = np.random.RandomState(seed % 2 ** 32)
    return rng.rand(num_faces, texture_res ** 2, 3).astype(np.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--model_obj', type=str, default=None,
                        help='the goal mesh (an OBJ file); default: a '
                        '1280-face icosphere pinched in its middle')
    parser.add_argument('--texture-res', type=int, default=5,
                        help='texels a face: texture_res^2, the learnable '
                        'texture\'s and the goal\'s')
    parser.add_argument('-ni', '--num-iterations', type=int, default=1000)
    parser.add_argument('-nv', '--num-vertices', type=int, default=642,
                        choices=[162, 642, 1352, 2562],
                        help='the template sphere (opt_shape offers 642 '
                        'and 1352)')
    parser.add_argument('-is', '--image-size', type=int, default=256,
                        help='output size; the renderer renders at twice '
                        'it and pools (anti-aliasing)')
    parser.add_argument('-lr', '--learning-rate', type=float,
                        default=10 ** -1.5)
    parser.add_argument('--views', type=str, default='24@30',
                        help="the view set: 24 cameras at one elevation "
                        "(-60, -30, 0, 30 or 60), e.g. '24@30'")
    parser.add_argument('--seed', type=int, default=0,
                        help="the goal's texel colours")
    parser.add_argument('--chain', type=int, default=20,
                        help='training steps a block, their losses fetched '
                        'once a block: on the card one step captured as a '
                        'CUDA graph and replayed; 1 = step by step')
    parser.add_argument('--backend', type=str, default=None,
                        help="'cuda' (the kernels), 'torch' (plain), or "
                        'the default for the device')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (the default: the card) or 'cpu'")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise SystemExit('fit_textured: --device cuda needs a CUDA device '
                         '(torch.cuda.is_available() is False); pass '
                         '--device cpu to run on the CPU')
    fit = TexturedFit(args, args.device, args.backend)
    if args.model_obj is None:
        v, f = pinched_sphere()
    else:
        v, f = load_or_make_mesh(args.model_obj)
    tex = goal_textures(f.shape[0], args.texture_res, args.seed)
    eyes = view_eyes(args.views)
    targets = fit.goal_images(v, f, tex, eyes)
    print('goal:', tuple(targets.shape), 'from', f.shape[0], 'faces')
    fit.begin(eyes, targets)
    # warm up: the first render on the card builds the kernels, and with
    # --chain N > 1 the first block captures the step
    fit.run(1)
    fit.begin(eyes, targets)
    t0 = time.time()
    rec = fit.run(args.num_iterations)
    dt = time.time() - t0
    every = max(1, args.num_iterations // 10)
    for i in range(0, args.num_iterations, every):
        print(f'step {i}: loss {rec["losses"][i]:.6f}')
    res = {'first_loss': rec['losses'][0], 'final_loss': rec['losses'][-1],
           'grads_finite': rec['grads_finite'],
           'iters_per_sec': round(args.num_iterations / dt, 1),
           'device': str(fit.device)}
    print(res)
    return res


if __name__ == '__main__':
    main()
