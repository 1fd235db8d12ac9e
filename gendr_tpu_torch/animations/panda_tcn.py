"""Textured-mesh sweep over the 11 t-conorm configurations x tau.

Port of ``animations/panda_tcn.py`` (and, through ``--triangle`` and
``--sweep-p``, of ``triangles_tcn.py``, ``panda_tcn_p.py`` and
``triangles_tcn_p.py``): anti-aliased renders of the textured stand-in with
the default softmax RGB and a uniform distribution, folded by max /
probabilistic / einstein / yager p in {.5, 1, 2, 4} / aczel_alsina p in
{.5, 1, 2, 4} across tau; or, with ``--sweep-p``, by hamacher, yager and
aczel_alsina across p = 2^[-4, 4) at tau = 10^-1.5.  The JAX script re-jits
a closure per configuration; here each frame sets the renderer's
``dist_scale`` or ``aggr_alpha_t_conorm_p`` and renders eagerly (the CUDA
kernels read both from the parameter vector, so no frame rebuilds
anything).  On the card, the default device:

    python -m gendr_tpu_torch.animations.panda_tcn --quick

and at a tiny size on the CPU (``--backend cuda`` there runs the kernels'
plain versions, the default the plain torch backend):

    python -m gendr_tpu_torch.animations.panda_tcn --quick --device cpu \\
        --resolution 16 --out-dir /tmp/tcn
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import gendr_tpu_torch as G
from gendr_tpu_torch.animations import panda_dist
from gendr_tpu_torch.animations.common import (T_CONORMS,
                                               composite_on_background,
                                               require_device, save_png,
                                               triangle_scene)

# the p sweep's families (panda_tcn_p.py:63-67) and its fixed tau
P_SWEEP_T_CONORMS = ['hamacher', 'yager', 'aczel_alsina']
P_SWEEP_TAU = 10 ** -1.5


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--out-dir', type=str, default='./results/tcn')
    ap.add_argument('--quick', action='store_true',
                    help='the first 2 t-conorms x 7 taus, or 8 values of p')
    ap.add_argument('--triangle', action='store_true',
                    help='a single triangle in place of the textured mesh')
    ap.add_argument('--sweep-p', action='store_true',
                    help='sweep the t-conorm parameter p instead of tau '
                    '(p in 2^[-4, 4) at tau = 10^-1.5)')
    ap.add_argument('--backend', type=str, default=None,
                    help="'cuda' (the kernels), 'torch' (plain), or the "
                    'default for the device')
    ap.add_argument('--device', type=str, default='cuda')
    return ap.parse_args(argv)


def scene(args):
    """(face_vertices, face_textures) of the sweep's subject: the lit
    textured stand-in of panda_dist, or with --triangle one white
    triangle."""
    if args.triangle:
        mesh = triangle_scene(args.device)
        return mesh.face_vertices, mesh.face_textures
    return panda_dist.scene(5, args.device)


def renderer(args, t_conorm, p, tau=1e-2):
    return G.GenDR(
        image_size=args.resolution, anti_aliasing=True, dist_func='uniform',
        dist_shape=0., dist_shift=0., dist_scale=tau,
        aggr_alpha_func=t_conorm, aggr_alpha_t_conorm_p=p,
        backend=args.backend)


def tau_frames(args, fv, tex, t_conorms, log_taus):
    """Yield (t_conorm index, tau index, images [1, 4, res, res]) over the
    (t_conorm, p) configurations x 10^log_taus."""
    for tcn_id, (t_conorm, p) in enumerate(t_conorms):
        r = renderer(args, t_conorm, p)
        for tau_idx, log_tau in enumerate(log_taus):
            r.dist_scale = float(10 ** log_tau)
            with torch.no_grad():
                yield tcn_id, tau_idx, r.forward_tensors(fv, tex)


def p_frames(args, fv, tex, t_conorms, log2_ps):
    """Yield (t_conorm index, p index, images) over the families x
    2^log2_ps at tau = P_SWEEP_TAU."""
    for tcn_id, t_conorm in enumerate(t_conorms):
        r = renderer(args, t_conorm, 1.0, P_SWEEP_TAU)
        for p_idx, log2_p in enumerate(log2_ps):
            r.aggr_alpha_t_conorm_p = float(2.0 ** log2_p)
            with torch.no_grad():
                yield tcn_id, p_idx, r.forward_tensors(fv, tex)


def sweep(args):
    """(frames generator, configurations, grid, PNG name) of the command
    line's sweep; --quick keeps the first 2 t-conorms of the tau sweep and
    coarsens either grid to steps of 1."""
    step = 1.0 if args.quick else 0.025
    if args.sweep_p:
        return (p_frames, P_SWEEP_T_CONORMS, np.arange(-4, 4, step),
                lambda cfgs, i, j: f'tcn_p_{cfgs[i]}_{j:03d}.png')
    return (tau_frames, T_CONORMS[:2] if args.quick else T_CONORMS,
            np.arange(-6, 1, step),
            lambda cfgs, i, j: f'tcn_{i}_t{j:03d}.png')


def frame_stats(images):
    """(finite, min alpha, max alpha) of a frame."""
    alpha = images[:, 3]
    return (bool(torch.isfinite(images).all()), float(alpha.min()),
            float(alpha.max()))


def run(args, configs=None):
    """Render the command line's sweep and write its PNGs, over configs
    (t-conorm configurations, or families for --sweep-p) where given
    instead of the command line's own.  Returns per frame (finite, min
    alpha, max alpha)."""
    require_device('panda_tcn', args.device)
    fv, tex = scene(args)
    frames, own_configs, grid, name = sweep(args)
    configs = own_configs if configs is None else configs
    stats = []
    for cfg_id, idx, images in frames(args, fv, tex, configs, grid):
        stats.append(frame_stats(images))
        save_png(os.path.join(args.out_dir, name(configs, cfg_id, idx)),
                 composite_on_background(images))
        if idx == len(grid) - 1:
            print(f'tcn {configs[cfg_id]}: {len(grid)} frames on '
                  f'{args.device}')
    return stats


def main(argv=None):
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
