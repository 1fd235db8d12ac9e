"""Single-triangle render sweep over the 10 canonical distributions x tau.

Port of ``animations/triangles_dist.py``: the qualitative "zoo"
regression, anti-aliased renders of one white triangle with the default
softmax RGB and the probabilistic t-conorm across tau = 10^[-5, 2).  Each
frame sets the renderer's ``dist_scale`` and renders eagerly.

    python -m gendr_tpu_torch.animations.triangles_dist --resolution 256 \
        --quick
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import gendr_tpu_torch as G
from gendr_tpu_torch.animations.common import (SIGMOID_FUNCTIONS,
                                               composite_on_background,
                                               require_device, save_png,
                                               triangle_scene)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--out-dir', type=str, default='./results/triangles')
    ap.add_argument('--quick', action='store_true',
                    help='tau in steps of 10^0.5')
    ap.add_argument('--dists', type=int, default=0,
                    help='limit to the first N distributions (0 = all)')
    ap.add_argument('--backend', type=str, default=None,
                    help="'cuda' (the kernels), 'torch' (plain), or the "
                    'default for the device')
    ap.add_argument('--device', type=str, default='cuda')
    return ap.parse_args(argv)


def renderer(args, dist_func, dist_shape):
    return G.GenDR(
        image_size=args.resolution, anti_aliasing=True, dist_func=dist_func,
        dist_shape=dist_shape, dist_shift=0.,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0.,
        backend=args.backend)


def frames(args, fv, tex, dists, log_taus):
    """Yield (dist index, tau index, images [1, 4, res, res]) over the
    (dist_func, dist_shape) configurations x 10^log_taus."""
    for dist_id, (dist_func, dist_shape) in enumerate(dists):
        r = renderer(args, dist_func, dist_shape)
        for tau_idx, log_tau in enumerate(log_taus):
            r.dist_scale = float(10 ** log_tau)
            with torch.no_grad():
                yield dist_id, tau_idx, r.forward_tensors(fv, tex)


def main(argv=None):
    """Run the sweep; returns per frame whether it is finite."""
    args = parse_args(argv)
    require_device('triangles_dist', args.device)
    mesh = triangle_scene(args.device)
    # tau sweep: 10^[-5, 2) step .025 (triangles_dist.py:48-74); --quick
    # coarsens the grid
    log_taus = np.arange(-5, 2, 0.5 if args.quick else 0.025)
    dists = SIGMOID_FUNCTIONS[:args.dists] if args.dists \
        else SIGMOID_FUNCTIONS
    finite = []
    for dist_id, tau_idx, images in frames(
            args, mesh.face_vertices, mesh.face_textures, dists, log_taus):
        finite.append(bool(torch.isfinite(images).all()))
        save_png(os.path.join(
            args.out_dir, f'triangle_dist_{dist_id}_t{tau_idx:03d}.png'),
            composite_on_background(images))
        if tau_idx == len(log_taus) - 1:
            dist_func, dist_shape = dists[dist_id]
            print(f'dist {dist_func} (shape={dist_shape}): '
                  f'{len(log_taus)} frames on {args.device}')
    return finite


if __name__ == '__main__':
    main()
