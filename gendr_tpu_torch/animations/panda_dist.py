"""Textured-mesh render sweep over distributions x tau (softmax RGB).

Port of ``animations/panda_dist.py``: anti-aliased softmax-RGB renders of
the textured stand-in across the canonical distribution zoo with
gamma = 10^-2.5, eps = 10^-3, dist_eps = 10^10, one PNG per frame.  The
JAX script re-jits a closure per tau; here each frame sets the renderer's
``dist_scale`` and renders eagerly.  On the card (the default device) the
render runs through the CUDA kernels:

    python -m gendr_tpu_torch.animations.panda_dist --quick

and at a tiny size on the CPU through their plain versions:

    python -m gendr_tpu_torch.animations.panda_dist --quick --device cpu \\
        --resolution 16 --out-dir /tmp/panda
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import gendr_tpu_torch as G
from gendr_tpu_torch.animations.common import (SIGMOID_FUNCTIONS,
                                               composite_on_background,
                                               require_device, save_png,
                                               textured_scene)

GAMMA, EPS, DIST_EPS = 10 ** -2.5, 10 ** -3, 10 ** 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--resolution', type=int, default=768)
    ap.add_argument('--texture-res', type=int, default=5)
    ap.add_argument('--out-dir', type=str, default='./results/panda')
    ap.add_argument('--quick', action='store_true',
                    help='2 distributions x 7 taus')
    ap.add_argument('--backend', type=str, default=None,
                    help="'cuda' (the kernels), 'torch' (plain), or the "
                    'default for the device')
    ap.add_argument('--device', type=str, default='cuda')
    return ap.parse_args(argv)


def scene(texture_res, device):
    """The lit stand-in seen from distance 3, elevation 20, azimuth 180:
    (face_vertices [1, F, 3, 3], face_textures [1, F, TS, 3])."""
    mesh = textured_scene(texture_res, device)
    transform = G.LookAt().to(device)
    transform.set_eyes_from_angles(3.0, 20.0, 180.0)
    mesh = transform(G.Lighting().to(device)(mesh))
    return mesh.face_vertices, mesh.face_textures


def sweep(args):
    """(log taus, distributions) of the sweep: 7 taus and the first 2
    distributions with --quick, else 280 taus and all 10."""
    log_taus = np.arange(-6, 1, 1.0 if args.quick else 0.025)
    dists = SIGMOID_FUNCTIONS[:2] if args.quick else SIGMOID_FUNCTIONS
    return log_taus, dists


def renderer(args, dist_func, dist_shape):
    return G.GenDR(
        image_size=args.resolution, anti_aliasing=True, dist_func=dist_func,
        dist_shape=dist_shape, dist_shift=0., dist_eps=DIST_EPS,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0.,
        aggr_rgb_func='softmax', aggr_rgb_gamma=GAMMA, aggr_rgb_eps=EPS,
        backend=args.backend)


def frames(args, fv, tex):
    """Yield (dist_id, tau_idx, images [1, 4, res, res]) over the sweep."""
    log_taus, dists = sweep(args)
    for dist_id, (dist_func, dist_shape) in enumerate(dists):
        r = renderer(args, dist_func, dist_shape)
        for tau_idx, log_tau in enumerate(log_taus):
            r.dist_scale = float(10 ** log_tau)
            with torch.no_grad():
                yield dist_id, tau_idx, r.forward_tensors(fv, tex)


def main(argv=None):
    """Run the sweep; returns (ms per frame of each distribution, host
    clock: render, fetch and PNG; per frame (finite, min alpha, max
    alpha))."""
    args = parse_args(argv)
    require_device('panda_dist', args.device)
    fv, tex = scene(args.texture_res, args.device)
    log_taus, dists = sweep(args)
    ms_per_frame, stats = [], []
    t0 = time.perf_counter()
    for dist_id, tau_idx, images in frames(args, fv, tex):
        alpha = images[:, 3]
        stats.append((bool(torch.isfinite(images).all()),
                      float(alpha.min()), float(alpha.max())))
        save_png(os.path.join(args.out_dir,
                              f'panda_dist_{dist_id}_0_t{tau_idx:03d}.png'),
                 composite_on_background(images))
        if tau_idx == 0:
            print(f'  first frame: {time.perf_counter() - t0:.1f}s')
            t0 = time.perf_counter()
        elif tau_idx == len(log_taus) - 1:
            dist_func, dist_shape = dists[dist_id]
            ms = (time.perf_counter() - t0) / (len(log_taus) - 1) * 1e3
            ms_per_frame.append(ms)
            print(f'dist {dist_func} (shape={dist_shape}): {len(log_taus)} '
                  f'frames, {ms:.0f} ms/frame steady-state '
                  f'(render+fetch+png) on {args.device}')
            t0 = time.perf_counter()
    return ms_per_frame, stats


if __name__ == '__main__':
    main()
