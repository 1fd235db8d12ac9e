#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA forward kernel from ``gendr_tpu_torch/csrc`` (first use
compiles it into ``gendr_tpu_torch/_build_cache/``), then

1. holds the kernel against its plain PyTorch version on the card, on the
   flagship scene (642-vertex icosphere, 256x256, uniform CDF, tau 1e-2,
   probabilistic alpha, hard RGB, random per-face colours) and on
   alpha-only, the max/hard/einstein alpha families, a 100x100 render
   (ragged edge tiles) and a batch of 4 views;
2. drives the port's main path, Mesh -> Lighting -> LookAt -> GenDR at
   256x256, checks the image against the plain backend and that the
   kernel's launch counter rose;
3. times the forward render through the kernel and through the plain
   ``torch`` backend, and the kernel alone against its plain version.

Every failure raises, and the script then exits non-zero.  It exits
non-zero with no result where there is no CUDA device.  The last line of
its output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

IMG_TOL = 2e-3        # max |image| difference (tools/tpu_selfcheck.py:404-409)
WINNER_AGREE = 0.999  # share of covered pixels whose winner face agrees


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def flagship_scene(device, B=1, seed=0):
    """Face vertices [B, 1280, 9] of the 642-vertex icosphere (x0.9) seen
    from distance 2.732, elevation 30 deg, azimuths 45 + 90*i, perspective
    30 deg, and random per-face colours [B, 1280, 1, 3]."""
    import torch
    from gendr_tpu_torch import data
    from gendr_tpu_torch.geometry import core, transforms as T
    v, f = data.icosphere(3)
    verts = torch.as_tensor(v, device=device)[None].expand(B, -1, -1) * 0.9
    eyes = T.get_points_from_angles(
        torch.full((B,), 2.732), torch.full((B,), 30.0),
        45.0 + 90.0 * torch.arange(B, dtype=torch.float32))
    verts = T.perspective(T.look_at(verts, eyes.to(device)), 30.0)
    faces = torch.as_tensor(f, device=device)[None].expand(B, -1, -1)
    fv = core.face_vertices(verts, faces).reshape(B, -1, 9).contiguous()
    tex = np.random.RandomState(seed).rand(B, fv.shape[1], 1, 3)
    return fv, torch.as_tensor(tex, dtype=torch.float32, device=device)


CASES = [
    # name, RenderConfig keywords, batch, image size
    ('flagship', {}, 1, 256),
    ('alpha', dict(channels='alpha'), 1, 256),
    ('max', dict(aggr_alpha_func='max'), 1, 256),
    ('hard', dict(aggr_alpha_func='hard'), 1, 256),
    ('einstein', dict(aggr_alpha_func='einstein'), 1, 256),
    ('ragged100', {}, 1, 100),
    ('batch4', {}, 4, 256),
]


def flagship_cfg(image_size=256, **kw):
    from gendr_tpu_torch import config as C
    args = dict(image_size=image_size, dist_func='uniform',
                aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
                backend='cuda')
    args.update(kw)
    return C.RenderConfig.create(**args)


def compare_kernel():
    """Phase 1: kernel vs its plain version on each case.  Returns the
    largest image error."""
    import torch
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import cuda_backend as CB
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    worst = 0.0
    for name, kw, B, size in CASES:
        cfg = flagship_cfg(size, **kw)
        fv, tex = flagship_scene('cuda', B)
        aux = CB.prepass(fv, tex, cfg, params)
        args = (aux['tile_counts'], aux['tile_ids'], aux['par'],
                aux['packed'], aux['perm'], cfg)
        got_k = CB.rasterize_fwd(*args)
        got_p = CB.rasterize_fwd_plain(*args)
        torch.cuda.synchronize()
        soft_k, ag_k = CB._finalize_soa(got_k, cfg, params)
        soft_p, ag_p = CB._finalize_soa(got_p, cfg, params)
        img_err = float((soft_k - soft_p).abs().max())
        alpha_err = float((soft_k[:, 3] - soft_p[:, 3]).abs().max())
        line = (f'[kernel vs plain] {name:10s} B={B} {size}x{size}: '
                f'img_err={img_err:.3g} alpha_err={alpha_err:.3g}')
        if cfg.channels != 'alpha':
            ids_k, ids_p = ag_k[:, 1], ag_p[:, 1]
            covered = (ids_k >= 0) | (ids_p >= 0)
            flips = int((covered & (ids_k != ids_p)).sum())
            n_cov = int(covered.sum())
            agree = 1.0 - flips / max(n_cov, 1)
            line += (f' winner_agree={agree:.6f} flips={flips} of '
                     f'{n_cov} covered')
            if agree < WINNER_AGREE:
                raise AssertionError(f'{name}: winner agreement {agree}')
        print(line, flush=True)
        if not img_err < IMG_TOL:
            raise AssertionError(f'{name}: img_err {img_err} >= {IMG_TOL}')
        worst = max(worst, img_err)
    return worst


def main_path():
    """Phase 2: Mesh -> Lighting -> LookAt -> GenDR through the public API
    with the default backend.  Returns the kernel's launches in that
    render."""
    import torch
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    from gendr_tpu_torch.raster import cuda_backend as CB
    v, f = data.icosphere(3)
    mesh = G.Mesh.create(v * 0.9, f, device='cuda')
    look = G.LookAt(viewing_angle=30).to('cuda')
    look.set_eyes_from_angles(2.732, 30.0, 45.0)
    size = 256
    kw = dict(image_size=size, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')

    lit = look(G.Lighting()(mesh))
    CB.LAUNCHES['rasterize_fwd'] = 0
    img = G.GenDR(**kw)(lit)
    torch.cuda.synchronize()
    launches = CB.LAUNCHES['rasterize_fwd']

    ref = G.GenDR(backend='torch', **kw)(lit)
    err = float((img - ref).abs().max())
    alpha = img[0, 3]
    coverage = float((alpha > 0.5).float().mean())
    c = size // 2
    centre = img[0, :3, c, c]
    print(f'[main path] {tuple(img.shape)} launches={launches} '
          f'img_err_vs_torch_backend={err:.3g} coverage={coverage:.4f} '
          f'centre_rgb={[round(float(x), 4) for x in centre]}', flush=True)
    if tuple(img.shape) != (1, 4, size, size):
        raise AssertionError(f'shape {tuple(img.shape)}')
    if not bool(torch.isfinite(img).all()):
        raise AssertionError('non-finite image')
    if not err < IMG_TOL:
        raise AssertionError(f'main path vs torch backend: {err}')
    if not 0.1 < coverage < 0.9:
        raise AssertionError(f'alpha coverage {coverage}')
    if not bool((centre > 0.25).all()):
        raise AssertionError(f'centre pixel not lit: {centre}')

    # the gradient has no kernel yet: it must raise, not fall back
    fv = lit.face_vertices.detach().requires_grad_(True)
    out = G.render(fv, lit.face_textures, **kw)
    try:
        out.sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError('backward did not raise NotImplementedError')
    return launches


def _median_ms(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def timings(smi, reps=50):
    """Phase 3: forward render through the kernel and through the plain
    backend (median of `reps` CUDA-event timings each, after warm-up), and
    the kernel alone against its plain version."""
    from gendr_tpu_torch import config as C, render
    from gendr_tpu_torch.raster import cuda_backend as CB
    fv, tex = flagship_scene('cuda')
    kw = dict(image_size=256, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    t = {}
    for backend in ('cuda', 'torch', 'torch', 'cuda'):
        ms = _median_ms(lambda: render(fv, tex, backend=backend, **kw), reps)
        t.setdefault(backend, []).append(ms)
    cfg = flagship_cfg()
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    aux = CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg)
    kernel_ms = _median_ms(lambda: CB.rasterize_fwd(*args), reps)
    plain_ms = _median_ms(lambda: CB.rasterize_fwd_plain(*args), 5, 1)
    print(f'[timing] {smi}: forward render 256x256 1280 faces, median of '
          f'{reps}: backend=cuda {t["cuda"]} ms, backend=torch '
          f'{t["torch"]} ms (order cuda, torch, torch, cuda)', flush=True)
    print(f'[timing] {smi}: rasterize_fwd kernel {kernel_ms:.4f} ms, its '
          f'plain version {plain_ms:.4f} ms (median of 5)', flush=True)
    return kernel_ms, plain_ms


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test needs an NVIDIA GPU', file=sys.stderr)
        return 1
    # imported only now: a copy of this script without the repo fails here
    from gendr_tpu_torch import _build

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f'[device] {smi} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {kind}', flush=True)

    t0 = time.perf_counter()
    _build.load('rasterize_fwd')
    print(f'[build] rasterize_fwd ready in {time.perf_counter() - t0:.2f} s',
          flush=True)
    for line in _build.BUILD_LOG.get('rasterize_fwd', '').splitlines():
        if 'ptxas' in line:
            print(f'[build] {line.strip()}')

    max_err = compare_kernel()
    launches = main_path()
    if launches < 1:
        raise AssertionError('the main path never launched rasterize_fwd')
    kernel_ms, plain_ms = timings(smi)

    print(json.dumps({'kernels': [{
        'name': 'rasterize_fwd', 'route': 'cuda',
        'source': 'gendr_tpu_torch/csrc/rasterize_fwd.cu',
        'replaces': 'gendr_tpu/raster/pallas_backend.py:254',
        'launches': launches, 'max_abs_err': max_err,
        'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
