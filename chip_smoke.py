#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``gendr_tpu_torch/csrc`` (one nvcc per
source, started together, into ``gendr_tpu_torch/_build_cache/``), then

1. holds each kernel against its plain PyTorch version on the card, on the
   flagship scene (642-vertex icosphere, 256x256, uniform CDF, tau 1e-2,
   probabilistic alpha, hard RGB, random per-face colours) and on
   alpha-only, the max/hard/einstein alpha families, a 100x100 render
   (ragged edge tiles) and a batch of 4 views: the forward image, and the
   gradient of 0.5 sum(alpha^2) + 0.1 sum(rgb), each side through its own
   forward; the backward kernel twice, bitwise equal; and the same on the
   inputs the shape optimizer of phase 3 gives the kernels: its soft
   renderer (logistic sigma 1e-2, probabilistic, alpha) and its hard
   renderer (heaviside, hard alpha, squared distance) on its template from
   24 views at 64x64, and the hard renderer on its 120 goal views;
2. drives the render path, Mesh -> Lighting -> LookAt -> GenDR at 256x256
   and its gradient to the mesh vertices, against the plain backend, and
   checks that both kernels' launch counters rose;
3. drives the training path, the shape optimizer of
   ``gendr_tpu_torch.experiments.opt_shape`` at its default width
   (642-vertex template, 64x64, 24 views, logistic sigma 1e-2,
   probabilistic, lr 10^-1.5, procedural cube target), and checks that the
   hard IoU loss fell, every gradient was finite and both kernels ran;
4. times the kernels against their plain versions, the forward render and
   the forward + backward through both backends, and the median training
   step through both backends.

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
# gradient agreement: share of entries within np.isclose(atol, rtol)
# (tools/tpu_selfcheck.py:407-409)
GRAD_ATOL, GRAD_RTOL, GRAD_AGREE = 5e-4, 5e-3, 0.99
TRAIN_STEPS = 30
TRAIN_LR, TRAIN_SIGMA = 10 ** -1.5, 1e-2


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


def grads_through(cfg, params, fv, tex, kernel, aux=None):
    """(grad_face_vertices, grad_textures) of 0.5 sum(alpha^2) + 0.1
    sum(rgb) (tools/tpu_selfcheck.py:380-382) through the forward and the
    backward kernels (kernel=True) or through their plain versions; each
    side's backward reads its own forward's image."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = aux or CB.prepass(fv, tex, cfg, params)
    fwd = CB.rasterize_fwd if kernel else CB.rasterize_fwd_plain
    bwd = CB.rasterize_bwd if kernel else CB.rasterize_bwd_plain
    out = fwd(aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
              aux['perm'], cfg)
    soft, aggrs = CB._finalize_soa(out, cfg, params)
    # d loss / d soft_colors
    g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], dim=1)
    pix = CB.pixel_columns(soft, aggrs, g, cfg)
    rows = bwd(aux['chunk_counts'], aux['chunk_ids'], aux['par'],
               aux['packed'], aux['perm'], pix, cfg)
    return CB.unpermute_grads(rows, aux['perm'], tex, cfg)


def agreement(got, want):
    """Share of entries with np.isclose(got, want, GRAD_ATOL, GRAD_RTOL)."""
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    return float(np.isclose(got, want, atol=GRAD_ATOL,
                            rtol=GRAD_RTOL).mean())


def check_kernels(name, cfg, params, fv, tex, aux=None):
    """Each kernel against its plain version on one input: the image, the
    winner ids, the gradient of each side through its own forward, and the
    backward kernel twice, bitwise equal.  Prints one line and raises on a
    failed gate; returns (img_err, grad_err)."""
    import torch
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = aux or CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg)
    got_k = CB.rasterize_fwd(*args)
    got_p = CB.rasterize_fwd_plain(*args)
    torch.cuda.synchronize()
    soft_k, ag_k = CB._finalize_soa(got_k, cfg, params)
    soft_p, ag_p = CB._finalize_soa(got_p, cfg, params)
    img_err = float((soft_k - soft_p).abs().max())
    alpha = soft_p[:, 3]
    partial = float(((alpha > 0) & (alpha < 1)).float().mean())
    B, size = fv.shape[0], cfg.image_size
    line = (f'[kernel vs plain] {name:10s} B={B} {size}x{size}: '
            f'img_err={img_err:.3g} '
            f'alpha_err={float((soft_k[:, 3] - alpha).abs().max()):.3g} '
            f'alpha_partial={partial:.4f}')
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

    gk = grads_through(cfg, params, fv, tex, True, aux)
    gk2 = grads_through(cfg, params, fv, tex, True, aux)
    gp = grads_through(cfg, params, fv, tex, False, aux)
    torch.cuda.synchronize()
    grad_agree = agreement(gk[0], gp[0])
    tex_agree = agreement(gk[1], gp[1])
    grad_err = float((gk[0] - gp[0]).abs().max())
    grad_scale = float(gp[0].abs().max())
    bitwise = all(torch.equal(a, b) for a, b in zip(gk, gk2))
    line += (f' | grad_agree={grad_agree:.6f} '
             f'texgrad_agree={tex_agree:.6f} grad_err={grad_err:.3g} '
             f'grad_scale={grad_scale:.3g} bitwise_repeat={bitwise}')
    print(line, flush=True)
    if not img_err < IMG_TOL:
        raise AssertionError(f'{name}: img_err {img_err} >= {IMG_TOL}')
    if not (grad_agree > GRAD_AGREE and tex_agree > GRAD_AGREE):
        raise AssertionError(f'{name}: gradient agreement {grad_agree}, '
                             f'texture {tex_agree}')
    if not bitwise:
        raise AssertionError(f'{name}: two backward runs differ')
    # a step's PDF is 0: the heaviside renderer has no geometry gradient;
    # elsewhere the gradient must lie well above the absolute tolerance,
    # so that agreement is not won by the tolerance alone
    if cfg.dist_func != C.HEAVISIDE and not grad_scale > 100 * GRAD_ATOL:
        raise AssertionError(f'{name}: geometry gradient {grad_scale}')
    return img_err, grad_err


def training_inputs(device='cuda'):
    """The inputs the shape optimizer gives the kernels (phase 3): its soft
    renderer (logistic sigma 1e-2, probabilistic, alpha) and its hard
    renderer (heaviside, hard alpha, squared distance) on the 642-vertex
    template from 24 views at 64x64, the first step's scene; the hard
    renderer on the 120 goal views of the cube.  Yields (name, cfg,
    params, face vertices, textures)."""
    import torch
    from gendr_tpu_torch.raster.render import render_config
    exp, eyes, _ = _shape_experiment(None, device)
    exp.diff_renderer.dist_scale = TRAIN_SIGMA
    with torch.no_grad():
        template, _, _ = exp.model_mesh(eyes)
        _, goal = exp.goal_mesh(exp.args.model_obj)
    for name, renderer, mesh in (('opt soft', exp.diff_renderer, template),
                                 ('opt hard', exp.hard_renderer, template),
                                 ('opt goal', exp.hard_renderer, goal)):
        cfg, params = render_config(**renderer.render_kwargs())
        fv = mesh.face_vertices
        fv = fv.reshape(fv.shape[0], fv.shape[1], 9).contiguous()
        yield name, cfg, params, fv, mesh.face_textures.contiguous()


def compare_kernels():
    """Phase 1: each kernel vs its plain version on each case and on the
    shape optimizer's inputs.  Returns the largest image error and the
    largest gradient error."""
    from gendr_tpu_torch import config as C
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    worst_img = worst_grad = 0.0
    cases = [(name, flagship_cfg(size, **kw), params,
              *flagship_scene('cuda', B)) for name, kw, B, size in CASES]
    for name, cfg, params, fv, tex in [*cases, *training_inputs()]:
        img_err, grad_err = check_kernels(name, cfg, params, fv, tex)
        worst_img = max(worst_img, img_err)
        worst_grad = max(worst_grad, grad_err)
    return worst_img, worst_grad


def render_path():
    """Phase 2: Mesh -> Lighting -> LookAt -> GenDR through the public API
    with the default backend, and the gradient of the render to the mesh
    vertices.  Returns each kernel's launches in that run."""
    import torch
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    from gendr_tpu_torch.raster import cuda_backend as CB
    v, f = data.icosphere(3)
    look = G.LookAt(viewing_angle=30).to('cuda')
    look.set_eyes_from_angles(2.732, 30.0, 45.0)
    size = 256
    kw = dict(image_size=size, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')

    def run(backend):
        verts = torch.tensor(v * 0.9, device='cuda', requires_grad=True)
        mesh = G.Mesh.create(verts, f)
        img = G.GenDR(backend=backend, **kw)(look(G.Lighting()(mesh)))
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        loss.backward()
        return img.detach(), verts.grad

    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    img, grad = run(None)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)

    ref, ref_grad = run('torch')
    err = float((img - ref).abs().max())
    grad_agree = agreement(grad, ref_grad)
    alpha = img[0, 3]
    coverage = float((alpha > 0.5).float().mean())
    c = size // 2
    centre = img[0, :3, c, c]
    print(f'[render path] {tuple(img.shape)} launches={launches} '
          f'img_err_vs_torch_backend={err:.3g} '
          f'vertex_grad_agree_vs_torch_backend={grad_agree:.6f} '
          f'grad_err={float((grad - ref_grad).abs().max()):.3g} '
          f'grad_scale={float(ref_grad.abs().max()):.3g} '
          f'coverage={coverage:.4f} '
          f'centre_rgb={[round(float(x), 4) for x in centre]}', flush=True)
    if tuple(img.shape) != (1, 4, size, size):
        raise AssertionError(f'shape {tuple(img.shape)}')
    if not (bool(torch.isfinite(img).all())
            and bool(torch.isfinite(grad).all())):
        raise AssertionError('non-finite image or gradient')
    if not err < IMG_TOL:
        raise AssertionError(f'render path vs torch backend: {err}')
    if not grad_agree > GRAD_AGREE:
        raise AssertionError(f'vertex gradient vs torch backend: '
                             f'{grad_agree}')
    if not 0.1 < coverage < 0.9:
        raise AssertionError(f'alpha coverage {coverage}')
    if not bool((centre > 0.25).all()):
        raise AssertionError(f'centre pixel not lit: {centre}')
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f'the render path never launched {k}')
    return launches


def _shape_experiment(backend, device='cuda'):
    from gendr_tpu_torch.experiments import opt_shape as OS
    args = OS.parse_args(['--model_obj', 'proc_cube.obj', '--device', device])
    exp = OS.ShapeExperiment(args, device, backend)
    cameras, images = exp.goals(args.model_obj)
    eyes, targets = exp.view_set(cameras, images, '24@30')
    return exp, eyes, targets


def training_path():
    """Phase 3: TRAIN_STEPS steps of the shape optimizer through the
    kernels.  Returns each kernel's launches in that run and the step
    times."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    exp, eyes, targets = _shape_experiment(None)
    for k in CB.LAUNCHES:
        CB.LAUNCHES[k] = 0
    rec = exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    h = rec['hard_losses']
    print(f'[training path] opt_shape, 642-vertex template (1280 faces), '
          f'24 views at 64x64, logistic sigma 1e-2, probabilistic, lr '
          f'10^-1.5, cube target: hard IoU loss {h[0]:.6f} after step 1, '
          f'{h[-1]:.6f} after step {len(h)} (best {min(h):.6f}); '
          f'gradients finite={rec["grads_finite"]}; launches={launches}',
          flush=True)
    if not h[-1] < h[0]:
        raise AssertionError(f'hard IoU loss did not fall: {h}')
    if not rec['grads_finite']:
        raise AssertionError('a non-finite gradient in training')
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f'the training path never launched {k}')
    return launches, rec['step_s']


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


def timings(smi, cuda_steps, reps=50):
    """Phase 4: medians of CUDA-event timings after warm-up."""
    import torch
    from gendr_tpu_torch import config as C, render
    from gendr_tpu_torch.raster import cuda_backend as CB
    fv, tex = flagship_scene('cuda')
    kw = dict(image_size=256, dist_func='uniform', dist_scale=1e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    t = {}
    for backend in ('cuda', 'torch', 'torch', 'cuda'):
        ms = _median_ms(lambda: render(fv, tex, backend=backend, **kw), reps)
        t.setdefault(backend, []).append(ms)
    print(f'[timing] {smi}: forward render 256x256 1280 faces, median of '
          f'{reps}: backend=cuda {t["cuda"]} ms, backend=torch '
          f'{t["torch"]} ms (order cuda, torch, torch, cuda)', flush=True)

    fvg = fv.clone().requires_grad_(True)

    def fwd_bwd(backend):
        img = render(fvg, tex, backend=backend, **kw)
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        return torch.autograd.grad(loss, fvg)

    tb = {}
    for backend in ('cuda', 'torch', 'torch', 'cuda'):
        n = reps if backend == 'cuda' else 10
        ms = _median_ms(lambda: fwd_bwd(backend), n)
        tb.setdefault(backend, []).append(ms)
    print(f'[timing] {smi}: forward+backward 256x256 1280 faces: '
          f'backend=cuda {tb["cuda"]} ms (median of {reps}), backend=torch '
          f'{tb["torch"]} ms (median of 10) (order cuda, torch, torch, '
          f'cuda)', flush=True)

    cfg = flagship_cfg()
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    aux = CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg)
    fwd_ms = _median_ms(lambda: CB.rasterize_fwd(*args), reps)
    fwd_plain_ms = _median_ms(lambda: CB.rasterize_fwd_plain(*args), 5, 1)
    soft, aggrs = CB._finalize_soa(CB.rasterize_fwd(*args), cfg, params)
    g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], dim=1)
    pix = CB.pixel_columns(soft, aggrs, g, cfg)
    bargs = (aux['chunk_counts'], aux['chunk_ids'], aux['par'],
             aux['packed'], aux['perm'], pix, cfg)
    bwd_ms = _median_ms(lambda: CB.rasterize_bwd(*bargs), reps)
    bwd_plain_ms = _median_ms(lambda: CB.rasterize_bwd_plain(*bargs), 5, 1)
    print(f'[timing] {smi}: rasterize_fwd kernel {fwd_ms:.4f} ms, its plain '
          f'version {fwd_plain_ms:.4f} ms; rasterize_bwd kernel '
          f'{bwd_ms:.4f} ms, its plain version {bwd_plain_ms:.4f} ms '
          f'(flagship, medians of {reps} and 5)', flush=True)

    exp, eyes, targets = _shape_experiment('torch')
    torch_steps = exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, 6)['step_s'][1:]
    cuda_med = 1e3 * float(np.median(cuda_steps[1:]))
    torch_med = 1e3 * float(np.median(torch_steps))
    print(f'[timing] {smi}: opt_shape step (forward+backward+Adam, 24 views '
          f'64x64, 1280 faces), host clock, synchronized: backend=cuda '
          f'median {cuda_med:.3f} ms of {len(cuda_steps) - 1}, '
          f'backend=torch median {torch_med:.3f} ms of {len(torch_steps)}',
          flush=True)
    return dict(rasterize_fwd=(fwd_ms, fwd_plain_ms),
                rasterize_bwd=(bwd_ms, bwd_plain_ms))


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
    names = tuple(_build.SIGNATURES)
    _build.build(*names)
    print(f'[build] {", ".join(names)} ready in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for name in names:
        for line in _build.BUILD_LOG.get(name, '').splitlines():
            if 'ptxas' in line:
                print(f'[build] {name}: {line.strip()}')

    img_err, grad_err = compare_kernels()
    render_launches = render_path()
    train_launches, cuda_steps = training_path()
    ms = timings(smi, cuda_steps)

    errs = dict(rasterize_fwd=img_err, rasterize_bwd=grad_err)
    replaces = dict(rasterize_fwd='gendr_tpu/raster/pallas_backend.py:254',
                    rasterize_bwd='gendr_tpu/raster/pallas_backend.py:1171')
    print(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': f'gendr_tpu_torch/csrc/{name}.cu',
        'replaces': replaces[name],
        'launches': train_launches[name],
        'launches_by_path': {'render': render_launches[name],
                             'training': train_launches[name]},
        'max_abs_err': errs[name],
        'ms': ms[name][0], 'plain_ms': ms[name][1]} for name in names]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
