"""Times the forward and the backward kernel on the shapes the render paths
launch them on, in one checkout of the repository, so that two commits are
compared on one card in one call.

    python3 gendr_tpu_torch/tools/kernel_times.py [--root DIR] [--reps 50]
        [--shapes NAME,NAME,...]

``--root`` names the checkout whose ``chip_smoke.py`` and
``gendr_tpu_torch`` are timed (default: the one holding this script), for
example a ``git archive`` of the parent commit unpacked into a git-ignored
directory.  Each shape goes through that checkout's own
``chip_smoke.time_kernels`` (each kernel's median over ``--reps`` calls by
CUDA events, beside one call of its plain version), which prints its line.
``--shapes`` times the named shapes alone (default: all).  The shapes: the flagship (hard RGB; softmax with one texel), its 128-row
band, its first face half and the four ranks of the sharded path's fp=2 x
sp=2 split; the default GenDR on 4 views at 512x512 (25 texels, vertex
colours); the shape optimizer's soft renderer (24 views at 64x64, yager
p=2 and probabilistic); the reconstruction experiment's render (256
silhouettes at 64x64, alpha only: reconstruction_shape); the camera
experiment at its defaults (path (k): 200 poses of the cube at 64x64,
logistic, alpha only, compacted) at tau 1e-1 and 1e-7; a mesh loaded
from an OBJ file under the default GenDR at 25, 144, 256 and 1024 texels
per face, softmax and hard RGB; and,
forward only, 1536x1536 sweep frames: panda_dist at uniform tau 1e-2 and
gaussian tau 1, panda_tcn probabilistic and yager p=2 at tau 1e-2 and 1,
and panda_dist through GENDR_PANDA_OBJ on that mesh at 256 and 1024
texels per face, softmax and hard RGB.  For each
shape it also prints a SHA-1 of the forward kernel's output bytes, so two
checkouts' outputs compare bitwise (the inputs are made with
``torch.use_deterministic_algorithms``, so every run gets the same ones),
and each kernel's time a launch over many launches back to back, which
leaves out the host's latency per call that the per-call medians hold.
Then prints the card's name and power limit and one JSON object {"ms":
{shape: {kernel: ms, "rasterize_fwd_back_to_back": ms,
"rasterize_bwd_back_to_back": ms}}, "sha1": {shape: hex}}, after the
ptxas report of both kernels' instantiations (registers and spills).
Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile


def parse_args(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', default=os.path.dirname(os.path.dirname(here)))
    p.add_argument('--reps', type=int, default=50)
    p.add_argument('--shapes', default='',
                   help='comma-separated shape names to time (default: '
                        'all)')
    return p.parse_args(argv)


def shapes(cs, obj_file):
    """(name, cfg, params, face vertices, textures, fvalid, row_band, bwd)
    of every shape, from the checkout's chip_smoke module cs."""
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.parallel import sharding as S
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    fv, tex = cs.flagship_scene('cuda')
    cfg = cs.flagship_cfg()
    yield 'flagship', cfg, params, fv, tex, None, None, True
    yield ('flagship softmax', cs.flagship_cfg(aggr_rgb_func='softmax'),
           params, fv, tex, None, None, True)
    yield 'flagship band 128', cfg, params, fv, tex, None, (128, 128), True
    hfv, htex, _, _ = cs.face_halves(cfg, fv, tex)[0]
    yield 'flagship fp half', cfg, params, hfv, htex, None, None, True
    for i in range(2):
        sfv, stex, valid, _ = S._face_shard(fv, tex, cfg, 2, i)
        for j in range(2):
            yield (f'flagship shard fp{i} sp{j}', cfg, params, sfv, stex,
                   valid, (128 * j, 128), True)
    for name, cfg, params, gfv, gtex in cs.gendr_inputs():
        yield name, cfg, params, gfv, gtex, None, None, True
    for name, extra in (('opt yager', cs.YAGER_ARGS),
                        ('opt probabilistic', ())):
        _, cfg, params, ofv, otex = next(iter(cs.training_inputs(
            extra=extra)))
        yield name, cfg, params, ofv, otex, None, None, True
    yield ('recon', *reconstruction_shape(), None, None, True)
    exp, init = cs.camera_experiment(20)
    for tau in cs.CAMERA_DEFAULT_TAUS:
        yield (f'opt_camera B=200 tau {tau:g}',
               *cs.camera_inputs(exp, init, tau), None, None, True)
    del exp
    for res in (5, 12, 16, 32):
        for rgb in ('softmax', 'hard'):
            yield (f'obj gendr {rgb} TS={res * res}',
                   *cs.obj_gendr_inputs(obj_file, res, aggr_rgb_func=rgb),
                   None, None, True)
    for dist_func, tau in (('uniform', 1e-2), ('gaussian', 1.0)):
        yield (f'panda {dist_func} tau {tau:g}',
               *cs.panda_inputs('cuda', 1536, dist_func, tau), None, None,
               False)
    for tau in (1e-2, 1.0):
        for t_conorm, p in (('probabilistic', 0.0), ('yager', 2.0)):
            yield (f'tcn {t_conorm} tau {tau:g}',
                   *cs.tcn_inputs('cuda', 1536, t_conorm, p, tau), None,
                   None, False)
    os.environ['GENDR_PANDA_OBJ'] = obj_file
    try:
        for res in (16, 32):
            for rgb in ('softmax', 'hard'):
                yield (f'obj panda {rgb} TS={res * res}',
                       *cs.panda_inputs('cuda', 1536, 'uniform', 1e-2, res,
                                        aggr_rgb_func=rgb), None, None,
                       False)
    finally:
        del os.environ['GENDR_PANDA_OBJ']


def reconstruction_shape(seed=0):
    """(cfg, params, face vertices, textures) at the shape of the
    reconstruction experiment's render, made with the checkout's public
    API alone (so that a checkout older than the experiment times it
    too): the 642-vertex template at the decoder's initial radius (0.25)
    with a seeded radial jitter of 10 %, seen from 256 of the dataset's
    24 cameras (distance 2.732, elevation 30, azimuth -15 k), LookAt at
    15 degrees, 64x64, uniform tau 10^-1.5, dist_eps 300, probabilistic,
    alpha only: B=256, as [Raa, Rba, Rab, Rbb] of a batch of 64."""
    import numpy as np
    import torch
    from gendr_tpu_torch import GenDR, Lighting, LookAt, Mesh, data
    from gendr_tpu_torch.geometry.transforms import get_points_from_angles
    from gendr_tpu_torch.raster.render import render_config
    rng = np.random.RandomState(seed)
    v, f = data.icosphere(3)
    B = 256
    verts = v[None] * 0.25 * (1 + 0.1 * rng.randn(B, v.shape[0], 1))
    view = rng.randint(0, 24, B).astype(np.float32)
    look = LookAt(viewing_angle=15).to('cuda')
    look.set_eyes(get_points_from_angles(
        torch.full((B,), 2.732), torch.full((B,), 30.0),
        torch.from_numpy(-view * 15)))
    renderer = GenDR(image_size=64, dist_func='uniform',
                     dist_scale=10 ** -1.5, dist_eps=300.,
                     aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
                     channels='alpha')
    with torch.no_grad():
        mesh = look(Lighting().to('cuda')(Mesh.create(
            verts.astype(np.float32), np.repeat(f[None], B, 0),
            device='cuda')))
    cfg, params = render_config(**renderer.render_kwargs())
    fv = mesh.face_vertices
    return (cfg, params, fv.reshape(B, fv.shape[1], 9).contiguous(),
            mesh.face_textures.contiguous())


def back_to_back(fn, ms):
    """ms a call of fn: the median of 5 runs of n calls back to back,
    each run between two CUDA events over n, n about 100 ms over the
    per-call median ms: the card's queue stays full, so the host's latency
    per call, which time_kernels' per-call medians include, does not
    count."""
    import numpy as np
    import torch
    n = min(500, max(5, round(100.0 / ms)))
    runs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return float(np.median(runs))


def kernels_back_to_back(cfg, params, fv, tex, fvalid, row_band, ms, bwd):
    """(SHA-1 of the forward kernel's output bytes, {kernel: ms a launch
    back to back}) on one shape, ms the per-call medians; the backward
    (where bwd) on the pixel columns of 0.5 sum(alpha^2) + 0.1 sum(rgb)
    from the forward's image."""
    import torch
    from gendr_tpu_torch.raster import cuda_backend as CB
    aux = CB.prepass(fv, tex, cfg, params, fvalid, row_band)
    TS = tex.shape[2]
    band = (aux['row0'], aux['height'])
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg, TS, *band)
    out = CB.rasterize_fwd(*args)
    sha = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()
    b2b = {'rasterize_fwd_back_to_back': back_to_back(
        lambda: CB.rasterize_fwd(*args), ms['rasterize_fwd'])}
    if bwd:
        soft, aggrs = CB._finalize_soa(out, cfg, params)
        g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], 1)
        pix = CB.pixel_columns(soft, aggrs, g, cfg)
        bargs = (aux['chunk_counts'], aux['chunk_ids'], aux['par'],
                 aux['packed'], aux['perm'], pix, cfg, TS, *band,
                 CB.sorted_face_count(aux) // cfg.face_chunk)
        b2b['rasterize_bwd_back_to_back'] = back_to_back(
            lambda: CB.rasterize_bwd(*bargs), ms['rasterize_bwd'])
    return sha, b2b


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('kernel_times: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gendr_tpu_torch import _build
    names = ('rasterize_fwd', 'rasterize_bwd')
    _build.build(*names)
    for name in names:
        for line in cs.ptxas_summary(_build.BUILD_LOG[name]):
            print(f'[build] {name}: {line}')
    smi = cs.smi_line()
    times, hashes = {}, {}
    with tempfile.TemporaryDirectory() as obj_dir:
        obj_file = cs.make_obj(obj_dir)
        # the inputs are made with deterministic algorithms, so that every
        # checkout gets the same bytes (before their fixed-order sums, the
        # vertex normals were an index_add_ in atomic order) and outputs
        # compare
        torch.use_deterministic_algorithms(True, warn_only=True)
        wanted = set(filter(None, args.shapes.split(',')))
        inputs = [x for x in shapes(cs, obj_file)
                  if not wanted or x[0] in wanted]
        missing = wanted - {x[0] for x in inputs}
        if missing:
            raise SystemExit(f'kernel_times: no shape named {sorted(missing)}')
        torch.use_deterministic_algorithms(False)
        # about a second of matrix products first, so that the first shape
        # is not timed while the card's clocks ramp up
        a = torch.randn(4096, 4096, device='cuda')
        for _ in range(400):
            a @ a
        torch.cuda.synchronize()
        del a
        for name, cfg, params, fv, tex, fvalid, band, bwd in inputs:
            res = cs.time_kernels(smi, name, cfg, params, fv, tex, args.reps,
                                  bwd=bwd, plain=(1, 0), fvalid=fvalid,
                                  row_band=band)
            times[name] = {k: r['ms'] for k, r in res.items()}
            hashes[name], b2b = kernels_back_to_back(
                cfg, params, fv, tex, fvalid, band, times[name], bwd)
            times[name].update(b2b)
            print(f'[sha1] {name}: rasterize_fwd output {hashes[name]}; a '
                  f'launch back to back: ' + ', '.join(
                      f'{k[:-13]} {v:.4f} ms' for k, v in b2b.items()),
                  flush=True)
            torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({'root': os.path.abspath(args.root), 'ms': times,
                      'sha1': hashes}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
