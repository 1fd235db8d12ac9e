"""Times the backward kernel on the shapes the render paths launch it on,
in one checkout of the repository, so that two commits are compared on one
card in one call.

    python3 gendr_tpu_torch/tools/bwd_times.py [--root DIR] [--reps 50]

``--root`` names the checkout whose ``chip_smoke.py`` and
``gendr_tpu_torch`` are timed (default: the one holding this script), for
example a ``git archive`` of the parent commit unpacked into a git-ignored
directory.  Each shape goes through that checkout's own
``chip_smoke.time_kernels`` (the forward, then the backward kernel's median
over ``--reps`` calls by CUDA events, each beside one call of its plain
version), which prints its line.  The shapes: the flagship (hard RGB;
softmax with one texel), its 128-row band, its first face half and the four
ranks of the sharded path's fp=2 x sp=2 split; the default GenDR on 4 views
at 512x512 (25 texels, vertex colours); the shape optimizer's soft renderer
(24 views at 64x64, yager p=2 and probabilistic); and a mesh loaded from an
OBJ file under the default GenDR at 25, 144, 256 and 1024 texels per face,
softmax and hard RGB.  Then prints the card's name and power limit and one
JSON object {shape: backward ms}.  Needs the card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def parse_args(argv=None):
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', default=os.path.dirname(os.path.dirname(here)))
    p.add_argument('--reps', type=int, default=50)
    return p.parse_args(argv)


def shapes(cs, obj_file):
    """(name, cfg, params, face vertices, textures, fvalid, row_band) of
    every shape, from the checkout's chip_smoke module cs."""
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.parallel import sharding as S
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    fv, tex = cs.flagship_scene('cuda')
    cfg = cs.flagship_cfg()
    yield 'flagship', cfg, params, fv, tex, None, None
    yield ('flagship softmax', cs.flagship_cfg(aggr_rgb_func='softmax'),
           params, fv, tex, None, None)
    yield 'flagship band 128', cfg, params, fv, tex, None, (128, 128)
    hfv, htex, _, _ = cs.face_halves(cfg, fv, tex)[0]
    yield 'flagship fp half', cfg, params, hfv, htex, None, None
    for i in range(2):
        sfv, stex, valid, _ = S._face_shard(fv, tex, cfg, 2, i)
        for j in range(2):
            yield (f'flagship shard fp{i} sp{j}', cfg, params, sfv, stex,
                   valid, (128 * j, 128))
    for name, cfg, params, gfv, gtex in cs.gendr_inputs():
        yield name, cfg, params, gfv, gtex, None, None
    for name, extra in (('opt yager', cs.YAGER_ARGS),
                        ('opt probabilistic', ())):
        _, cfg, params, ofv, otex = next(iter(cs.training_inputs(
            extra=extra)))
        yield name, cfg, params, ofv, otex, None, None
    for res in (5, 12, 16, 32):
        for rgb in ('softmax', 'hard'):
            yield (f'obj gendr {rgb} TS={res * res}',
                   *cs.obj_gendr_inputs(obj_file, res, aggr_rgb_func=rgb),
                   None, None)


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('bwd_times: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gendr_tpu_torch import _build
    _build.build('rasterize_fwd', 'rasterize_bwd')
    smi = cs.smi_line()
    times = {}
    with tempfile.TemporaryDirectory() as obj_dir:
        obj_file = cs.make_obj(obj_dir)
        for name, cfg, params, fv, tex, fvalid, band in shapes(cs, obj_file):
            res = cs.time_kernels(smi, name, cfg, params, fv, tex, args.reps,
                                  plain=(1, 0), fvalid=fvalid, row_band=band)
            times[name] = res['rasterize_bwd']['ms']
    print(smi)
    print(json.dumps({'root': os.path.abspath(args.root), 'ms': times}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
