"""The prepass kernel (``csrc/prepass.cu``) and the rule that sends a
render's prepass to it or to the plain PyTorch prepass.

On the CPU: which shapes take which path (``cuda_backend.prepass_path``),
that CPU tensors run the plain prepass and launch nothing, and that the C
entry and the kernel's constants are the ones the wrapper binds.  On the
card (marked ``cuda``, skipped without one), every output of the kernel
path bitwise the plain prepass's on chip_smoke.py's PREPASS_CASES, a
captured prepass replayed against the eager one, one launch counted a
call, and the plain path where compaction fires or the faces pass the
kernel's sort.  The file imports no jax; from the repo root on a machine
with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prepass.py
"""

import ctypes
import re

import pytest
import torch

from chip_smoke import (PREPASS_CASES, PREPASS_OUTPUTS, check_plain_prepass,
                        check_prepass, check_prepass_replay, flagship_cfg,
                        flagship_scene, prepass_inputs, prepass_mismatch,
                        prepass_scene)
from gendr_tpu_torch import _build, config as C
from gendr_tpu_torch.raster import cuda_backend as CB
from torch_threads import one_torch_thread  # noqa: F401

CAMERA = dict(dist_func='logistic', channels='alpha')
CAP = CB.PREPASS_SORT_CAP

# (what, RenderConfig keywords, faces, texels per face, prepass keywords,
# path on the card)
PATHS = [
    ('camera cells, 64x64', dict(image_size=64, **CAMERA), 1280, 1, {},
     'kernel'),
    ('reconstruction cell, 64x64', dict(image_size=64, channels='alpha'),
     1280, 1, {}, 'kernel'),
    ('flagship: compaction fires', dict(image_size=256), 1280, 1, {},
     'plain'),
    ("flagship, compact='off'", dict(image_size=256, compact='off'), 1280,
     1, {}, 'kernel'),
    ('flagship, a face shard', dict(image_size=256), 1280, 1,
     dict(fvalid=True), 'kernel'),
    ('flagship, compaction not allowed', dict(image_size=256), 1280, 1,
     dict(allow_compact=False), 'kernel'),
    ('a parametric fold keeps the chunk lists',
     dict(image_size=256, aggr_alpha_func='yager'), 1280, 1, {}, 'kernel'),
    ('surface textures past the unrolled cap', dict(image_size=256), 1280,
     256, {}, 'kernel'),
    ('the sort full', dict(image_size=64, **CAMERA), CAP, 1, {}, 'kernel'),
    ('a face past the sort', dict(image_size=64, **CAMERA), CAP + 1, 1, {},
     'plain'),
    ('chunks of one face: shared memory past the limit',
     dict(image_size=64, face_chunk=1, **CAMERA), CAP, 1, {}, 'plain'),
    ('no faces', dict(image_size=64, **CAMERA), 0, 1, {}, 'plain'),
]


@pytest.mark.parametrize('what,cfg_kw,F,TS,kw,path', PATHS,
                         ids=[p[0] for p in PATHS])
def test_prepass_path(what, cfg_kw, F, TS, kw, path):
    cfg = C.RenderConfig.create(**cfg_kw)
    if kw.get('fvalid'):
        kw = dict(kw, fvalid=torch.ones(F, dtype=torch.bool))
    assert CB.prepass_path(cfg, F, TS, 'cuda', **kw) == path
    assert CB.prepass_path(cfg, F, TS, torch.device('cuda', 0), **kw) == path
    # CPU tensors always run the plain prepass
    assert CB.prepass_path(cfg, F, TS, 'cpu', **kw) == 'plain'


def test_the_cells_shapes_take_the_kernel():
    """The benchmark cells' shapes (PREPASS_CASES' first three) and every
    case the card tests hold bitwise go to the kernel."""
    for case in PREPASS_CASES:
        name, cfg, params, fv, tex, kw = prepass_inputs(case, 'cpu')
        assert CB.prepass_path(cfg, fv.shape[1], tex.shape[2], 'cuda',
                               kw.get('fvalid'),
                               kw.get('allow_compact', True)) == 'kernel', \
            name
    assert [c[0] for c in PREPASS_CASES[:3]] == ['camera.blur',
                                                  'camera.sharp',
                                                  'recon.train']


def test_cpu_tensors_run_the_plain_prepass():
    cfg = flagship_cfg(64, **CAMERA)
    fv, tex, kw = prepass_scene('shard', 2, 200, 'cpu')
    params = C.RenderParams().as_dict()
    launches, plain = dict(CB.LAUNCHES), dict(CB.PREPASS_PLAIN)
    got = CB.prepass(fv, tex, cfg, params, **kw)
    assert CB.LAUNCHES == launches
    assert CB.PREPASS_PLAIN == dict(plain, cpu=plain['cpu'] + 1)
    want = CB.prepass_plain(fv, tex, cfg, params, **kw)
    assert CB.PREPASS_PLAIN == dict(plain, cpu=plain['cpu'] + 1)
    assert not prepass_mismatch(got, want)
    assert sorted(got) == sorted(want)
    with pytest.raises(ValueError, match='no prepass kernel'):
        CB.prepass_kernel(fv, tex, cfg, got['par'])


def test_mismatch_reports_bits():
    """prepass_mismatch compares bits: a NaN row equals itself, and
    neither the sign of a zero nor a moved list entry goes unseen."""
    cfg = flagship_cfg(32, **CAMERA)
    fv, tex, _ = prepass_scene('degenerate', 1, 200, 'cpu')
    aux = CB.prepass_plain(fv, tex, cfg, C.RenderParams().as_dict())
    assert bool(torch.isnan(aux['packed']).any())
    assert not torch.equal(aux['packed'], aux['packed'].clone())
    same = {k: aux[k].clone() for k in PREPASS_OUTPUTS}
    assert not prepass_mismatch(aux, same)
    zero = same['packed'] == 0
    assert bool(zero.any())
    signed = dict(same, packed=torch.where(zero, -same['packed'],
                                           same['packed']))
    assert set(prepass_mismatch(aux, signed)) == {'packed'}
    moved = dict(same, tile_ids=same['tile_ids'].flip(-1))
    assert set(prepass_mismatch(aux, moved)) == {'tile_ids'}


def _signature(name, src):
    """The ctypes argtypes and restype of extern "C" function name in a
    source."""
    m = re.search(r'extern "C" ([\w\s\*]+?)\s*\b' + name + r'\(([^)]*)\)',
                  src)
    assert m, name

    def kind(decl):
        decl = decl.strip()
        if decl.startswith('const char*'):
            return ctypes.c_char_p
        return ctypes.c_void_p if '*' in decl else ctypes.c_int
    params = [p for p in m.group(2).split(',') if p.strip()]
    return tuple(kind(p) for p in params), kind(m.group(1))


@pytest.mark.parametrize('fn', sorted(_build.SIGNATURES['prepass']))
def test_c_signature_matches_the_cuda_source(fn):
    src = (_build.CSRC / 'prepass.cu').read_text()
    assert _signature(fn, src) == _build.SIGNATURES['prepass'][fn]


def test_kernel_constants_match_the_wrapper():
    src = (_build.CSRC / 'prepass.cu').read_text()
    assert f'constexpr int SORT_CAP = {CB.PREPASS_SORT_CAP};' in src
    assert f'constexpr size_t SMEM_CAP = {CB.SMEM_LIMIT};' in src
    assert f'constexpr float DET_EPS = {C.DET_EPS:g}f;' in src
    # the shared memory rule, both sides
    assert ('return (size_t)(Fp + Fp % 2) * 8 + (size_t)(Fp / FC) * 16;'
            in src)
    for Fp, FC, want in ((128, 128, 8 * 128 + 16),
                         (1280, 128, 8 * 1280 + 16 * 10),
                         (CAP, 128, 8 * CAP + 16 * 128), (1, 1, 8 * 2 + 16),
                         (3, 1, 8 * 4 + 16 * 3)):
        assert CB._prepass_smem(Fp, FC) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'False)')
    return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('case', PREPASS_CASES,
                         ids=[c[0] for c in PREPASS_CASES])
def test_kernel_is_the_plain_prepass(cuda, case):
    check_prepass(*prepass_inputs(case, cuda))


@pytest.mark.cuda
def test_a_replayed_prepass_is_the_eager_one(cuda):
    name, cfg, params, fv, tex, kw = prepass_inputs(PREPASS_CASES[1], cuda)
    check_prepass_replay(name, cfg, params, fv, tex)


@pytest.mark.cuda
def test_one_launch_a_call(cuda):
    name, cfg, params, fv, tex, kw = prepass_inputs(PREPASS_CASES[3], cuda)
    n, plain = CB.LAUNCHES['prepass'], dict(CB.PREPASS_PLAIN)
    for i in range(3):
        CB.prepass(fv, tex, cfg, params, **kw)
        assert CB.LAUNCHES['prepass'] == n + i + 1
    assert CB.PREPASS_PLAIN == plain


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['compacted', 'past the sort'])
def test_the_plain_path_launches_nothing(cuda, what):
    if what == 'compacted':
        cfg = flagship_cfg()
        fv, tex = flagship_scene(cuda)
    else:
        cfg = flagship_cfg(64, **CAMERA)
        fv, tex, _ = prepass_scene('views', 1, CAP + 1, cuda)
    aux = check_plain_prepass(what, cfg, C.RenderParams().as_dict(), fv, tex)
    assert ('oct_ids' in aux) == (what == 'compacted')
