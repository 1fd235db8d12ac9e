"""The backward kernel's split of each chunk's hit-tile list, on the CPU.

``csrc/rasterize_bwd.cu`` runs one block per (chunk, batch element, slice
of the chunk's list) into a workspace and sums the slices in a fixed
order.  Its partition and its slice count have Python twins in
``cuda_backend`` (``bwd_slices``, ``bwd_slice_count``), tested here: the
slices cover every list position once and in order, and the workspace
stays within its budget.  The split itself is held by running the kernel's
plain version once per slice, on the chunk lists cut to that slice, and
summing in slice order: that equals the plain version over the whole lists
within 1e-5 norm-relative (fp32 reassociation of the pixel sum), across
the envelope, and the softmax case equals ``gendr_tpu``'s gradient
through ``jax.grad`` within tests/test_torch_backward.py's tolerances.
The kernel itself is held against its plain version on the card
(tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gendr_tpu.raster.render import render as jrender
from gendr_tpu_torch import config as C, data
from gendr_tpu_torch.geometry import core, transforms as T
from gendr_tpu_torch.raster import cuda_backend as CB
from tests.test_torch_backward import _assert_grads_match
from tests.test_torch_raster import sphere_scene
from torch_threads import one_torch_thread  # noqa: F401

SPLIT_REL = 1e-5


@pytest.mark.parametrize('S', range(1, 65))
def test_slices_cover_each_list_position_once_in_order(S):
    T_ = 256  # the flagship's tiles
    for n in range(T_ + 1):
        slices = CB.bwd_slices(n, S)
        assert len(slices) == S
        assert [j for a, b in slices for j in range(a, b)] == list(range(n))
        assert all(0 <= a <= b <= n for a, b in slices)
        assert max(b - a for a, b in slices) == -(-n // S)
    # the same partition on the device's integer tensors
    n = torch.arange(T_ + 1, dtype=torch.int32)
    for s, (a, b) in enumerate(CB.bwd_slices(n, S)):
        want = [CB.bwd_slices(int(m), S)[s] for m in n]
        assert [(int(x), int(y)) for x, y in zip(a, b)] == want


@pytest.mark.parametrize('B,NO,Fp,T_,want', [
    (1, 9, 1280, 256, 128),     # the flagship, hard RGB
    (4, 84, 1280, 1024, 128),   # the default GenDR, 25 texels
    (4, 777, 1280, 1024, 16),   # path (e), 256 texels
    (4, 3081, 1280, 1024, 4),   # path (e), 1024 texels
    (24, 6, 1280, 16, 16),      # the shape optimizer at 64x64: T < cap
    (2, 9, 128, 1, 1),          # a 16x16 image: one tile
    (64, 3081, 4096, 1024, 1),  # one slice passes the budget
])
def test_slice_count_keeps_the_workspace_within_budget(B, NO, Fp, T_, want):
    S = CB.bwd_slice_count(B, NO, Fp, T_)
    slot = B * NO * Fp * 4
    assert S == want
    assert 1 <= S <= min(CB.BWD_SLICE_CAP, T_)
    assert S * slot <= CB.BWD_WORKSPACE_BYTES or (S == 1 and slot
                                                  > CB.BWD_WORKSPACE_BYTES)
    # the largest such count
    assert S == min(CB.BWD_SLICE_CAP, T_) \
        or (S + 1) * slot > CB.BWD_WORKSPACE_BYTES


@pytest.mark.parametrize('B,NO,Fp,T_,want', [
    (1, 9, 1280, 256, 4),       # the flagship, hard RGB
    (4, 84, 1280, 1024, 4),     # the default GenDR, 25 texels
    (4, 3081, 1280, 1024, 4),   # 1024 texels: the budget allows 4 too
    (2, 9, 128, 3, 3),          # fewer tiles than the cap
    (64, 3081, 4096, 1024, 1),  # one slice passes the budget
])
def test_slice_count_of_compacted_chunks(B, NO, Fp, T_, want):
    """The sorted chunks of a compacted prepass list only the overflow
    tiles: at most COMPACT_SLICE_CAP slices, within the same budget."""
    S = CB.bwd_slice_count(B, NO, Fp, T_, compacted=True)
    assert S == want
    assert S == min(CB.COMPACT_SLICE_CAP, CB.bwd_slice_count(B, NO, Fp, T_))


@pytest.mark.parametrize('S', [1, 2, 128])
def test_one_slice_writes_the_result_without_a_workspace(S):
    out = torch.zeros((2, 9, 128))
    ws = CB._bwd_workspace(out, S)
    assert (ws is out) == (S == 1)
    assert ws.shape == ((2, 9, 128) if S == 1 else (2, S, 9, 128))
    assert (ws.dtype, ws.device) == (out.dtype, out.device)


def _scene(B, level, size, TS, texture_type, seed=0):
    """icosphere(level) x0.9 from B views at size x size on the CPU, and
    random textures from a numpy seed."""
    v, f = data.icosphere(level)
    verts = torch.as_tensor(v)[None].expand(B, -1, -1) * 0.9
    eyes = T.get_points_from_angles(
        torch.full((B,), 2.732), torch.full((B,), 30.0),
        45.0 + 90.0 * torch.arange(B, dtype=torch.float32))
    verts = T.perspective(T.look_at(verts, eyes), 30.0)
    faces = torch.as_tensor(f)[None].expand(B, -1, -1)
    fv = core.face_vertices(verts, faces).reshape(B, -1, 9).contiguous()
    ts = 3 if texture_type == 'vertex' else TS
    tex = np.random.RandomState(seed).rand(B, fv.shape[1], ts, 3)
    return fv, torch.as_tensor(tex, dtype=torch.float32)


def _slice_lists(counts, ids, S, s):
    """The chunk lists cut to slice s of S: each (b, k) lists its positions
    [s n // S, (s + 1) n // S) first, in order."""
    start, end = CB.bwd_slices(counts.long(), S)[s]
    idx = (torch.arange(ids.shape[2])[None, None] + start[..., None]) \
        % ids.shape[2]
    return (end - start).to(torch.int32), ids.gather(2, idx).contiguous()


def _plain_split(aux, pix, cfg, TS, S):
    """The plain version once per slice, summed in slice order."""
    rows = None
    for s in range(S):
        counts, ids = _slice_lists(aux['chunk_counts'], aux['chunk_ids'], S,
                                   s)
        part = CB.rasterize_bwd_plain(counts, ids, aux['par'], aux['packed'],
                                      aux['perm'], pix, cfg, TS, aux['row0'],
                                      aux['height'])
        rows = part if rows is None else rows + part
    return rows


def _pix(fv, tex, cfg, params, row_band=None):
    """The prepass of a band (None: all rows) and the pixel columns of the
    gradient of 0.5 sum(alpha^2) + 0.1 sum(rgb) over its rows."""
    soft, aggrs, _ = CB.forward_with_aux(fv, tex, cfg, params)
    aux = CB.prepass(fv, tex, cfg, params, row_band=row_band)
    rows = slice(aux['row0'], aux['row0'] + aux['height'])
    soft, aggrs = soft[:, :, rows].contiguous(), aggrs[:, :, rows] \
        .contiguous()
    g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], 1)
    return aux, CB.pixel_columns(soft, aggrs, g, cfg)


# name, RenderConfig keywords, t-conorm p, texels per face, row band
SPLIT_CASES = [
    ('alpha probabilistic', dict(channels='alpha'), 0.0, 1, None),
    ('alpha yager', dict(channels='alpha', aggr_alpha_func='yager'), 2.0, 1,
     None),
    ('hard', {}, 0.0, 1, None),
    ('softmax vertex', dict(aggr_rgb_func='softmax', texture_type='vertex'),
     0.0, 1, None),
    ('softmax ts1', dict(aggr_rgb_func='softmax'), 0.0, 1, None),
    ('softmax ts9', dict(aggr_rgb_func='softmax'), 0.0, 9, None),
    ('softmax ts256', dict(aggr_rgb_func='softmax'), 0.0, 256, None),
    ('hard band', {}, 0.0, 1, (13, 30)),
]


@pytest.mark.parametrize('name,kw,p,ts,band', SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_plain_summed_over_slices_equals_whole_lists(name, kw, p, ts, band):
    kw = dict(dict(image_size=48, dist_func='logistic',
                   aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
                   face_chunk=16, backend="cuda"), **kw)
    cfg = C.RenderConfig.create(**kw)
    params = C.RenderParams(dist_scale=3e-2,
                            aggr_alpha_t_conorm_p=p).as_dict()
    fv, tex = _scene(1, 1, 48, ts, kw.get('texture_type', 'surface'))
    aux, pix = _pix(fv, tex, cfg, params, band)
    whole = CB.rasterize_bwd(aux['chunk_counts'], aux['chunk_ids'],
                             aux['par'], aux['packed'], aux['perm'], pix,
                             cfg, ts, aux['row0'], aux['height'])
    B, NO, Fp = whole.shape
    T_ = aux['chunk_ids'].shape[2]
    S = CB.bwd_slice_count(B, NO, Fp, T_)
    n_max = int(aux['chunk_counts'].max())
    assert S == min(CB.BWD_SLICE_CAP, T_) and n_max > 3
    norm = float(whole.norm())
    assert norm > 0
    # the kernel's slice count (every slice at most one tile here), and
    # three slices of several tiles each
    for split in (S, 3):
        got = _plain_split(aux, pix, cfg, ts, split)
        assert float((got - whole).norm()) <= SPLIT_REL * norm, split


def test_split_softmax_gradient_matches_jax_grad():
    """The softmax gradient of 0.5 sum(alpha^2) + 0.1 sum(rgb) through the
    split backward (the plain version per slice, summed in order) against
    jax.grad of gendr_tpu.render with the xla backend."""
    fv = sphere_scene()
    tex = np.random.RandomState(3).rand(2, fv.shape[1], 1, 3) \
        .astype(np.float32)
    kw = dict(image_size=32, dist_func='logistic',
              aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
              face_chunk=16)

    def jloss(v, t):
        img = jrender(v, t, backend='xla', dist_scale=3e-2, **kw)
        return 0.5 * jnp.sum(img[:, 3] ** 2) + 0.1 * jnp.sum(img[:, :3])

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(fv),
                                                    jnp.asarray(tex))
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    params = C.RenderParams(dist_scale=3e-2).as_dict()
    tfv, ttex = torch.from_numpy(fv), torch.from_numpy(tex)
    aux, pix = _pix(tfv, ttex, cfg, params)
    B, _, Fp = aux['packed'].shape
    S = CB.bwd_slice_count(B, CB._bwd_layout(cfg)[1], Fp,
                           aux['chunk_ids'].shape[2])
    assert int(aux['chunk_counts'].max()) > 1 and S > 1
    rows = _plain_split(aux, pix, cfg, 1, S)
    got = CB.unpermute_grads(rows, aux['perm'], ttex, cfg)
    _assert_grads_match(got, want)
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0
