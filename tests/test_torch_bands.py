"""Row bands, face shards and the carry algebra of the port against
gendr_tpu on the CPU, in one process.

* ``torch_backend.forward_carry`` and ``backward`` with ``row_band`` and
  ``base_offset`` against ``xla_backend`` with the same arguments, and a
  band bitwise against the same rows of the port's own full render;
* ``empty_carry`` / ``merge_carries``: two face halves merged after the
  background against the whole, and against ``xla_backend.merge_carries``
  on the same carries;
* ``cuda_backend.forward_partial`` and ``backward_from_aux`` with
  ``base_offset``, ``fvalid`` and ``row_band`` on CPU tensors (the plain
  versions of K1e and K2e) against ``torch_backend``'s band path, and
  against ``pallas_backend.forward_partial`` in interpret mode;
* ``pack.tile_chunk_mask`` of a band against gendr_tpu's;
* the banded memory repair: a tiny PAIR_BUDGET leaves the forward bitwise
  equal and the backward within float32 rounding of its regrouped sum;
* the kernels' C entries take the arguments their ctypes bindings pass.

Tolerances are those of tests/test_torch_raster.py (image 1e-4, winner ids
on >= 99.9 % of covered pixels, a 1 % pixel budget for the plain backend
against xla) and tests/test_torch_backward.py (gradients atol 2e-4, rtol
2e-3 with a 2 % budget), which say why.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pack as JP
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster import xla_backend as X
from gendr_tpu_torch import _build
from gendr_tpu_torch import config as C, interop
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_render import params_dict, random_scene
from tests.test_torch_backward import _assert_grads_match
from tests.test_torch_raster import IMG_ATOL, WINNER_AGREE, _assert_match
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 16
J_XFC = jax.jit(X.forward_carry, static_argnums=5,
                static_argnames=('row_band',))
J_XB = jax.jit(X.backward, static_argnums=6, static_argnames=('row_band',))
J_FIN = jax.jit(X.finalize, static_argnums=1)

# hard and softmax RGB, alpha only, a parametric fold
SPECS = {
    'hard': dict(dist_func='uniform', aggr_alpha_func='probabilistic',
                 aggr_rgb_func='hard'),
    'softmax': dict(dist_func='uniform', aggr_alpha_func='probabilistic',
                    aggr_rgb_func='softmax'),
    'alpha': dict(dist_func='logistic', aggr_alpha_func='probabilistic',
                  channels='alpha'),
    'yager': dict(dist_func='logistic', aggr_alpha_func='yager',
                  aggr_rgb_func='hard', p=2.0),
}
# (row0, height): the two halves of the image, and a ragged band
BANDS = [(0, 8), (8, 8), (3, 10)]


def _scene(name, F=40, seed=0):
    rng = np.random.RandomState(seed)
    fv = random_scene(rng, B=2, F=F).reshape(2, F, 9)
    tex = rng.rand(2, F, 1, 3).astype(np.float32)
    kw = {k: v for k, v in SPECS[name].items() if k != 'p'}
    kw = dict(image_size=SIZE, face_chunk=4, **kw)
    jp = params_dict(dist_scale=3e-2,
                     aggr_alpha_t_conorm_p=SPECS[name].get('p', 0.0),
                     background_color=np.array([0.2, 0.1, 0.4]))
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return fv, tex, kw, jp, tp


def _bg(params, B, P, torch_side=True):
    if torch_side:
        return params['background_color'].reshape(1, 1, 3).expand(B, P, 3)
    return jnp.broadcast_to(params['background_color'].reshape(1, 1, 3),
                            (B, P, 3))


def _port_band(fv, tex, kw, tp, band, base_offset=0):
    """torch_backend's band render: (soft, aggrs) of rows band."""
    cfg = C.RenderConfig.create(**kw)
    fvp, texp, fvalid, _, _ = TB._pad_faces(torch.from_numpy(fv),
                                            torch.from_numpy(tex),
                                            cfg.face_chunk)
    P = band[1] * SIZE
    carry = TB.forward_carry(
        fvp, texp, fvalid, TB.background_carry(2, P, _bg(tp, 2, P), cfg, tp),
        cfg, tp, base_offset=base_offset, row_band=band)
    return TB.finalize(carry, cfg)


def _xla_band(fv, tex, kw, jp, band, base_offset=0):
    jcfg = JC.RenderConfig.create(**kw)
    fvp, texp, _, fvalid, _, _ = X._pad_faces(jnp.asarray(fv),
                                              jnp.asarray(tex), None,
                                              jcfg.face_chunk)
    P = band[1] * SIZE
    carry = J_XFC(fvp, texp, None, fvalid,
                  X.background_carry(2, P, _bg(jp, 2, P, False), jcfg, jp),
                  jcfg, jp, base_offset, row_band=band)
    return J_FIN(carry, jcfg)


@pytest.mark.parametrize('band', BANDS, ids=lambda b: f'rows{b[0]}+{b[1]}')
@pytest.mark.parametrize('name', sorted(SPECS))
def test_band_forward_matches_xla_and_the_full_render(name, band):
    fv, tex, kw, jp, tp = _scene(name)
    offset = 7  # the ids of a face shard that starts at global face 7
    got, got_ag = _port_band(fv, tex, kw, tp, band, offset)
    want, want_ag = _xla_band(fv, tex, kw, jp, band, offset)
    hard_ids = kw.get('aggr_rgb_func') == 'hard' \
        and kw.get('channels', 'rgba') == 'rgba'
    _assert_match(got, got_ag, want, want_ag, hard_ids, flip_budget=0.01)
    # bitwise the same rows of the port's own full render
    full, full_ag = TB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                               C.RenderConfig.create(**kw), tp)
    rows = slice(band[0], band[0] + band[1])
    assert torch.equal(got, full[:, :, rows])
    if hard_ids:
        ids = full_ag[:, 1, rows]
        assert torch.equal(got_ag[:, 1], torch.where(ids >= 0, ids + offset,
                                                     ids))


@pytest.mark.parametrize('band', [BANDS[0], BANDS[2]],
                         ids=lambda b: f'rows{b[0]}+{b[1]}')
@pytest.mark.parametrize('name', sorted(SPECS))
def test_band_backward_matches_xla(name, band):
    """Each backend's backward reads its own forward's band; the winner ids
    are global (offset 5), as a face shard's are."""
    fv, tex, kw, jp, tp = _scene(name)
    offset = 5
    g = np.random.RandomState(1).randn(2, 4, band[1], SIZE) \
        .astype(np.float32)
    soft, ag = _port_band(fv, tex, kw, tp, band, offset)
    got = TB.backward(torch.from_numpy(fv), torch.from_numpy(tex), soft, ag,
                      torch.from_numpy(g), C.RenderConfig.create(**kw), tp,
                      offset, band)
    jsoft, jag = _xla_band(fv, tex, kw, jp, band, offset)
    want = J_XB(jnp.asarray(fv), jnp.asarray(tex), None, jsoft, jag,
                jnp.asarray(g), JC.RenderConfig.create(**kw), jp, offset,
                row_band=band)
    _assert_grads_match(got, want)


def _halves(fv, tex, kw, tp, split):
    """The port's carries of faces [:split] and [split:] (each padded to
    its chunk multiple), from empty_carry, the second offset by split."""
    cfg = C.RenderConfig.create(**kw)
    out = []
    for sl, off in ((slice(0, split), 0), (slice(split, None), split)):
        fvp, texp, fvalid, _, _ = TB._pad_faces(
            torch.from_numpy(fv[:, sl]), torch.from_numpy(tex[:, sl]),
            cfg.face_chunk)
        out.append(TB.forward_carry(fvp, texp, fvalid,
                                    TB.empty_carry(2, SIZE * SIZE, cfg), cfg,
                                    tp, base_offset=off))
    return cfg, out


@pytest.mark.parametrize('name', sorted(SPECS))
def test_merged_face_halves_equal_the_whole(name):
    fv, tex, kw, jp, tp = _scene(name, F=16)
    cfg, (a, b) = _halves(fv, tex, kw, tp, 8)
    P = SIZE * SIZE
    merged = TB.merge_carries(TB.merge_carries(
        TB.background_carry(2, P, _bg(tp, 2, P), cfg, tp), a, cfg, tp),
        b, cfg, tp)
    got, got_ag = TB.finalize(merged, cfg)
    want, want_ag = TB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                               cfg, tp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=1e-4)
    if kw.get('aggr_rgb_func') == 'hard' and 'channels' not in kw:
        assert torch.equal(got_ag[:, 1], want_ag[:, 1])
    # gendr_tpu's merge of the same carries
    jcfg = JC.RenderConfig.create(**kw)
    jm = X.background_carry(2, P, _bg(jp, 2, P, False), jcfg, jp)
    for part in (a, b):
        jm = X.merge_carries(jm, tuple(jnp.asarray(t.numpy()) for t in part),
                             jcfg, jp)
    for x, y in zip(merged, jm):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6,
                                   rtol=1e-6)


def _shard_inputs(name, F=21, offset=24, pad=3):
    """A face shard: the scene's faces plus ``pad`` faces a caller padded
    (zero vertices, fvalid False), and the shard's base_offset."""
    fv, tex, kw, jp, tp = _scene(name, F=F)
    fv = np.concatenate([fv, np.zeros((2, pad, 9), np.float32)], 1)
    tex = np.concatenate([tex, np.zeros((2, pad, 1, 3), np.float32)], 1)
    fvalid = np.arange(F + pad) < F
    return fv, tex, fvalid, kw, jp, tp, offset


def _finalize_partial(carry, cfg, params, P):
    merged = TB.merge_carries(
        TB.background_carry(2, P, _bg(params, 2, P), cfg, params), carry,
        cfg, params)
    return TB.finalize(merged, cfg)


@pytest.mark.parametrize('name', sorted(SPECS))
def test_forward_partial_and_backward_plain_match_the_torch_band(name):
    """K1e and K2e's plain versions on a face shard's band: image and
    winner ids against torch_backend's band path (ids are global: input id
    + base_offset), the band's gradient against torch_backend's."""
    fv, tex, fvalid, kw, jp, tp, offset = _shard_inputs(name)
    band = (3, 10)
    cfg = C.RenderConfig.create(**kw)
    tfv, ttex = torch.from_numpy(fv), torch.from_numpy(tex)
    carry, aux = CB.forward_partial(tfv, ttex, cfg, tp, base_offset=offset,
                                    fvalid=torch.from_numpy(fvalid),
                                    row_band=band)
    assert (aux['row0'], aux['height']) == band
    got, got_ag = _finalize_partial(carry, cfg, tp, band[1] * SIZE)
    want, want_ag = _port_band(fv, tex, kw, tp, band, offset)
    hard_ids = CB.render_mode(cfg) == CB.MODE_HARD
    _assert_match(got, got_ag, want, want_ag, hard_ids)

    g = torch.from_numpy(np.random.RandomState(2).randn(
        2, 4, band[1], SIZE).astype(np.float32))
    gk = CB.backward_from_aux(tfv, ttex, aux, got, got_ag, g, cfg, tp,
                              offset, torch.from_numpy(fvalid), band)
    gt = TB.backward(tfv, ttex, want, want_ag, g, cfg, tp, offset, band)
    _assert_grads_match(gk, gt)
    # the caller's padded faces get no gradient
    assert float(gk[0][:, ~torch.from_numpy(fvalid)].abs().max()) == 0.0


@pytest.mark.parametrize('name', ['hard', 'softmax'])
def test_forward_partial_plain_matches_pallas(name):
    """Against gendr_tpu's forward_partial in interpret mode, on a band of
    8 rows (the Pallas tiling takes 16x8 tiles) with base_offset and an
    external fvalid.  Pallas reports winners in its Morton order; its
    aux['perm'] maps them back to input ids."""
    fv, tex, fvalid, kw, jp, tp, offset = _shard_inputs(name)
    band = (8, 8)
    cfg = C.RenderConfig.create(**kw)
    carry, _ = CB.forward_partial(torch.from_numpy(fv), torch.from_numpy(tex),
                                  cfg, tp, base_offset=offset,
                                  fvalid=torch.from_numpy(fvalid),
                                  row_band=band)
    jcfg = JC.RenderConfig.create(backend='pallas', **kw)
    jcarry, jaux = PB.forward_partial(jnp.asarray(fv), jnp.asarray(tex), jcfg,
                                      jp, base_offset=offset,
                                      fvalid=jnp.asarray(fvalid),
                                      row_band=band)
    jcarry = [np.asarray(t) for t in jcarry]
    alpha, smax, ssum, rgb, depth, fidx = (t.numpy() for t in carry)
    np.testing.assert_allclose(alpha, jcarry[0], atol=IMG_ATOL)
    if name == 'softmax':
        np.testing.assert_allclose(smax, jcarry[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ssum, jcarry[2], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rgb, jcarry[3], rtol=1e-4, atol=1e-6)
        return
    perm = np.asarray(jaux['perm'])
    jid = jcarry[5]
    mapped = np.where(jid >= 0, np.take_along_axis(
        perm, np.clip(jid - offset, 0, None), axis=1) + offset, -1)
    covered = (fidx >= 0) | (mapped >= 0)
    assert covered.sum() > 20
    assert (fidx == mapped)[covered].mean() >= WINNER_AGREE
    np.testing.assert_allclose(rgb, jcarry[3], atol=IMG_ATOL)
    np.testing.assert_allclose(depth, jcarry[4], rtol=1e-5)


@pytest.mark.parametrize('tile,band', [(8, (8, 16)), (8, (0, 8)),
                                       (16, (16, 16))],
                         ids=['t8-rows8+16', 't8-rows0+8', 't16-rows16+16'])
def test_band_tile_chunk_mask_matches_jax(tile, band):
    rng = np.random.RandomState(4)
    fv = random_scene(rng, B=2, F=24).reshape(2, 24, 9)
    tex = np.ones((2, 24, 1, 3), np.float32)
    fvalid = np.arange(24) < 21
    cfg = C.RenderConfig.create(image_size=32, face_chunk=8)
    packed = pack.pack_faces(torch.from_numpy(fv), torch.from_numpy(tex),
                             torch.from_numpy(fvalid), cfg, with_tex=False)
    got = pack.tile_chunk_mask(packed, 32, tile, tile, 8, 0.05, band[1],
                               band[0])
    jpacked = JP.pack_faces(jnp.asarray(fv), jnp.asarray(tex),
                            jnp.asarray(fvalid),
                            JC.RenderConfig.create(image_size=32,
                                                   face_chunk=8))
    want = JP.tile_chunk_mask(jpacked, 32, tile, tile, 8, 0.05,
                              height=band[1], row0=band[0])
    assert got.shape == want.shape == (2, (32 // tile) * (band[1] // tile),
                                       3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize('name', ['hard', 'softmax'])
def test_pair_budget_bands(name, monkeypatch):
    """The memory repair: under a budget of one row per step the forward is
    bitwise the one-band forward, the backward the same sum regrouped."""
    fv, tex, kw, jp, tp = _scene(name)
    cfg = C.RenderConfig.create(**kw)
    tfv, ttex = torch.from_numpy(fv), torch.from_numpy(tex)
    assert TB._band_rows(2, SIZE, 4) >= SIZE  # the tests' sizes: one band
    soft, ag = TB.forward(tfv, ttex, cfg, tp)
    g = torch.from_numpy(np.random.RandomState(3).randn(
        2, 4, SIZE, SIZE).astype(np.float32))
    grads = TB.backward(tfv, ttex, soft, ag, g, cfg, tp)
    monkeypatch.setattr(TB, 'PAIR_BUDGET', 1)
    assert TB._band_rows(2, SIZE, 4) == 1
    soft_b, ag_b = TB.forward(tfv, ttex, cfg, tp)
    assert torch.equal(soft_b, soft) and torch.equal(ag_b, ag)
    for a, b in zip(TB.backward(tfv, ttex, soft, ag, g, cfg, tp), grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize('name', ['rasterize_fwd', 'rasterize_bwd'])
def test_c_entry_takes_the_bound_arguments(name):
    """The ctypes binding passes as many arguments as the C entry takes (a
    kernel cannot be built here, so its source is read)."""
    src = (_build.CSRC / f'{name}.cu').read_text()
    m = re.search(r'extern "C" int gendr_' + name + r'\(([^)]*)\)', src)
    params = [p.strip() for p in m.group(1).split(',')]
    argtypes, _ = _build.SIGNATURES[name][f'gendr_{name}']
    assert len(params) == len(argtypes)
    assert ['*' in p for p in params] \
        == [t is ctypes.c_void_p for t in argtypes]
    assert 'int row0' in params and 'int height' in params
