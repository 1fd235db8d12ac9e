"""Per-tile face compaction (``RenderConfig.compact``) of the port against
``gendr_tpu``'s, on the CPU: the plan (``pack.compact_plan``) exactly, the
slot -> face sum (``pack.scatter_slots``), the compacted render through the
kernels' plain versions against ``backend='pallas'`` in interpret mode,
the overflow tiles' fallback, row bands, and 'auto' against 'off'.  The
scenes are ``tests/test_pallas.py``'s (64x64 and 128x128); every case
asserts that the gate fired: the packed columns run past the sorted
faces."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gendr_tpu import config as JC
from gendr_tpu.raster import pack as JP
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster.render import render as jrender
from gendr_tpu_torch import config as C
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster.render import render
from tests.test_pallas import _compact_scene
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = 2e-3
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3
TAU = 3e-3

# tests/test_pallas.py:763-772: t-conorm, RGB mode, texels per face
CASES = [
    ('probabilistic', 'hard', 1),
    ('probabilistic', 'hard', 36),
    ('max', 'hard', 1),
    ('einstein', 'softmax', 1),
    ('hard', 'hard', 1),
]


def _kw(tcn, rgb, size=64):
    return dict(image_size=size,
                dist_func='hard' if tcn == 'hard' else 'logistic',
                aggr_alpha_func=tcn, aggr_rgb_func=rgb)


def _scene(level=1, ts=1, seed=3):
    fv = np.asarray(_compact_scene(level=level))
    tex = np.random.RandomState(seed).rand(1, fv.shape[1], ts, 3) \
        .astype(np.float32)
    return fv, tex


def _overflow_scene():
    """tests/test_pallas.py:826-835: 384 tiny faces clustered in one corner
    of a 128x128 image, so one tile hits 48 octets (> OCT_CAP)."""
    rng = np.random.RandomState(5)
    F = 384
    centers = (rng.rand(F, 1, 2).astype(np.float32) * 0.15
               + np.array([-0.85, 0.65], np.float32))
    tri = centers + rng.randn(F, 3, 2).astype(np.float32) * 0.01
    z = np.full((F, 3, 1), 3.0, np.float32) \
        + rng.rand(F, 3, 1).astype(np.float32)
    fv = np.concatenate([tri, z], -1).reshape(1, F, 9)
    return fv, np.ones((1, F, 1, 3), np.float32)


def _aux(fv, tex, kw, compact='auto', **extra):
    cfg = C.RenderConfig.create(backend='cuda', compact=compact, **kw)
    params = C.RenderParams(dist_scale=TAU).as_dict()
    return CB.prepass(torch.from_numpy(fv), torch.from_numpy(tex), cfg,
                      params, **extra), cfg, params


def _compacted(aux):
    return ('oct_ids' in aux
            and aux['packed'].shape[2] > CB.sorted_face_count(aux))


def _port(fv, tex, kw, compact='auto', backend='cuda'):
    """(image, grad faces, grad textures) of 0.5 sum(alpha^2) + 0.1
    sum(rgb) through backend='cuda' on the CPU (the plain versions)."""
    v = torch.from_numpy(fv).requires_grad_()
    t = torch.from_numpy(tex).requires_grad_()
    img = render(v, t, backend=backend, dist_scale=TAU, compact=compact,
                 **kw)
    (0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()).backward()
    return img.detach().numpy(), v.grad.numpy(), t.grad.numpy()


def _jax(fv, tex, kw):
    """The same through gendr_tpu's backend='pallas' (interpret mode)."""
    def loss(v, t):
        img = jrender(v, t, backend='pallas', dist_scale=TAU, **kw)
        return 0.5 * jnp.sum(img[:, 3] ** 2) + 0.1 * jnp.sum(img[:, :3]), img
    (_, img), (gv, gt) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(fv),
                                             jnp.asarray(tex))
    return np.asarray(img), np.asarray(gv), np.asarray(gt)


def _share(a, b):
    return float(np.isclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL).mean())


@pytest.mark.parametrize('size,level,overflow', [(64, 1, False),
                                                 (128, 2, False),
                                                 (128, 0, True)])
def test_plan_equals_jax(size, level, overflow):
    """pack.compact_plan against gendr_tpu's on the port's sorted faces:
    the lists and the octet ids exactly, the slot faces, textures and
    validity bitwise; the slab count from both gates."""
    fv, tex = _overflow_scene() if overflow else _scene(level, ts=4)
    kw = _kw('probabilistic', 'hard', size)
    aux, cfg, _ = _aux(fv, tex, kw)
    assert _compacted(aux)
    sfv, stex, svalid, _ = CB._sorted_faces(
        torch.from_numpy(fv), torch.from_numpy(tex), 128)
    B, Fp = sfv.shape[:2]
    T = CB._num_tiles(cfg, size)
    slabs = CB._compact_slabs(cfg, 4, T, Fp)
    jcfg = JC.RenderConfig.create(backend='pallas', **kw)
    assert slabs == PB._compact_slabs(jcfg, 4, T, Fp) >= 1
    margin = aux['par'][PM.P_MARGIN]
    got = pack.compact_plan(sfv, stex, svalid, size, 16, 16, margin,
                            Fp // 128, 128, slabs=slabs)
    want = JP.compact_plan(jnp.asarray(sfv.numpy()), jnp.asarray(stex.numpy()),
                           jnp.asarray(svalid.numpy()), size, 16, 16,
                           jnp.float32(margin.item()), Fp // 128, 128,
                           slabs=slabs)
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.float32:
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), name
        else:
            assert np.array_equal(g, w), name
    for name in ('tile_counts', 'tile_ids', 'chunk_counts', 'chunk_ids',
                 'oct_ids'):
        assert torch.equal(aux[name], got[name]), name
    if overflow:
        assert int(got['tile_counts'].max()) > slabs


def test_scatter_slots_matches_jax():
    fv, tex = _scene(2)
    aux, _, _ = _aux(fv, tex, _kw('probabilistic', 'hard', 128))
    oct_ids = aux['oct_ids']
    noct = CB.sorted_face_count(aux) // pack.OCT
    vals = np.random.RandomState(7).randn(
        1, oct_ids.shape[1] * pack.OCT, 9).astype(np.float32)
    got = pack.scatter_slots(torch.from_numpy(vals), oct_ids, noct).numpy()
    want = np.asarray(JP.scatter_slots(jnp.asarray(vals),
                                       jnp.asarray(oct_ids.numpy()), noct))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(want).max() > 0


@pytest.mark.parametrize('tcn,rgb,ts', CASES)
def test_compacted_render_matches_pallas(tcn, rgb, ts):
    """The compacted render of the port (plain versions) against
    gendr_tpu's compacted Pallas path, and against the port with compact
    'off': the image bitwise (the same survivors, folded in the same
    order), the gradients within the parity gate.  The max t-conorm's
    gradient is held against the port's backend='torch' in place of
    gendr_tpu's, whose CPU forward and backward round its exact-equality
    winner test apart (tests/test_torch_backward.py:21-28)."""
    fv, tex = _scene(ts=ts)
    kw = _kw(tcn, rgb)
    aux, _, _ = _aux(fv, tex, kw)
    assert _compacted(aux)
    jcfg = JC.RenderConfig.create(backend='pallas', **kw)
    jaux = PB._prepass(jnp.asarray(fv), jnp.asarray(tex), jcfg,
                       {k: jnp.asarray(v.numpy()) for k, v in
                        C.RenderParams(dist_scale=TAU).as_dict().items()})
    assert jaux['packed'].shape[2] == aux['packed'].shape[2]
    img, gv, gt = _port(fv, tex, kw)
    wimg, wgv, wgt = _jax(fv, tex, kw)
    assert np.abs(img - wimg).max() < IMG_TOL
    bar = 0.98 if tcn == 'max' else 0.99
    if tcn == 'max':
        _, wgv, wgt = _port(fv, tex, kw, backend='torch')
    assert _share(gv, wgv) > bar
    assert _share(gt, wgt) > bar
    oimg, ogv, ogt = _port(fv, tex, kw, compact='off')
    assert np.array_equal(img.view(np.uint32), oimg.view(np.uint32))
    assert _share(gv, ogv) > 0.99 and _share(gt, ogt) > 0.99


def test_overflow_tiles_fall_back():
    """A tile that hits more octets than its slabs hold keeps its original
    chunk list (tests/test_pallas.py:818-852): the render still matches
    gendr_tpu's Pallas path, and 'off' bitwise."""
    fv, tex = _overflow_scene()
    kw = _kw('probabilistic', 'hard', 128)
    aux, _, _ = _aux(fv, tex, kw)
    assert _compacted(aux) and int(aux['tile_counts'].max()) > 1
    K = CB.sorted_face_count(aux) // 128
    # an overflow tile lists original chunks, and they list it back
    over = aux['tile_ids'][aux['tile_counts'] > 1]
    assert int(over.max()) < K
    assert int(aux['chunk_counts'][:, :K].sum()) > 0
    img, gv, _ = _port(fv, tex, kw)
    wimg, wgv, _ = _jax(fv, tex, kw)
    assert np.abs(img - wimg).max() < IMG_TOL
    assert _share(gv, wgv) > 0.99
    oimg, ogv, _ = _port(fv, tex, kw, compact='off')
    assert np.array_equal(img.view(np.uint32), oimg.view(np.uint32))
    assert _share(gv, ogv) > 0.99


@pytest.mark.parametrize('level', [1, 2])
def test_compacted_bands_bitwise(level):
    """Row bands of a compacted render (all faces, so compaction stays on)
    are bitwise the same rows of the full render: the slab count is the
    full image's, so the slot layout is too (tests/test_pallas.py:855)."""
    fv, tex = _scene(level)
    cfg = C.RenderConfig.create(backend='cuda', **_kw('probabilistic',
                                                      'hard'))
    params = C.RenderParams(dist_scale=TAU).as_dict()
    v, t = torch.from_numpy(fv), torch.from_numpy(tex)
    full, aux = CB.forward_partial(v, t, cfg, params)
    assert _compacted(aux)
    for r0 in (0, 32):
        band, aux_b = CB.forward_partial(v, t, cfg, params,
                                         row_band=(r0, 32))
        assert _compacted(aux_b)
        rows = slice(r0 * 64, (r0 + 32) * 64)
        for got, want in zip(band, full):
            assert torch.equal(got, want[:, rows])


@pytest.mark.parametrize('rgb', ['hard', 'softmax'])
def test_ragged_image_auto_matches_off(rgb):
    """A 40x40 image (ragged edge tiles, which gendr_tpu's TPU tiling has
    no counterpart of): 'auto' compacts and gives 'off''s image bitwise and
    its gradients within the gate."""
    fv, tex = _scene(ts=4)
    kw = dict(_kw('probabilistic', rgb), image_size=40)
    aux, _, _ = _aux(fv, tex, kw)
    assert _compacted(aux)
    img, gv, gt = _port(fv, tex, kw)
    oimg, ogv, ogt = _port(fv, tex, kw, compact='off')
    assert np.array_equal(img.view(np.uint32), oimg.view(np.uint32))
    assert _share(gv, ogv) > 0.99 and _share(gt, ogt) > 0.99


def test_face_shards_and_parametric_folds_stay_uncompacted():
    """The gate: compaction is off for a face shard (fvalid or a base
    offset), for the parametric folds, for compact='off', and for surface
    textures of more than 36 texels; an invalid value raises."""
    fv, tex = _scene()
    kw = _kw('probabilistic', 'hard')
    v, t = torch.from_numpy(fv), torch.from_numpy(tex)
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    params = C.RenderParams(dist_scale=TAU).as_dict()
    assert _compacted(CB.forward_partial(v, t, cfg, params)[1])
    fvalid = torch.ones(fv.shape[1], dtype=torch.bool)
    for extra in (dict(fvalid=fvalid), dict(base_offset=128)):
        _, aux = CB.forward_partial(v, t, cfg, params, **extra)
        assert not _compacted(aux)
    assert not _compacted(_aux(fv, tex, dict(kw, aggr_alpha_func='yager'),
                               )[0])
    assert not _compacted(_aux(fv, tex, kw, compact='off')[0])
    big = np.ones((1, fv.shape[1], 49, 3), np.float32)
    assert not _compacted(_aux(fv, big, kw)[0])
    with pytest.raises(ValueError, match='compact'):
        C.RenderConfig.create(compact='on')
    with pytest.raises(ValueError, match='compact'):
        render(v, t, compact='always')
