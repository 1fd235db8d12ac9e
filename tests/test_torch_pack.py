"""The prepass and the per-pair math against gendr_tpu on random scenes,
thin slivers and degenerate faces included."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pack as JP
from gendr_tpu.raster import pairmath as JPM
from gendr_tpu_torch import config as C, interop
from gendr_tpu_torch.raster import pack, pairmath as PM
from tests.test_render import random_scene, params_dict
from torch_threads import one_torch_thread  # noqa: F401


def sliver_scene(seed=0, B=2, F=24):
    """Random triangles plus the faces that break naive fp32 algebra: a
    sliver (two vertices 1e-7 apart, the third collinear to fp32 noise), a
    needle, a point-degenerate face and a segment-degenerate one."""
    rng = np.random.RandomState(seed)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    fv[:, 0] = [0.10, 0.10, 2.0, 0.10 + 1e-7, 0.10 + 1e-7, 2.0,
                0.30, 0.30 + 1e-7, 2.0]
    fv[:, 1] = [-0.5, -0.2, 2.5, 0.4, -0.2 + 1e-4, 2.4, 0.41, -0.2, 2.6]
    fv[:, 2] = [0.2, 0.2, 2.0] * 3
    fv[:, 3] = [-0.3, 0.1, 2.0, 0.0, 0.1, 2.0, 0.3, 0.1, 2.0]
    return fv.astype(np.float32)


def small_faces_scene(seed, B=2, F=32):
    """Small triangles spread over the image, sorted by x so that a chunk
    of consecutive faces is a vertical band that hits only some tiles."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(-0.9, 0.9, (B, F, 1, 2))
    centre[..., 0] = np.sort(centre[..., 0], axis=1)
    xy = centre + rng.uniform(-0.08, 0.08, (B, F, 3, 2))
    z = 2.0 + rng.rand(B, F, 3, 1)
    return np.concatenate([xy, z], -1).reshape(B, F, 9).astype(np.float32)


def _cfg(**kw):
    args = dict(image_size=32, dist_func='logistic',
                aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    args.update(kw)
    return JC.RenderConfig.create(**args), C.RenderConfig.create(**args)


def _params(**kw):
    jp = params_dict(**kw)
    return jp, interop.params_from_jax({k: np.asarray(v)
                                        for k, v in jp.items()})


@pytest.mark.parametrize('texture_type,TS,with_tex', [
    ('surface', 1, True), ('surface', 4, True), ('vertex', 3, True),
    ('surface', 1, False), ('surface', 49, True), ('surface', 256, True)])
def test_pack_faces_matches_jax(texture_type, TS, with_tex):
    fv = sliver_scene()
    B, F = fv.shape[:2]
    rng = np.random.RandomState(1)
    tex = rng.rand(B, F, TS, 3).astype(np.float32)
    fvalid = np.arange(F) < F - 2
    jcfg, cfg = _cfg(texture_type=texture_type)
    want = np.asarray(JP.pack_faces(jnp.asarray(fv), jnp.asarray(tex),
                                    jnp.asarray(fvalid), jcfg, with_tex))
    got = pack.pack_faces(torch.from_numpy(fv), torch.from_numpy(tex),
                          torch.from_numpy(fvalid), cfg, with_tex).numpy()
    assert got.shape == want.shape == (B, pack.num_rows(
        cfg.texture_type, TS, with_tex), F)
    # same fp32 operation sequence on the CPU: equal to the last bit up to
    # rounding of the sliver rows' huge inverse entries
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    assert (got[:, pack.R_FVALID, 2] == 0).all()  # point face masked
    if with_tex and texture_type == 'surface':
        # texel t, channel c at row R_TEX + 3 t + c; above 36 texels the
        # rows are padded with zeros to a multiple of 8 texels
        np.testing.assert_array_equal(
            got[:, pack.R_TEX:pack.R_TEX + 3 * TS],
            tex.reshape(B, F, 3 * TS).transpose(0, 2, 1))
        assert (got[:, pack.R_TEX + 3 * TS:] == 0).all()
        if TS == 49:
            assert got.shape[1] == 48 + 3 * 56


@pytest.mark.parametrize('fid', range(18))
def test_cull_margin_matches_jax(fid):
    for squared in (False, True):
        jcfg, cfg = _cfg(dist_func=fid, dist_squared=squared)
        jp, tp = _params(dist_scale=3e-2, dist_shift=-0.1, dist_eps=50.0)
        want = float(np.asarray(JP.cull_margin(jcfg, jp)))
        got = float(pack.cull_margin(cfg, tp))
        assert got == want, (fid, squared)


def test_params_vec_matches_jax():
    jcfg, cfg = _cfg(dist_func='gamma')
    jp, tp = _params(dist_scale=3e-2, dist_shape=2.5, dist_shift=0.1,
                     aggr_alpha_t_conorm_p=1.5, near=0.5, far=20.0,
                     background_color=np.array([0.1, 0.2, 0.3]))
    want = np.asarray(JPM._params_vec(jp, cfg=jcfg))
    got = PM._params_vec(tp, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize('image_size,face_chunk', [(32, 8), (48, 4)])
def test_tile_chunk_mask_and_hit_lists_match_jax(image_size, face_chunk):
    fv = small_faces_scene(seed=3)
    B, F = fv.shape[:2]
    tex = np.ones((B, F, 1, 3), np.float32)
    jcfg, cfg = _cfg(image_size=image_size)
    jp, tp = _params(dist_scale=2e-2)
    fvalid = np.ones(F, bool)
    jpk = JP.pack_faces(jnp.asarray(fv), jnp.asarray(tex),
                        jnp.asarray(fvalid), jcfg)
    tpk = pack.pack_faces(torch.from_numpy(fv), torch.from_numpy(tex),
                          torch.from_numpy(fvalid), cfg)
    margin = JP.cull_margin(jcfg, jp)
    want = np.asarray(JP.tile_chunk_mask(jpk, image_size, 16, 16,
                                         face_chunk, margin))
    got = pack.tile_chunk_mask(tpk, image_size, 16, 16, face_chunk,
                               pack.cull_margin(cfg, tp))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    for g, w in zip(pack.compact_hits(got), JP.compact_hits(jnp.asarray(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tile_chunk_mask_ragged_covers_edge_tiles():
    """A size the tile does not divide gets ceil(size / 16) tiles a side;
    the edge tiles' hits are a superset of the pixels they hold."""
    fv = small_faces_scene(seed=4)
    B, F = fv.shape[:2]
    _, cfg = _cfg(image_size=40)
    _, tp = _params(dist_scale=2e-2)
    tpk = pack.pack_faces(torch.from_numpy(fv), torch.ones(B, F, 1, 3),
                          torch.ones(F, dtype=torch.bool), cfg)
    margin = pack.cull_margin(cfg, tp)
    mask = pack.tile_chunk_mask(tpk, 40, 16, 16, 8, margin)
    assert mask.shape == (B, 9, 4)
    assert 0 < int(mask.sum()) < mask.numel()
    # per-face test at the pixel level: every face whose bbox + margin
    # reaches a pixel of tile t has its chunk on t's list
    idx = torch.arange(40 * 40)
    r, c = idx // 40, idx % 40
    xp = (2.0 * c + 1.0 - 40) / 40
    yp = (2.0 * (39 - r) + 1.0 - 40) / 40
    tile = (r // 16) * 3 + c // 16
    for b in range(B):
        for f in range(F):
            bx = tpk[b, :4, f]
            near = ((xp >= bx[0] - margin) & (xp <= bx[1] + margin)
                    & (yp >= bx[2] - margin) & (yp <= bx[3] + margin))
            for t in tile[near].unique():
                assert mask[b, t, f // 8] == 1, (b, f, int(t))


@pytest.mark.parametrize('spec', [
    dict(dist_func='logistic', aggr_rgb_func='hard'),
    dict(dist_func='uniform', aggr_rgb_func='softmax', double_side=False),
    dict(dist_func='gaussian', dist_squared=True, aggr_rgb_func='hard'),
    dict(dist_func='hard', aggr_rgb_func='softmax'),
    dict(dist_func='gamma', aggr_rgb_func='hard'),
])
def test_pair_math_fields_match_jax(spec):
    fv = sliver_scene(seed=5, B=1, F=40)
    F = fv.shape[1]
    tex = np.ones((1, F, 1, 3), np.float32)
    jcfg, cfg = _cfg(**spec)
    jp, tp = _params(dist_scale=5e-2, dist_shape=2.0)
    fvalid = np.ones(F, bool)
    jpk = JP.pack_faces(jnp.asarray(fv), jnp.asarray(tex),
                        jnp.asarray(fvalid), jcfg)
    tpk = pack.pack_faces(torch.from_numpy(fv), torch.from_numpy(tex),
                          torch.from_numpy(fvalid), cfg)
    n = 40
    g = (2.0 * np.arange(n) + 1.0 - n) / n
    xp, yp = [a.reshape(-1).astype(np.float32) for a in np.meshgrid(g, g)]
    jpar = JPM._params_vec(jp, cfg=jcfg)
    want = JPM._pair_math(lambda i: jpk[0, i][None, :],
                          jnp.asarray(xp)[:, None], jnp.asarray(yp)[:, None],
                          jpar, jcfg)
    args = (lambda i: tpk[0, i][None, :], torch.from_numpy(xp)[:, None],
            torch.from_numpy(yp)[:, None], PM._params_vec(tp, cfg), cfg)
    got = PM._pair_math(*args)
    # the forward branch computes the same coverage bitwise, which the max
    # t-conorm's gradient relies on
    fwd = PM._pair_math(*args, fwd_only=True)
    for key in ('frag', 'valid', 'dis'):
        if key in fwd:
            np.testing.assert_array_equal(fwd[key].numpy(), got[key].numpy())
    assert set(want) == set(got)
    for key in ('inside', 'in_loose', 'valid', 'zvalid', 'front_ok', 'cull'):
        w = np.broadcast_to(np.asarray(want[key]), got[key].shape)
        # the same fp32 sequence, but the libraries round transcendentals
        # (the CDF) differently: a pair flips only where a value sits within
        # an ulp of a threshold (1 of these 64000 pairs does)
        flips = (got[key].numpy() != w).mean()
        assert flips <= 1e-4, (key, flips)
    np.testing.assert_allclose(got['frag'].numpy(), np.asarray(want['frag']),
                               rtol=1e-5, atol=2e-6)
    # distance, depth and the closest feature matter on the pairs that
    # contribute; elsewhere a degenerate face's depth is 1/0 and XLA flushes
    # denormals to zero.  Two edges tie at a corner, where the selected
    # edge may differ by an ulp: the fields that follow it are compared
    # where both select the same edge
    valid = got['valid'].numpy() & np.asarray(want['valid'])
    ksel_same = got['ksel'].numpy() == np.asarray(want['ksel'])
    assert ksel_same[valid].mean() >= 0.999
    for key in ('dis', 'denom', 'zp', 'rdis', 'dis_x', 'dis_y', 'tv'):
        if key in got:
            m = valid & ksel_same if key in ('dis_x', 'dis_y', 'tv') \
                else valid
            w = np.broadcast_to(np.asarray(want[key]), got[key].shape)
            np.testing.assert_allclose(got[key].numpy()[m], w[m],
                                       rtol=1e-5, atol=2e-6, err_msg=key)
    for k in range(3):
        np.testing.assert_allclose(got['w'][k].numpy(),
                                   np.asarray(want['w'][k]), rtol=1e-5,
                                   atol=1e-6)
    assert got['frag'].max() > 0.5


def test_tw_from_ksel_matches_jax():
    rng = np.random.RandomState(0)
    ksel = rng.randint(0, 3, 50).astype(np.int32)
    tv = rng.rand(50).astype(np.float32)
    want = JPM.tw_from_ksel(jnp.asarray(ksel), jnp.asarray(tv))
    got = PM.tw_from_ksel(torch.from_numpy(ksel), torch.from_numpy(tv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the weights of a closest point on an edge sum to one
    np.testing.assert_allclose(sum(got).numpy(), 1.0, rtol=1e-6)
