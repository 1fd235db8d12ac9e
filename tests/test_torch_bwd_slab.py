"""Compaction's appended chunks in the backward, on the CPU.

Per-tile face compaction appends one 128-slot chunk (a slab) per tile and
slab after the sorted faces.  ``csrc/rasterize_bwd.cu`` walks them with
``rasterize_bwd_slab`` (alpha, and hard RGB over vertex colours or one
texel): one block per (tile, batch element) holding the tile's slabs, their
slots culled against the tile once per block by
``cuda_backend.tile_face_survivors``' rule, and a warp per survivor that
sums it over its gate rectangle's pixels in a fixed order.  The kernel runs
only on the card (``tests/test_torch_kernels.py``); here the rule it
implements is held against the plain version and against ``gendr_tpu``:

* on compacted prepasses (the flagship's icosphere, cut to 320 faces so
  that the gate fires at 64x64, whole and in a row band, probabilistic and
  max, one texel and vertex colours; and ``opt_camera``'s 12-face cube at
  its defaults, B=8 at 64x64, logistic, tau 1e-1 and 1e-7) every slab
  column to which ``rasterize_bwd_plain`` gives a gradient that is not
  zero is among its tile's survivors, so the block's cull loses no pair;
  ``chip_smoke.slab_lanes`` counts the blocks, survivors and pairs as the
  gate does, and a recorded backward's ``compact.slab_survivors``
  (``cuda_backend.slab_survivors``) is the count of those survivors;
* the compacted render's gradient through the plain versions (the slots'
  rows folded by ``pack.scatter_slots``) against ``gendr_tpu``'s compacted
  Pallas path in interpret mode at ``opt_camera``'s configuration, B=4:
  the image within 2e-3, the gradient's entries within np.isclose(atol
  5e-4, rtol 5e-3) on more than 99 % of them, as
  ``tests/test_torch_compact.py`` holds the other compacted renders;
* the wrapper refuses appended chunks under a parametric fold, which
  compaction never admits and the kernel has no instantiation for, and
  appended chunks that are not slabs a tile of at most 256 slots (the C
  entry refuses them too), on every device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CAMERA_DEFAULT_TAUS, camera_experiment,
                        camera_inputs, slab_lanes)
from gendr_tpu.raster.render import render as jrender
from gendr_tpu_torch import config as C, data
from gendr_tpu_torch.geometry import core, transforms as T
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster.render import render
from gendr_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = 2e-3
GRAD_ATOL, GRAD_RTOL = 5e-4, 5e-3


def _icosphere_inputs(texture_type='surface', **kw):
    """The flagship scene (tau 1e-2, uniform, probabilistic, hard RGB) on
    the level-2 icosphere (320 faces) at 64x64, where compaction fires
    (Fp / 8 T = 3: two slabs a tile)."""
    v, f = data.icosphere(2)
    verts = torch.as_tensor(v)[None] * 0.9
    eyes = T.get_points_from_angles(torch.full((1,), 2.732),
                                    torch.full((1,), 30.0),
                                    torch.full((1,), 45.0))
    verts = T.perspective(T.look_at(verts, eyes), 30.0)
    fv = core.face_vertices(verts, torch.as_tensor(f)[None]).reshape(1, -1, 9)
    tex = torch.as_tensor(np.random.RandomState(0).rand(1, fv.shape[1], 3, 3)
                          if texture_type == 'vertex' else
                          np.random.RandomState(0).rand(1, fv.shape[1], 1, 3),
                          dtype=torch.float32)
    args = dict(image_size=64, dist_func='uniform',
                aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
                texture_type=texture_type, backend='cuda')
    args.update(kw)
    return (C.RenderConfig.create(**args),
            C.RenderParams(dist_scale=1e-2).as_dict(), fv.contiguous(), tex)


def _cube_inputs(tau, B=8):
    """opt_camera at its defaults (the cube, logistic x probabilistic,
    alpha, 64x64), B poses of its first range, the first step's render:
    (cfg, params, face vertices, textures, its soft renderer's keywords
    at dist_scale tau, without the backend)."""
    exp, init = camera_experiment(1, ['-bs', str(B)], device='cpu')
    kw = dict(exp.diff_renderer.render_kwargs(), dist_scale=tau)
    del kw['backend']
    return (*camera_inputs(exp, init, tau), kw)


CASES = {
    'icosphere': lambda: (*_icosphere_inputs(), None),
    'icosphere band': lambda: (*_icosphere_inputs(), (16, 32)),
    'icosphere vertex max': lambda: (
        *_icosphere_inputs('vertex', aggr_alpha_func='max'), None),
    'cube tau 1e-1': lambda: (*_cube_inputs(1e-1)[:4], None),
    'cube tau 1e-7': lambda: (*_cube_inputs(1e-7)[:4], None),
}


def _plain_rows(cfg, params, fv, tex, aux, bwd=CB.rasterize_bwd_plain):
    """The backward's rows [B, NO, Fp] through the plain versions (the
    backward: bwd), from the gradient of 0.5 sum(alpha^2) + 0.1
    sum(rgb)."""
    TS = tex.shape[2]
    band = (aux['row0'], aux['height'])
    out = CB.rasterize_fwd_plain(aux['tile_counts'], aux['tile_ids'],
                                 aux['par'], aux['packed'], aux['perm'], cfg,
                                 TS, *band)
    soft, aggrs = CB._finalize_soa(out, cfg, params)
    g = torch.cat([torch.full_like(soft[:, :3], 0.1), soft[:, 3:]], dim=1)
    pix = CB.pixel_columns(soft, aggrs, g, cfg)
    return bwd(
        aux['chunk_counts'], aux['chunk_ids'], aux['par'], aux['packed'],
        aux['perm'], pix, cfg, TS, *band,
        CB.sorted_face_count(aux) // cfg.face_chunk)


@pytest.mark.parametrize('name', CASES)
def test_slab_gradients_lie_on_the_tile_survivors(name):
    cfg, params, fv, tex, band = CASES[name]()
    aux = CB.prepass(fv, tex, cfg, params, row_band=band)
    assert 'oct_ids' in aux, 'the compaction gate did not fire'
    FC = cfg.face_chunk
    Fs, Fp = CB.sorted_face_count(aux), aux['packed'].shape[2]
    rows = _plain_rows(cfg, params, fv, tex, aux)
    counts, ids = CB.tile_face_survivors(
        aux['packed'], cfg, aux['par'][PM.P_MARGIN], aux['row0'],
        aux['height'], (aux['tile_counts'], aux['tile_ids']))
    live = rows.abs().sum(1) != 0                           # [B, Fp]
    slabs = (Fp - Fs) // FC // counts.shape[1]
    n_live = n_surv = 0
    for b in range(fv.shape[0]):
        for k in range(Fs // FC, Fp // FC):
            cols = set(range(k * FC, (k + 1) * FC))
            n = int(aux['chunk_counts'][b, k])
            assert n <= 1, 'a slab lists one tile'
            if n:
                t = int(aux['chunk_ids'][b, k, 0])
                # the slab kernel reads no ids: slab j of tile t is chunk
                # Fs / FC + t slabs + j
                assert t == (k - Fs // FC) // slabs, (b, k, t)
                surv = set(ids[b, t, :int(counts[b, t])].tolist()) & cols
            else:
                surv = set()
            got = {c for c in cols if bool(live[b, c])}
            assert got <= surv, (b, k, sorted(got - surv))
            n_live += len(got)
            n_surv += len(surv)
    # at tau 1e-7 the CDF is a step to within an ulp at these 8 poses: no
    # slab column has a gradient (at B=200, 16 entries of 2400 do), and
    # the cull is what is checked
    assert n_live > 0 or name == 'cube tau 1e-7'
    assert n_surv > 0
    # the launch: a block per tile, its survivors the cull's, each gated
    # pair a pixel of a survivor's rectangle walked by one lane
    lanes = slab_lanes(aux, cfg)
    T = aux['chunk_ids'].shape[2]
    assert lanes['blocks'] == fv.shape[0] * T
    assert lanes['slots'] == fv.shape[0] * (Fp - Fs)
    assert lanes['survivors'] == n_surv <= lanes['slot_lanes'] \
        <= lanes['slots']
    assert lanes['most_survivors'] <= (Fp - Fs) // T
    assert 0 < lanes['pairs'] <= lanes['pair_lanes'] \
        <= n_surv * CB.TILE ** 2


@pytest.mark.parametrize('name', CASES)
def test_slab_survivors_are_counted(name):
    """A recorded backward counts compact.slab_survivors: the slab slots
    that rasterize_bwd_slab's blocks keep, equal to a brute-force count of
    tile_face_survivors on the slab columns of the tiles that slabs
    serve."""
    cfg, params, fv, tex, band = CASES[name]()
    aux = CB.prepass(fv, tex, cfg, params, row_band=band)
    assert 'oct_ids' in aux
    with profiling.recording(profiling.Recorder('cpu')) as rec:
        _plain_rows(cfg, params, fv, tex, aux, CB.rasterize_bwd)
    FC, Fs = cfg.face_chunk, CB.sorted_face_count(aux)
    counts, ids = CB.tile_face_survivors(
        aux['packed'], cfg, aux['par'][PM.P_MARGIN], aux['row0'],
        aux['height'], (aux['tile_counts'], aux['tile_ids']))
    want = 0
    for b in range(fv.shape[0]):
        for t in range(counts.shape[1]):
            kept = ids[b, t, :int(counts[b, t])].tolist()
            # a tile that overflows its slabs walks sorted chunks instead
            want += sum(c >= Fs for c in kept)
    got = rec.counts()['compact.slab_survivors']
    assert got == want > 0
    slabs = (aux['packed'].shape[2] - Fs) // FC // counts.shape[1]
    per_tile = CB.slab_survivors(aux['packed'], aux['chunk_counts'],
                                 aux['chunk_ids'], Fs // FC, cfg,
                                 aux['par'][PM.P_MARGIN], aux['row0'],
                                 aux['height'])
    assert per_tile.shape == counts.shape and int(per_tile.sum()) == want
    assert int(per_tile.max()) <= slabs * FC


def _jax_grad(fv, kw):
    """(image, grad face vertices) of 0.5 sum(alpha^2) through gendr_tpu's
    compacted backend='pallas' (interpret mode on the CPU)."""
    tex = jnp.ones((fv.shape[0], fv.shape[1], 1, 3), jnp.float32)

    def loss(v):
        img = jrender(v, tex, **kw, backend='pallas')
        return 0.5 * jnp.sum(img[:, 3] ** 2), img
    (_, img), gv = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(fv))
    return np.asarray(img), np.asarray(gv)


@pytest.mark.parametrize('tau', CAMERA_DEFAULT_TAUS)
def test_compacted_camera_backward_matches_pallas(tau):
    """opt_camera's soft render at its defaults, B=4: the port's compacted
    render and gradient (plain versions) against gendr_tpu's compacted
    Pallas path."""
    cfg, params, fv, tex, kw = _cube_inputs(tau, B=4)
    aux = CB.prepass(fv, tex, cfg, params)
    assert 'oct_ids' in aux and cfg.channels == 'alpha'
    v = fv.clone().requires_grad_()
    img = render(v, tex, backend='cuda', **kw)
    (0.5 * (img[:, 3] ** 2).sum()).backward()
    wimg, wgv = _jax_grad(fv.numpy(), kw)
    got = img.detach().numpy()
    assert np.abs(got - wimg).max() < IMG_TOL
    gv = v.grad.numpy()
    assert np.isclose(gv, wgv, atol=GRAD_ATOL, rtol=GRAD_RTOL).mean() > 0.99
    if tau == CAMERA_DEFAULT_TAUS[0]:
        # not won by zeros alone: the gradient has entries well above atol
        assert np.abs(wgv).max() > 100 * GRAD_ATOL
    else:
        # tau 1e-7: no pixel centre of these 4 poses lies within the step
        # of the CDF, on either side
        assert not gv.any() and not wgv.any()


def test_appended_chunks_need_an_alpha_mode_compaction_admits():
    cfg, params, fv, tex = _icosphere_inputs()
    aux = CB.prepass(fv, tex, cfg, params)
    assert 'oct_ids' in aux
    yager = dataclasses.replace(cfg, aggr_alpha_func=C.YAGER_TCN)
    npix, _ = CB._bwd_layout(yager)
    pix = torch.zeros((1, npix, cfg.image_size ** 2))
    with pytest.raises(ValueError, match='appended chunks'):
        CB.rasterize_bwd(aux['chunk_counts'], aux['chunk_ids'], aux['par'],
                         aux['packed'], aux['perm'], pix, yager, 1, 0,
                         cfg.image_size,
                         CB.sorted_face_count(aux) // cfg.face_chunk)


def test_appended_chunks_must_be_slabs_a_tile():
    """Appended chunks that are not the same number of slabs for every
    band tile are refused, not sent to another launch."""
    cfg, params, fv, tex = _icosphere_inputs()
    aux = CB.prepass(fv, tex, cfg, params)
    assert 'oct_ids' in aux
    FC = cfg.face_chunk
    npix, _ = CB._bwd_layout(cfg)
    pix = torch.zeros((1, npix, cfg.image_size ** 2))
    # the last tile's last slab dropped
    with pytest.raises(ValueError, match='slab layout'):
        CB.rasterize_bwd(aux['chunk_counts'][:, :-1].contiguous(),
                         aux['chunk_ids'][:, :-1].contiguous(), aux['par'],
                         aux['packed'][..., :-FC].contiguous(),
                         aux['perm'][:, :-FC].contiguous(), pix, cfg, 1, 0,
                         cfg.image_size,
                         CB.sorted_face_count(aux) // FC)
