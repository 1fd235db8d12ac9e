"""The forward kernel's per-tile cull of each listed chunk's faces, on the
CPU.

``csrc/rasterize_fwd.cu`` tests, once per block and chunk, each face's
fvalid and bbox + margin against the tile's rectangle of pixel centres
(clipped to the image and the row band), and walks only the survivors, in
ascending slot order.  ``cuda_backend.tile_face_survivors`` is that rule in
Python, tested here on random faces (slivers and faces off screen among
them), at 16x16, 17x17 (ragged edge tiles) and 40x40, face chunks of 16 and
32, the whole image, a row band that starts inside a tile (rows 5 onward)
and a face shard whose caller marks faces padded:

* every pair the per-pixel gate admits (``pairmath``'s bbox gate, the
  pixel inside the image and the band, the face valid) has its face among
  its tile's survivors, so skipping the others is exact;
* the survivors are exactly the faces of the listed chunks whose gate
  rectangle meets the tile's rectangle of pixel centres, taken from the
  pixel grid itself;
* they come in ascending slot order, chunk after chunk, each from a chunk
  on its tile's list;
* they are no more than the faces of the listed chunks, and their pairs no
  more than the pairs a walk of every listed face visits.

The kernel itself is held against its plain version on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import visited_pairs
from gendr_tpu_torch import _build, config as C
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster import torch_backend as TB
from torch_threads import one_torch_thread  # noqa: F401

F = 48


def _faces(seed, B=2):
    """F random faces per batch element in NDC (z 2-2.5): most on screen,
    some off it, every fourth a sliver (its third vertex near the middle of
    the first two)."""
    rng = np.random.RandomState(seed)
    centre = (rng.rand(B, F, 1, 3) - 0.5) * np.array([3.2, 3.2, 0.0])
    fv = centre + (rng.rand(B, F, 3, 3) - 0.5) * 0.6
    fv[:, ::4, 2] = 0.5 * (fv[:, ::4, 0] + fv[:, ::4, 1]) + 1e-4
    fv[..., 2] = 2.0 + rng.rand(B, F, 3) * 0.5
    tex = rng.rand(B, F, 1, 3)
    return (torch.as_tensor(fv.reshape(B, F, 9), dtype=torch.float32),
            torch.as_tensor(tex, dtype=torch.float32))


def _inputs(size, fc, dist, tau, band, shard, seed=0):
    """The prepass aux, the config and the cull margin of one case; a shard
    marks every third face padded."""
    cfg = C.RenderConfig.create(image_size=size, dist_func=dist,
                                aggr_alpha_func='probabilistic',
                                aggr_rgb_func='hard', face_chunk=fc,
                                backend='cuda')
    params = C.RenderParams(dist_scale=tau).as_dict()
    fv, tex = _faces(seed)
    fvalid = torch.arange(F) % 3 != 2 if shard else None
    aux = CB.prepass(fv, tex, cfg, params, fvalid, band)
    return aux, cfg, aux['par'][PM.P_MARGIN]


def _gate(aux, cfg, margin):
    """[B, P, Fp] bool: the per-pixel bbox gate of pairmath._pair_math on
    every pixel of the band, for the valid faces."""
    pk = aux['packed']
    xp, yp = TB.pixel_grid(cfg.image_size, aux['height'], aux['row0'])

    def row(i):
        return pk[:, i, None, :]
    return ((xp[None, :, None] >= row(pack.R_BBOX + 0) - margin)
            & (xp[None, :, None] <= row(pack.R_BBOX + 1) + margin)
            & (yp[None, :, None] >= row(pack.R_BBOX + 2) - margin)
            & (yp[None, :, None] <= row(pack.R_BBOX + 3) + margin)
            & (row(pack.R_FVALID) > 0))


def _pixel_tile(cfg, height):
    """Each band pixel's tile, row-major over the band's tiles."""
    is_ = cfg.image_size
    idx = torch.arange(height * is_)
    return (idx // is_ // CB.TILE) * -(-is_ // CB.TILE) \
        + idx % is_ // CB.TILE


def _survivor_mask(counts, ids, Fp):
    """[B, T, Fp] bool of the survivor lists."""
    B, T, _ = ids.shape
    mask = torch.zeros((B, T, Fp + 1), dtype=torch.bool)
    listed = torch.arange(Fp)[None, None] < counts[..., None]
    mask.scatter_(2, torch.where(listed, ids.long(), Fp), True)
    return mask[..., :Fp]


CASES = [(size, fc, dist, tau, band, shard)
         for size in (16, 17, 40) for fc in (16, 32)
         for dist, tau in (('uniform', 3e-2), ('gaussian', 0.3))
         for band, shard in ((None, False), ((5, min(23, size - 5)), False),
                             ((5, min(23, size - 5)), True))]


@pytest.mark.parametrize('size,fc,dist,tau,band,shard', CASES)
def test_survivors_cover_the_gate_in_slot_order(size, fc, dist, tau, band,
                                                shard):
    aux, cfg, margin = _inputs(size, fc, dist, tau, band, shard,
                               seed=size + fc)
    B, _, Fp = aux['packed'].shape
    counts, ids = CB.tile_face_survivors(aux['packed'], cfg, margin,
                                         aux['row0'], aux['height'])
    T = aux['tile_counts'].shape[1]
    assert counts.shape == (B, T) and ids.shape == (B, T, Fp)
    surv = _survivor_mask(counts, ids, Fp)

    # every gated pair's face survives on the pixel's tile
    gate = _gate(aux, cfg, margin)                          # [B, P, Fp]
    ptile = _pixel_tile(cfg, aux['height'])
    assert bool(gate.any())
    assert not bool((gate & ~surv[:, ptile]).any())

    # the survivors are the listed faces whose gate rectangle meets the
    # rectangle of the tile's pixel centres (from the pixel grid)
    xp, yp = TB.pixel_grid(cfg.image_size, aux['height'], aux['row0'])
    pk = aux['packed']
    listed = CB._hit(aux['tile_counts'], aux['tile_ids'], Fp // fc) > 0
    for t in range(T):
        on = ptile == t
        x0, x1 = xp[on].min(), xp[on].max()
        y0, y1 = yp[on].min(), yp[on].max()
        meets = ((pk[:, pack.R_FVALID] > 0)
                 & (x1 >= pk[:, pack.R_BBOX + 0] - margin)
                 & (x0 <= pk[:, pack.R_BBOX + 1] + margin)
                 & (y1 >= pk[:, pack.R_BBOX + 2] - margin)
                 & (y0 <= pk[:, pack.R_BBOX + 3] + margin))
        want = meets & listed[:, t].repeat_interleave(fc, dim=1)
        assert torch.equal(surv[:, t], want), t

    # ascending slot order, each from a listed chunk, -1 past the count
    for b in range(B):
        for t in range(T):
            n = int(counts[b, t])
            row = ids[b, t]
            assert bool((row[n:] == -1).all())
            walk = row[:n].long()
            assert bool((walk[1:] > walk[:-1]).all())
            assert bool(listed[b, t, walk // fc].all())

    # no more than the faces of the listed chunks, pair for pair
    assert bool((counts <= aux['tile_counts'] * fc).all())
    longest, walked, visited = visited_pairs(aux, cfg)
    assert longest == int(aux['tile_counts'].max())
    assert 0 < visited <= walked


def test_the_cull_drops_most_of_a_long_list():
    """At 40x40 with chunks of 16, tau 1e-3, the listed chunks hold many
    faces far from each tile: the cull keeps fewer than half of them."""
    aux, cfg, margin = _inputs(40, 16, 'uniform', 1e-3, None, False)
    counts, _ = CB.tile_face_survivors(aux['packed'], cfg, margin)
    assert int(counts.sum()) < 0.5 * int(aux['tile_counts'].sum()) * 16


def test_forward_block_budget_matches_the_kernel():
    """The wrapper's shared-memory budget is the kernel's: its largest
    chunk and its stage of a chunk's rows, ids, slots and ballot masks."""
    src = (_build.CSRC / 'rasterize_fwd.cu').read_text()
    assert f'MAX_FC = {CB.FWD_MAX_CHUNK};' in src
    assert CB._fwd_smem(128) <= CB.FWD_SMEM_LIMIT
    aux, cfg, _ = _inputs(16, 256, 'uniform', 3e-2, None, False)
    with pytest.raises(ValueError, match='shared-memory stage'):
        CB.rasterize_fwd(aux['tile_counts'], aux['tile_ids'], aux['par'],
                         aux['packed'], aux['perm'], cfg)
