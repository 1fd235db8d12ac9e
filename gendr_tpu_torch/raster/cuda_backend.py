"""Render and its gradient through the hand-written CUDA kernels
(``backend='cuda'``).

Port of ``gendr_tpu/raster/pallas_backend.py``:

* the prepass: ``_sorted_faces`` (Morton sort of the faces by projected
  bbox centre, so a chunk of ``face_chunk`` faces is spatially tight), then
  ``pack.pack_faces``, then ``pack.tile_chunk_mask`` + ``compact_hits``
  (each 16x16 pixel tile's list of hit chunks, and each chunk's list of
  hit tiles for the backward), or, where per-tile face compaction fires,
  ``pack.compact_plan`` and ``pack.pack_faces`` of the sorted faces and
  the tiles' slots; for CUDA tensors whose faces fit its sort,
  ``csrc/prepass.cu`` does all of it, bitwise, in two launches
  (:func:`prepass_kernel`) or, compacted, three
  (:func:`prepass_compact_kernel`; :func:`prepass_path`);
* the forward kernel, ``csrc/rasterize_fwd.cu``, through
  :func:`rasterize_fwd`: one block per tile, which culls each listed
  chunk's faces against the tile (:func:`tile_face_survivors` is that
  cull in Python) and walks the survivors;
* the epilogue ``_finalize_soa``: the background fold (for softmax RGB
  the streaming-softmax merge with the background state) and the reshape
  to [B, 4, H, W], in plain torch;
* the backward kernel, ``csrc/rasterize_bwd.cu``, through
  :func:`rasterize_bwd`, on the pixel columns :func:`pixel_columns` builds
  from the image gradient, then the un-permute to input face order.

For the sharded render (``gendr_tpu_torch.parallel.sharding``),
:func:`forward_partial` returns a face shard's carry without the background
fold, its hard-RGB winner ids offset by the shard's ``base_offset``, and
:func:`backward_from_aux` takes the same ``base_offset``, the caller's
``fvalid`` and a ``row_band`` of image rows: the kernels render or sum one
band of rows (K1e, K2e).

The kernels cover the sub-kernels K1a-K1e and K2a-K2e of ROADMAP.md
Queue 2: channels 'alpha', hard RGB and softmax RGB over vertex textures
or square surface textures (R x R texels per face: any R for hard RGB, up
to ``SOFTMAX_TS_CAP`` texels for softmax RGB, as in the JAX package), with
the alpha mode hard and all nine t-conorms (the six parametric families
fold serially, a pair at a time, with ``aggr_alpha_t_conorm_p`` read from
the parameter vector at run time).  The backward kernel cuts each chunk's
hit-tile list into slices, one block each, and sums the slices' partial
rows in a fixed order in a second pass (:func:`bwd_slice_count`,
:func:`bwd_slices`); it keeps a surface texture's 3 TS gradient sums per
face in shared memory while a chunk's fit there (``_bwd_smem``) and in its
own columns of its slice's workspace rows in global memory above that.
Compaction's appended chunks, one tile each, go to a third kernel for
alpha and hard RGB over vertex colours or one texel,
``rasterize_bwd_slab``: a block per tile holding all its slabs, their
faces culled against it by :func:`tile_face_survivors`' rule
(:func:`slab_survivors` counts the faces kept), and a warp per surviving
face that sums it over its gate rectangle's pixels in a fixed order.

:func:`rasterize_fwd_plain` and :func:`rasterize_bwd_plain` are the
kernels' functions in plain PyTorch: same inputs, same outputs.  The
wrappers launch the kernels for CUDA tensors (or raise) and run the plain
versions only for CPU tensors.

The TPU workarounds are gone: no 128-aligned tiling (the kernel masks the
ragged edge tile, so any image size runs), no split of the hit lists
between SMEM and HBM (a block reads its own list row), no one-hot texel
selection (a pair gathers its texel).  Configurations outside the
kernels' envelope (softmax RGB over more than ``SOFTMAX_TS_CAP`` texels
per face; a texel count that is not a square) raise ``ValueError``;
``backend='torch'`` renders them.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.ops import tconorms as TC
from gendr_tpu_torch.raster import geometry as G
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster import torch_backend as TB
from gendr_tpu_torch.raster.torch_backend import BIG_DEPTH, NEG_INF
from gendr_tpu_torch.utils import profiling

TILE = 16  # pixel tile edge: one CUDA block per 16x16 tile
# shared memory of a forward block (static budget), and the most a backward
# block may use on Hopper (dynamic, opted in above 48 KB)
FWD_SMEM_LIMIT = 48 * 1024
# the forward block's cull keeps one ballot mask per 32 faces of a chunk,
# room for chunks of up to this many faces
FWD_MAX_CHUNK = 256
SMEM_LIMIT = 232448
# what a launch aggregates beside alpha (csrc/pairmath.cuh MODE_*)
MODE_ALPHA, MODE_HARD, MODE_SOFTMAX = 0, 1, 2

# launches of each kernel, counted where the wrapper launches it
# (rasterize_bwd_slab: where rasterize_bwd's C entry reports it launched)
# (prepass: the uncompacted prepass's call; prepass_compact: the compacted
# one's three launches, a call)
LAUNCHES = {'rasterize_fwd': 0, 'rasterize_bwd': 0, 'rasterize_bwd_slab': 0,
            'prepass': 0, 'prepass_compact': 0}
# prepass calls that took the plain PyTorch path, by device type (CUDA
# tensors: more faces than the kernels' sort holds)
PREPASS_PLAIN = {'cpu': 0, 'cuda': 0}
# the prepass kernel's block sorts at most this many (padded) faces in
# shared memory (csrc/prepass.cu SORT_CAP)
PREPASS_SORT_CAP = 16384
# the backward kernel's block is one thread per face of a chunk
MAX_BWD_CHUNK = 256
# the backward cuts each chunk's hit-tile list into at most BWD_SLICE_CAP
# slices, one block each, whose sums fill a workspace of at most
# BWD_WORKSPACE_BYTES (bwd_slice_count)
BWD_SLICE_CAP = 128
BWD_WORKSPACE_BYTES = 256 << 20
# under per-tile face compaction the sorted chunks list only the tiles
# whose octets overflow their slabs (at most 2 a chunk on the flagship,
# none on the default GenDR): at most this many slices, so that the
# blocks of empty slices and their workspace stay few
COMPACT_SLICE_CAP = 4
# softmax RGB samples surface textures of up to this many texels per face
# (gendr_tpu's SOFTMAX_TS_CAP: texture_res 32, four times load_obj's 16);
# hard RGB has no cap
SOFTMAX_TS_CAP = 1024


def render_mode(cfg: C.RenderConfig):
    """MODE_ALPHA for channels 'alpha', else MODE_HARD or MODE_SOFTMAX."""
    if cfg.channels == 'alpha':
        return MODE_ALPHA
    return MODE_HARD if cfg.aggr_rgb_func == C.RGB_HARD else MODE_SOFTMAX


def texture_res(TS: int):
    """R of an R x R surface texture of TS texels (surface_texel_index)."""
    return int(round(TS ** 0.5))


def check_envelope(cfg: C.RenderConfig, TS: int):
    """Raise ValueError for a texture layout the kernels do not cover (TS:
    texels per face): a texel count that is not a square, or softmax RGB
    over more than SOFTMAX_TS_CAP texels per face (hard RGB samples only
    its winner and takes any size)."""
    if cfg.channels == 'alpha' or cfg.texture_type == C.TEXTURE_VERTEX:
        return
    if TS != texture_res(TS) ** 2:
        raise ValueError(
            f'backend="cuda" samples square R x R surface textures; TS={TS} '
            f'texels per face is not a square')
    if cfg.aggr_rgb_func == C.RGB_SOFTMAX and TS > SOFTMAX_TS_CAP:
        raise ValueError(
            f'backend="cuda" covers softmax RGB over surface textures of up '
            f'to {SOFTMAX_TS_CAP} texels per face (texture_res 32); TS={TS}: '
            f'use backend="torch", or hard RGB')


def _sorted_faces(face_vertices, textures, FC, fvalid_in=None):
    """Pad to a chunk multiple and Morton-sort faces by projected bbox
    centre (tight chunk bboxes make the tile x chunk cull selective).

    Returns (fv, tex, fvalid, perm) with sorted[i] = input[perm[i]]; padded
    faces sort to the end with fvalid False, and so do the faces that
    ``fvalid_in`` ([F] bool: the face-sharded path pads globally before it
    slices a shard) marks False (pallas_backend.py:1002-1058).  The sort is
    stable, as JAX's argsort is, so the order is a function of the inputs
    alone.
    """
    F = face_vertices.shape[1]
    fv, tex, fvalid, _, _ = TB._pad_faces(face_vertices, textures, FC)
    if fvalid_in is not None:
        fvalid = fvalid & torch.nn.functional.pad(
            fvalid_in.to(device=fvalid.device, dtype=torch.bool),
            (0, fvalid.shape[0] - F))
    perm = pack.morton_order(fv, fvalid)  # [B, Fp]

    bidx = torch.arange(fv.shape[0], device=fv.device)[:, None]
    return fv[bidx, perm], tex[bidx, perm], fvalid[perm], perm


def _band(cfg: C.RenderConfig, row_band):
    """(row0, height) of a row band, the whole image for None."""
    row0, height = row_band if row_band is not None else (0, cfg.image_size)
    if not (0 <= row0 and 1 <= height and row0 + height <= cfg.image_size):
        raise ValueError(f'row band {row_band} is not inside the '
                         f'{cfg.image_size}-row image')
    return int(row0), int(height)


# the alpha modes whose fold compaction may re-order (gendr_tpu's gate:
# order-exact or already re-associated per lane); the parametric folds keep
# the chunk-granular lists
COMPACT_ALPHA = (C.ALPHA_HARD, C.MAX_TCN, C.PROBABILISTIC_TCN,
                 C.EINSTEIN_TCN)
# the appended slot rows' budget (write-once traffic of the prepass)
COMPACT_BYTES = 128 * 1024 * 1024


def _compact_eligible(cfg: C.RenderConfig, allow_compact):
    """Static gate for per-tile face compaction (RenderConfig.compact;
    pallas_backend.py:563-582): 'auto', a render of all the faces
    (allow_compact False for a face shard, whose winner ids must stay in
    its own contiguous range), and an alpha mode of COMPACT_ALPHA."""
    if cfg.compact != 'auto' or not allow_compact:
        return False
    return cfg.aggr_alpha_func in COMPACT_ALPHA


def _compact_slabs(cfg: C.RenderConfig, TS, T_tiles, Fp):
    """How many 128-slot slabs each tile's compacted chunks get (0:
    compaction off for this scene shape), gendr_tpu's arithmetic
    (pallas_backend.py:585-630): off for surface textures of more than
    pack.TEXEL_UNROLL_CAP texels; else by the density r = Fp / (8 T), the
    octets an active tile should hit: 1 slab to r = 1, 2 to r = 4 (and
    at most 1024 appended chunks), off above; off where the appended rows
    would pass COMPACT_BYTES; never more slabs than chunks.  T_tiles is
    the full image's tile count, so a band builds the full render's
    slot layout."""
    if (cfg.texture_type == C.TEXTURE_SURFACE
            and TS > pack.TEXEL_UNROLL_CAP):
        return 0
    if T_tiles <= 0:
        return 0
    r = Fp / (8.0 * T_tiles)
    if r <= 1.0:
        S = 1
    elif r <= 4.0:
        S = 2
    else:
        return 0
    if S > 1 and T_tiles * S > 1024:
        return 0
    NI = pack.num_rows(cfg.texture_type, TS)
    if T_tiles * S * 128 * NI * 4 > COMPACT_BYTES:
        return 0
    return min(S, max(1, Fp // 128))


def _compaction(cfg: C.RenderConfig, TS, Fp, fvalid, allow_compact):
    """The slabs of per-tile face compaction for a prepass of Fp sorted
    faces (0: off): :func:`_compact_slabs` where :func:`_compact_eligible`
    admits the render, never with ``fvalid``, and only at 128-face
    chunks (a slab is one chunk)."""
    if (cfg.face_chunk != pack.OCT * pack.OCT_CAP or fvalid is not None
            or not _compact_eligible(cfg, allow_compact)):
        return 0
    return _compact_slabs(cfg, TS, _num_tiles(cfg, cfg.image_size), Fp)


def _prepass_smem(Fp, FC):
    """Bytes of shared memory of a prepass_sort block (csrc/prepass.cu
    prepass_smem): the sort's 64-bit words, one a face (an even count),
    then each chunk's bbox union."""
    return 8 * (Fp + Fp % 2) + 16 * (Fp // FC)


def _plan_smem(Fp, T):
    """Bytes of shared memory of a prepass_plan block over T tiles
    (csrc/prepass.cu plan_smem): each octet's bbox union and valid faces,
    then each tile's slabs and a bit per sorted chunk of 128 faces."""
    return 20 * (Fp // pack.OCT) + 4 * T * (1 + (Fp // 128 + 31) // 32)


def prepass_path(cfg: C.RenderConfig, F, TS, device, fvalid=None,
                 allow_compact=True):
    """Which prepass a render of F faces (TS texels per face) on
    ``device`` runs: 'kernel' for CUDA tensors whose padded faces fit the
    kernels' sort (PREPASS_SORT_CAP) and its shared memory; 'plain'
    otherwise: the CPU and larger scenes.  Compaction (TS, ``fvalid``,
    ``allow_compact``: :func:`_compaction`) picks the kernel set,
    :func:`prepass_kernel` or :func:`prepass_compact_kernel`, not the
    path: the plan's shared memory (:func:`_plan_smem`) fits wherever
    compaction fires, since ``_compact_slabs`` keeps T x slabs under
    5 462 and the sort keeps Fp under 16 384."""
    FC = cfg.face_chunk
    Fp = -(-F // FC) * FC
    if (torch.device(device).type != 'cuda' or F < 1
            or Fp > PREPASS_SORT_CAP or _prepass_smem(Fp, FC) > SMEM_LIMIT):
        return 'plain'
    return 'kernel'


def _kernel_inputs(face_vertices, textures, cfg: C.RenderConfig, par,
                   fvalid=None):
    """A kernel prepass's inputs, checked: (face vertices and, where the
    packed rows hold texels, textures as contiguous float32, fvalid as
    contiguous bools or None, B, F, Fp, TS, ntex the texture rows' texels,
    NI the packed rows)."""
    dev = face_vertices.device
    if dev.type != 'cuda':
        raise ValueError(f'no prepass kernel for device {dev}')
    if face_vertices.dtype != torch.float32:
        raise ValueError(f'face_vertices must be torch.float32, got '
                         f'{face_vertices.dtype}')
    B, F = face_vertices.shape[:2]
    if (face_vertices.shape[2:] != (9,) or textures.shape[:2] != (B, F)
            or (fvalid is not None and tuple(fvalid.shape) != (F,))):
        raise ValueError(f'face_vertices must be [B, F, 9], textures [B, '
                         f'F, TS, 3] and fvalid [F]; got '
                         f'{tuple(face_vertices.shape)}, '
                         f'{tuple(textures.shape)} and '
                         f'{None if fvalid is None else tuple(fvalid.shape)}')
    Fp = -(-F // cfg.face_chunk) * cfg.face_chunk
    TS = textures.shape[2]
    ntex = 0
    if cfg.channels != 'alpha':
        ntex = 3 if cfg.texture_type == C.TEXTURE_VERTEX else TS
    NI = pack.num_rows(cfg.texture_type, TS, with_tex=ntex > 0)
    fv = face_vertices.contiguous()
    tex = textures.to(torch.float32).contiguous() if ntex else None
    fval = None if fvalid is None else \
        fvalid.to(device=dev, dtype=torch.bool).contiguous()
    _check_tensors(dev, ('par', par, torch.float32))
    return fv, tex, fval, B, F, Fp, TS, ntex, NI


def _launched(lib, err):
    if err != 0:
        raise RuntimeError('prepass launch failed: '
                           + lib.gendr_error_string(err).decode())


def prepass_kernel(face_vertices, textures, cfg: C.RenderConfig, par,
                   fvalid=None, row0=0, height=None):
    """The uncompacted prepass by ``csrc/prepass.cu`` on the current
    stream, ``prepass_sort`` (the Morton sort, perm and both lists) then
    ``prepass_pack`` (the packed rows): (packed, perm, tile_counts,
    tile_ids, chunk_counts, chunk_ids), bitwise those of the plain prepass
    on the card (the Morton sort, ``pack.pack_faces``,
    ``pack.tile_chunk_mask`` with the margin ``par[P_MARGIN]`` and
    ``pack.compact_hits``), for CUDA tensors that :func:`prepass_path`
    sends here.  Nothing is read back to the host;
    ``LAUNCHES['prepass']`` counts one a call."""
    fv, tex, fval, B, F, Fp, TS, ntex, NI = _kernel_inputs(
        face_vertices, textures, cfg, par, fvalid)
    dev = fv.device
    height = cfg.image_size if height is None else height
    FC = cfg.face_chunk
    K, T = Fp // FC, _num_tiles(cfg, height)

    def out(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    packed = out(B, NI, Fp, dtype=torch.float32)
    perm, tile_counts, tile_ids = out(B, Fp), out(B, T), out(B, T, K)
    chunk_counts, chunk_ids = out(B, K), out(B, K, T)

    from gendr_tpu_torch import _build
    lib = _build.load('prepass')
    _launched(lib, lib.gendr_prepass(
        fv.data_ptr(), 0 if tex is None else tex.data_ptr(),
        0 if fval is None else fval.data_ptr(), par.data_ptr(),
        packed.data_ptr(), perm.data_ptr(), tile_counts.data_ptr(),
        tile_ids.data_ptr(), chunk_counts.data_ptr(), chunk_ids.data_ptr(),
        B, F, Fp, FC, NI, TS, ntex, cfg.image_size, row0, height,
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES['prepass'] += 1
    return packed, perm, tile_counts, tile_ids, chunk_counts, chunk_ids


def prepass_compact_kernel(face_vertices, textures, cfg: C.RenderConfig,
                           par, slabs, row0=0, height=None):
    """The compacted prepass by ``csrc/prepass.cu`` on the current stream,
    ``slabs`` 128-slot slabs a tile (:func:`_compaction`): the Morton sort
    (``prepass_sort`` without its lists), the plan (``prepass_plan``:
    ``pack.compact_plan``'s octet ids and lists, with the margin
    ``par[P_MARGIN]``) and the packed rows of the sorted faces and the
    slots (``prepass_pack``), each its own launch so that the phase marks
    'compact' and 'prepass' lie between them as in :func:`prepass_plain`.
    Returns (packed, perm, tile_counts, tile_ids, chunk_counts, chunk_ids,
    oct_ids), bitwise the plain prepass's on the card, for CUDA tensors
    that :func:`prepass_path` sends here.  Nothing is read back to the
    host; a recorded step counts the plan's census
    (:func:`_count_compaction`); ``LAUNCHES['prepass_compact']`` counts
    one a call."""
    fv, tex, _, B, F, Fp, TS, ntex, NI = _kernel_inputs(
        face_vertices, textures, cfg, par)
    dev = fv.device
    height = cfg.image_size if height is None else height
    K, T = Fp // cfg.face_chunk, _num_tiles(cfg, height)
    G = T * slabs * pack.OCT_CAP  # slot groups of OCT slots, per tile CAP

    def out(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)
    packed = out(B, NI, Fp + G * pack.OCT, dtype=torch.float32)
    perm, oct_ids, tile_live = out(B, Fp + G * pack.OCT), out(B, G), \
        out(B, 2, T)
    tile_counts, tile_ids = out(B, T), out(B, T, max(K, slabs) + 1)
    chunk_counts, chunk_ids = out(B, K + T * slabs), out(B, K + T * slabs, T)

    from gendr_tpu_torch import _build
    lib = _build.load('prepass')
    # the three C entries' last arguments
    tail = (slabs, cfg.image_size, row0, height, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    _launched(lib, lib.gendr_compact_sort(fv.data_ptr(), perm.data_ptr(),
                                          B, F, Fp, *tail))
    profiling.mark('compact')
    _launched(lib, lib.gendr_compact_plan(
        fv.data_ptr(), par.data_ptr(), perm.data_ptr(), oct_ids.data_ptr(),
        tile_live.data_ptr(), tile_counts.data_ptr(), tile_ids.data_ptr(),
        chunk_counts.data_ptr(), chunk_ids.data_ptr(), B, F, Fp, *tail))
    profiling.mark('prepass')
    _launched(lib, lib.gendr_compact_pack(
        fv.data_ptr(), 0 if tex is None else tex.data_ptr(),
        oct_ids.data_ptr(), tile_live.data_ptr(), perm.data_ptr(),
        packed.data_ptr(), B, F, Fp, NI, TS, ntex, *tail))
    if profiling.recorder() is not None:
        _count_compaction(tile_counts, chunk_counts, tile_live[:, 1].sum(),
                          B * G * pack.OCT, K, slabs)
    LAUNCHES['prepass_compact'] += 1
    return (packed, perm, tile_counts, tile_ids, chunk_counts, chunk_ids,
            oct_ids)


def prepass(face_vertices, textures, cfg: C.RenderConfig, params: Dict,
            fvalid=None, row_band=None, allow_compact=True):
    """Sort, pack and build the hit lists: the kernels' inputs (per tile
    its hit chunks for the forward, per chunk its hit tiles for the
    backward).  ``fvalid`` ([F] bool) marks the faces a caller padded;
    ``row_band=(row0, height)`` lists the tiles of those image rows alone
    (the aux records the band as 'row0' and 'height').

    CUDA tensors go to :func:`prepass_kernel`, or where compaction fires
    :func:`prepass_compact_kernel` (the aux keeps 'oct_ids'), where
    :func:`prepass_path` says so; the rest runs :func:`prepass_plain`
    (PREPASS_PLAIN counts those calls)."""
    row0, height = _band(cfg, row_band)
    dev = face_vertices.device
    F, TS = face_vertices.shape[1], textures.shape[2]
    if prepass_path(cfg, F, TS, dev, fvalid, allow_compact) == 'plain':
        PREPASS_PLAIN[dev.type] = PREPASS_PLAIN.get(dev.type, 0) + 1
        return prepass_plain(face_vertices, textures, cfg, params, fvalid,
                             row_band, allow_compact)
    par = PM._params_vec(params, cfg, dev)
    aux = dict(par=par, row0=row0, height=height)
    Fp = -(-F // cfg.face_chunk) * cfg.face_chunk
    slabs = _compaction(cfg, TS, Fp, fvalid, allow_compact)
    if slabs:
        *outs, aux['oct_ids'] = prepass_compact_kernel(
            face_vertices, textures, cfg, par, slabs, row0, height)
    else:
        outs = prepass_kernel(face_vertices, textures, cfg, par, fvalid,
                              row0, height)
    aux.update(zip(('packed', 'perm', 'tile_counts', 'tile_ids',
                    'chunk_counts', 'chunk_ids'), outs))
    return aux


def prepass_plain(face_vertices, textures, cfg: C.RenderConfig,
                  params: Dict, fvalid=None, row_band=None,
                  allow_compact=True):
    """:func:`prepass` in plain PyTorch, on any device.  Where per-tile
    face compaction is on (:func:`_compaction`: never with ``fvalid``,
    never without ``allow_compact``), the slot faces of
    ``pack.compact_plan`` are packed after the Fp sorted faces, ``perm``
    gives each slot its source face's input id, the lists are the plan's,
    and the aux keeps 'oct_ids' for the backward's fold of the slot
    rows."""
    FC = cfg.face_chunk
    row0, height = _band(cfg, row_band)
    fv, tex, fvalid_s, perm = _sorted_faces(face_vertices, textures, FC,
                                            fvalid)
    B, Fp = fv.shape[:2]
    with_tex = cfg.channels != 'alpha'
    par = PM._params_vec(params, cfg, fv.device)
    # the cull's margin is the vector's slot (pack.cull_margin's value)
    margin = par[PM.P_MARGIN]
    slabs = _compaction(cfg, textures.shape[2], Fp, fvalid, allow_compact)
    aux = dict(par=par, row0=row0, height=height)
    if slabs:
        # a recorded step's phases: the plan alone, then the rest of the
        # prepass again
        profiling.mark('compact')
        plan = pack.compact_plan(fv, tex if with_tex else None, fvalid_s,
                                 cfg.image_size, TILE, TILE, margin,
                                 Fp // FC, FC, height, row0, slabs)
        profiling.mark('prepass')
        if profiling.recorder() is not None:
            _count_compaction(plan['tile_counts'], plan['chunk_counts'],
                              plan['slot_fvalid'].sum(),
                              plan['slot_fvalid'].numel(), Fp // FC, slabs)
        fv = torch.cat([fv, plan['slot_fv']], 1)
        if with_tex:
            tex = torch.cat([tex, plan['slot_tex']], 1)
        fvalid_s = torch.cat([fvalid_s, plan['slot_fvalid']], 1)
        # a slot's input id is its source face's
        src = (plan['oct_ids'].long()[..., None] * pack.OCT
               + torch.arange(pack.OCT, device=fv.device)).reshape(B, -1)
        perm = torch.cat([perm, torch.gather(perm, 1, src)], 1)
        lists = (plan['tile_counts'], plan['tile_ids'], plan['chunk_counts'],
                 plan['chunk_ids'])
        aux['oct_ids'] = plan['oct_ids']
    packed = pack.pack_faces(fv, tex, fvalid_s, cfg, with_tex=with_tex)
    if 'oct_ids' not in aux:
        mask = pack.tile_chunk_mask(packed, cfg.image_size, TILE, TILE, FC,
                                    margin, height, row0)
        lists = pack.compact_hits(mask)
    tile_counts, tile_ids, chunk_counts, chunk_ids = lists
    return dict(aux, packed=packed, perm=perm.to(torch.int32),
                tile_counts=tile_counts, tile_ids=tile_ids,
                chunk_counts=chunk_counts, chunk_ids=chunk_ids.contiguous())


def _count_compaction(tile_counts, chunk_counts, slots_used, slots, K,
                      slabs):
    """The recorded step's census of a compaction plan over K sorted
    chunks (its lists tile_counts and chunk_counts), summed over the
    batch: 'compact.tiles_hit', the tiles that any octet hits (each lists
    a chunk); 'compact.tiles_slab', those served by slabs (the first slab
    of tile t, chunk K + t slabs, lists it); 'compact.slots_used', the
    slab slots that hold a valid face, of 'compact.slots'.  The backward
    counts 'compact.slab_survivors' (:func:`rasterize_bwd`)."""
    profiling.count('compact.tiles_hit', (tile_counts > 0).sum())
    profiling.count('compact.tiles_slab', chunk_counts[:, K::slabs].sum())
    profiling.count('compact.slots_used', slots_used)
    profiling.count('compact.slots', slots)


def slab_survivors(packed, chunk_counts, chunk_ids, K,
                   cfg: C.RenderConfig, margin, row0=0, height=None):
    """Of compaction's appended slabs (the chunks after the K sorted ones,
    each listing one band tile or nothing: chunk_counts, chunk_ids, the
    prepass's), the slots that ``rasterize_bwd_slab``'s block of each
    tile keeps: [B, T] int32, :func:`tile_face_survivors`' cull on the
    slab columns.  What the kernel's blocks count on the card, and what a
    recorded backward counts on the CPU."""
    FC, T = cfg.face_chunk, chunk_ids.shape[2]
    listed = _hit(chunk_counts[:, K:], chunk_ids[:, K:], T)  # [B, slabs, T]
    return _tile_keep(packed[:, :, K * FC:], cfg, margin, row0, height,
                      listed.transpose(1, 2)).sum(2, dtype=torch.int32)


def sorted_face_count(aux):
    """Fp, the sorted faces of a prepass's packed columns: all of them, or
    those before compaction's appended slots."""
    Fp = aux['packed'].shape[2]
    if 'oct_ids' in aux:
        Fp -= aux['oct_ids'].shape[1] * pack.OCT
    return Fp


def _check_tensors(dev, *named):
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f'{name} is on {x.device}, packed on {dev}')
        if x.dtype != dt:
            raise ValueError(f'{name} must be {dt}, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _check_rows(NI, cfg: C.RenderConfig, TS):
    """The packed row count must be the layout the kernels read: the
    geometry rows, plus the texture rows for RGB."""
    want = pack.num_rows(cfg.texture_type, TS,
                         with_tex=cfg.channels != 'alpha')
    if NI != want:
        raise ValueError(f'packed has {NI} rows, not the {want} the kernels '
                         f'read for channels={cfg.channels!r}, texture '
                         f'type {cfg.texture_type} and TS={TS}')


def _num_tiles(cfg: C.RenderConfig, height):
    """16x16 tiles of a band of height rows (ragged edge tiles count)."""
    return -(-cfg.image_size // TILE) * -(-height // TILE)


def _check_inputs(tile_counts, tile_ids, par, packed, perm, cfg, TS, row0,
                  height):
    _check_tensors(packed.device,
                   ('tile_counts', tile_counts, torch.int32),
                   ('tile_ids', tile_ids, torch.int32),
                   ('par', par, torch.float32),
                   ('packed', packed, torch.float32),
                   ('perm', perm, torch.int32))
    B, NI, Fp = packed.shape
    _band(cfg, (row0, height))
    T = _num_tiles(cfg, height)
    if Fp % cfg.face_chunk:
        raise ValueError(f'packed face count {Fp} is not a multiple of '
                         f'face_chunk {cfg.face_chunk}')
    if tuple(tile_counts.shape) != (B, T) or tile_ids.shape[:2] != (B, T):
        raise ValueError(f'hit lists must be [B={B}, T={T}, ...], got '
                         f'{tuple(tile_counts.shape)} and '
                         f'{tuple(tile_ids.shape)}')
    if tuple(perm.shape) != (B, Fp) or tuple(par.shape) != (PM.NPAR,):
        raise ValueError(f'perm must be [{B}, {Fp}] and par [{PM.NPAR}]')
    _check_rows(NI, cfg, TS)
    if _fwd_smem(cfg.face_chunk) > FWD_SMEM_LIMIT:
        raise ValueError(f'face_chunk {cfg.face_chunk} exceeds the '
                         f'{FWD_SMEM_LIMIT}-byte shared-memory stage')


def _fwd_smem(FC):
    """Bytes of shared memory a forward block stages a chunk of FC faces
    in (csrc/rasterize_fwd.cu fwd_smem): the survivors' geometry rows,
    their input ids and slots, two chunks' ballot masks of the cull and
    the tile's rectangle of pixel centres."""
    return ((pack.NI_BASE + 2) * FC + 2 * (FWD_MAX_CHUNK // 32) + 4) * 4


def rasterize_fwd(tile_counts, tile_ids, par, packed, perm,
                  cfg: C.RenderConfig, TS=1, row0=0, height=None):
    """The forward kernel: [B, NO, P] float32 in row-major pixel order,
    NO = 1 (alpha) for channels 'alpha', else 6: alpha, depth, winner
    input id, r, g, b for hard RGB, or alpha, ssum, smax and the
    softmax-weighted r, g, b before the background merge for softmax RGB.
    TS: texels per face of surface textures.  The launch renders image rows
    [row0, row0 + height) (height None: the whole image), P = height x
    image_size, from the hit lists of that band's tiles.

    CUDA tensors launch ``csrc/rasterize_fwd.cu`` on the current stream;
    CPU tensors run :func:`rasterize_fwd_plain`.
    """
    height = cfg.image_size if height is None else height
    _check_inputs(tile_counts, tile_ids, par, packed, perm, cfg, TS, row0,
                  height)
    check_envelope(cfg, TS)
    if packed.device.type == 'cpu':
        return rasterize_fwd_plain(tile_counts, tile_ids, par, packed, perm,
                                   cfg, TS, row0, height)
    if packed.device.type != 'cuda':
        raise ValueError(f'no forward kernel for device {packed.device}')

    from gendr_tpu_torch import _build
    lib = _build.load('rasterize_fwd')
    B, NI, Fp = packed.shape
    mode = render_mode(cfg)
    P = height * cfg.image_size
    out = torch.empty((B, 1 if mode == MODE_ALPHA else 6, P),
                      dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device)
    err = lib.gendr_rasterize_fwd(
        tile_counts.data_ptr(), tile_ids.data_ptr(), tile_ids.shape[2],
        par.data_ptr(), packed.data_ptr(), perm.data_ptr(), out.data_ptr(),
        B, NI, Fp, cfg.face_chunk, cfg.image_size, row0, height,
        cfg.dist_func,
        int(cfg.dist_squared), cfg.aggr_alpha_func, mode,
        int(cfg.double_side), cfg.texture_type, texture_res(TS),
        packed.device.index or 0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError('rasterize_fwd launch failed: '
                           + lib.gendr_error_string(err).decode())
    LAUNCHES['rasterize_fwd'] += 1
    return out


def tile_face_survivors(packed, cfg: C.RenderConfig, margin, row0=0,
                        height=None, lists=None):
    """The forward kernel's cull, in plain PyTorch: of each chunk a tile
    lists (``lists`` = (tile_counts, tile_ids), the prepass's; None:
    ``pack.tile_chunk_mask`` with this margin, as an uncompacted prepass
    builds them), the faces the kernel's block keeps and walks.

    A face survives when its fvalid row is set and its bbox + margin
    meets the tile's rectangle of pixel centres, clipped to the image
    and to the band of rows [row0, row0 + height) (None: all rows), with
    the per-pixel gate's expressions (``row - margin <= x <= row +
    margin``) at the tile's least and greatest centre.  Every pair the
    gate admits therefore has its face among its tile's survivors.  The
    survivors are compacted as the kernel compacts them, by a prefix count
    of the flags: in ascending sorted slot, chunk after chunk.

    Returns (counts [B, T] int32, ids [B, T, Fp] int32): tile t of batch
    element b walks sorted slots ids[b, t, :counts[b, t]], -1 past them.
    """
    B, _, Fp = packed.shape
    FC = cfg.face_chunk
    dev = packed.device
    margin = torch.as_tensor(margin, dtype=torch.float32, device=dev)
    if lists is None:
        height = cfg.image_size if height is None else height
        listed = pack.tile_chunk_mask(packed, cfg.image_size, TILE, TILE,
                                      FC, margin, height, row0)
    else:
        listed = _hit(*lists, Fp // FC)
    keep = _tile_keep(packed, cfg, margin, row0, height, listed)
    counts = keep.sum(2, dtype=torch.int32)
    pos = torch.where(keep, torch.cumsum(keep, 2) - 1, Fp)
    ids = torch.full((B, keep.shape[1], Fp + 1), -1, dtype=torch.int32,
                     device=dev)
    slots = torch.arange(Fp, dtype=torch.int32, device=dev)
    ids.scatter_(2, pos, slots.expand_as(keep).contiguous())
    return counts, ids[..., :Fp]


def _tile_keep(packed, cfg: C.RenderConfig, margin, row0, height, listed):
    """[B, T, F] bool: the forward kernel's cull of the columns of packed
    [B, NI, F] against each band tile, listed [B, T, F / FC] (not 0: the
    tile lists the columns' chunk), as :func:`tile_face_survivors` says."""
    is_ = cfg.image_size
    height = is_ if height is None else height
    dev = packed.device
    margin = torch.as_tensor(margin, dtype=torch.float32, device=dev)
    listed = listed.repeat_interleave(cfg.face_chunk, dim=2) > 0
    tx = -(-is_ // TILE)
    t = torch.arange(_num_tiles(cfg, height), device=dev)
    c0, r0 = t % tx * TILE, t // tx * TILE
    i = torch.stack([c0, torch.clamp(c0 + TILE - 1, max=is_ - 1),
                     is_ - 1 - row0 - torch.clamp(r0 + TILE - 1,
                                                  max=height - 1),
                     is_ - 1 - row0 - r0])
    # each tile's least and greatest pixel centre in the image and the
    # band (csrc/pairmath.cuh pixel_x of column i; pixel_y of image row r
    # is that of column is - 1 - r; y falls as the row rises)
    xlo, xhi, ylo, yhi = ((2.0 * i.to(torch.float32) + 1.0 - is_)
                          / is_)[:, None, :, None]          # [1, T, 1]

    def bb(r):
        return packed[:, pack.R_BBOX + r, None, :]           # [B, 1, F]
    return ((packed[:, pack.R_FVALID, None, :] > 0)
            & (xhi >= bb(0) - margin) & (xlo <= bb(1) + margin)
            & (yhi >= bb(2) - margin) & (ylo <= bb(3) + margin)
            & listed)


def _chunk_textures(pk, cfg: C.RenderConfig, TS):
    """A chunk's texture rows of its packed rows pk [B, NI, FC] as the
    torch backend's textures: [B, FC, TS, 3], or [B, FC, 3, 3] for vertex
    colours."""
    B, _, FC = pk.shape
    n = 3 if cfg.texture_type == C.TEXTURE_VERTEX else TS
    return pk[:, pack.R_TEX:pack.R_TEX + 3 * n].reshape(B, n, 3, FC) \
        .permute(0, 3, 1, 2)


def _tile_pixels(image_size, height, device):
    """[T, TILE * TILE] int64: each tile's band-local pixel indices in
    row-major order, -1 past the image's or the band's edge."""
    tx, ty = -(-image_size // TILE), -(-height // TILE)
    t = torch.arange(tx * ty, device=device)[:, None]
    i = torch.arange(TILE * TILE, device=device)
    r, c = t // tx * TILE + i // TILE, t % tx * TILE + i % TILE
    return torch.where((r < height) & (c < image_size), r * image_size + c,
                       -1)


def _listed_pixels(listed, tile_pix):
    """The pixels, ascending, of the tiles listed ([T] bool) marks."""
    p = tile_pix[listed].reshape(-1)
    return p[p >= 0].sort().values


def _hit(counts, ids, n):
    """[B, A, n] int32: is item i on row a's list (the first counts[b, a]
    entries of ids[b, a])?"""
    B, A = counts.shape
    listed = (torch.arange(ids.shape[2], device=ids.device)[None, None, :]
              < counts[..., None]).to(torch.int32)
    hit = torch.zeros((B, A, n), dtype=torch.int32, device=ids.device)
    # entries past a row's count may name anything (a compacted tile's
    # unused slab ids): they add 0 at item 0
    hit.scatter_add_(2, torch.where(listed > 0, ids, 0).long(), listed)
    return hit


def _fold_chunk(pk, oid, on, xp, yp, par, cfg: C.RenderConfig, TS, state):
    """rasterize_fwd_plain's fold of one chunk (packed rows pk [B, NI, FC],
    input ids oid [B, 1, FC]) into the state (acc, best, best_id, ssum,
    smax, rgb) of the P pixels at (xp, yp) ([P], or [B, P] for pixels of
    each batch row's own); on [B, P]: does the pixel's tile list the
    chunk?  Returns the new state."""
    acc, best, best_id, ssum, smax, rgb = state
    B, P = on.shape
    FC = pk.shape[2]
    mode = render_mode(cfg)
    tid = cfg.aggr_alpha_func
    gamma, near, far = par[PM.P_GAMMA], par[PM.P_NEAR], par[PM.P_FAR]
    big_id = torch.iinfo(torch.int32).max

    def row(i):
        return pk[:, i, None, :]                            # [B, 1, FC]
    xp, yp = (x.expand(B, P)[..., None] for x in (xp, yp))
    q = PM._pair_math(row, xp, yp, par, cfg, fwd_only=True,
                      need_depth=mode != MODE_ALPHA)
    valid = q['valid'] & on[..., None]
    frag = torch.where(valid, q['frag'], 0.0)

    if tid == C.ALPHA_HARD:
        acc = torch.where((frag > 0.5).any(-1), 1.0, acc)
    elif tid == C.MAX_TCN:
        acc = torch.maximum(acc, frag.amax(-1))
    elif tid == C.PROBABILISTIC_TCN:
        for f in range(FC):
            acc = acc * (1.0 - frag[..., f])
    elif tid == C.EINSTEIN_TCN:
        for f in range(FC):
            acc = (acc + frag[..., f]) / (1.0 + acc * frag[..., f])
    else:
        for f in range(FC):
            acc = TC.fold_step(tid, acc, frag[..., f], par[PM.P_TCP])
    if mode == MODE_ALPHA:
        return acc, best, best_id, ssum, smax, rgb
    # each pair's colour [B, P, FC, 3] (csrc/pairmath.cuh:sample_color)
    col = TB._sample_colors(_chunk_textures(pk, cfg, TS), q['wcn'], cfg)

    if mode == MODE_HARD:
        hmask = valid & q['zvalid'] & q['in_loose'] & q['front_ok']
        dm = torch.where(hmask, q['denom'], NEG_INF)     # [B, P, FC]
        dmax = dm.amax(-1)
        tie = hmask & (dm == dmax[..., None])
        oid_sel = torch.where(tie, oid, big_id).amin(-1)
        better = (dmax > best) | ((dmax == best) & (oid_sel < best_id))
        pos = (tie & (oid == oid_sel[..., None])).to(torch.int32) \
            .argmax(-1)                                   # [B, P]
        col = torch.gather(col, 2, pos[..., None, None]
                           .expand(B, P, 1, 3))[:, :, 0]
        best = torch.where(better, dmax, best)
        best_id = torch.where(better, oid_sel, best_id)
        rgb = torch.where(better[..., None], col, rgb)
    else:
        # streaming softmax, a face at a time: rescale when the max
        # rises, then add the pair's weight (cu:824-839)
        cm = valid & q['zvalid'] & q['front_ok']
        zn = (far - q['zp']) / (far - near)
        for f in range(FC):
            m, z = cm[..., f], zn[..., f]
            rise = m & (z > smax)
            sc = torch.exp((smax - z) / gamma)
            ssum = torch.where(rise, ssum * sc, ssum)
            rgb = torch.where(rise[..., None], rgb * sc[..., None], rgb)
            smax = torch.where(rise, z, smax)
            wgt = frag[..., f] * torch.exp((z - smax) / gamma)
            ssum = torch.where(m, ssum + wgt, ssum)
            rgb = torch.where(m[..., None], rgb + wgt[..., None]
                              * col[:, :, f], rgb)
    return acc, best, best_id, ssum, smax, rgb


def _fold_tile_group(group, tile_of, listed, tile_pix, packed, perm, xp, yp,
                     par, cfg: C.RenderConfig, TS, state):
    """rasterize_fwd_plain's fold of the chunks of group (each listed by
    one tile, tile_of[k], no two by the same) into the state, in place:
    one _fold_chunk over batch rows (batch element, chunk), each with its
    tile's pixels (a ragged tile's missing ones left out)."""
    if not group:
        return
    B, NI, _ = packed.shape
    FC = cfg.face_chunk
    G = len(group)
    dev = packed.device
    ks = torch.tensor(group, device=dev)
    tiles = torch.tensor([tile_of[k] for k in group], device=dev)
    pix = tile_pix[tiles]                                   # [G, 256]
    inside = pix >= 0
    pix = pix.clamp(min=0)
    cols = (ks[:, None] * FC + torch.arange(FC, device=dev)).reshape(-1)
    pk = packed[:, :, cols].reshape(B, NI, G, FC).transpose(1, 2) \
        .reshape(B * G, NI, FC)
    oid = perm[:, cols].reshape(B * G, 1, FC)
    on = (listed[:, tiles, ks][..., None] & inside).reshape(B * G, -1)
    xg, yg = (x[pix].expand(B, G, -1).reshape(B * G, -1) for x in (xp, yp))
    part = _fold_chunk(pk, oid, on, xg, yg, par, cfg, TS, [
        x[:, pix].reshape((B * G, pix.shape[1]) + x.shape[2:])
        for x in state])
    for x, y in zip(state, part):
        y = y.reshape((B, G) + y.shape[1:])
        x[:, pix[inside]] = y[:, inside]


def rasterize_fwd_plain(tile_counts, tile_ids, par, packed, perm,
                        cfg: C.RenderConfig, TS=1, row0=0, height=None):
    """The kernel's function in plain PyTorch, on any device, over image
    rows [row0, row0 + height) (None: all).

    A pixel folds the chunks its tile lists, in ascending chunk order, and
    within a chunk the faces in ascending sorted order, as a kernel thread
    does; the probabilistic, einstein and parametric folds and the
    streaming softmax run face by face in that order.  Hard-RGB ties on the
    depth key go to the smaller input face id.
    """
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    K = Fp // FC
    is_ = cfg.image_size
    dev = packed.device
    tx = -(-is_ // TILE)
    mode = render_mode(cfg)
    tid = cfg.aggr_alpha_func

    height = is_ if height is None else height
    hit = _hit(tile_counts, tile_ids, K)                    # [B, T, K]
    P = height * is_
    idx = torch.arange(P, device=dev)                       # band-local
    ptile = (idx // is_ // TILE) * tx + idx % is_ // TILE   # [P]
    xp, yp = TB.pixel_grid(is_, height, row0, dev)

    acc = torch.full((B, P), 1.0 if tid == C.PROBABILISTIC_TCN else 0.0,
                     device=dev)
    best = torch.full((B, P), NEG_INF, device=dev)
    best_id = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    ssum = torch.zeros((B, P), device=dev)
    smax = torch.full((B, P), NEG_INF, device=dev)
    rgb = torch.zeros((B, P, 3), device=dev)

    state = (acc, best, best_id, ssum, smax, rgb)
    tile_pix = _tile_pixels(is_, height, dev)
    listed = hit > 0                                        # [B, T, K]
    ntiles = listed.any(0).sum(0).tolist()
    tile_of = listed.any(0).to(torch.int8).argmax(0).tolist()
    # chunks that one tile lists (compaction's slabs) fold in groups of
    # distinct tiles, one batch row per (batch element, chunk); a group
    # ends before a chunk of several tiles or a second of one of its tiles,
    # so every pixel still folds its chunks in ascending order
    group, most = [], max(1, TB.PAIR_BUDGET // (B * TILE * TILE * FC))
    for k in range(K):
        if ntiles[k] == 1 and len(group) < most \
                and tile_of[k] not in (tile_of[j] for j in group):
            group.append(k)
            continue
        _fold_tile_group(group, tile_of, listed, tile_pix, packed, perm, xp,
                         yp, par, cfg, TS, state)
        group = [k] if ntiles[k] == 1 else []
        if ntiles[k] > 1:
            # the pixels of the tiles that list chunk k: a pixel's fold is
            # its own, so the others can be left out
            tiles = listed[:, :, k]                         # [B, T]
            pixels = _listed_pixels(tiles.any(0), tile_pix)
            sl = slice(k * FC, (k + 1) * FC)
            part = _fold_chunk(packed[:, :, sl], perm[:, None, sl],
                               tiles[:, ptile[pixels]], xp[pixels],
                               yp[pixels], par, cfg, TS,
                               [x[:, pixels] for x in state])
            for x, y in zip(state, part):
                x[:, pixels] = y
    _fold_tile_group(group, tile_of, listed, tile_pix, packed, perm, xp, yp,
                     par, cfg, TS, state)

    alpha = 1.0 - acc if tid == C.PROBABILISTIC_TCN else acc
    if mode == MODE_ALPHA:
        return alpha[:, None, :]
    rgb = rgb.transpose(1, 2)
    if mode == MODE_SOFTMAX:
        return torch.cat([alpha[:, None], ssum[:, None], smax[:, None], rgb],
                         dim=1)
    has = best > NEG_INF
    depth = torch.where(has, 1.0 / best, BIG_DEPTH)
    fidx = torch.where(has, best_id.to(torch.float32), -1.0)
    return torch.cat([alpha[:, None], depth[:, None], fidx[:, None], rgb],
                     dim=1)


def _finalize_soa(out, cfg: C.RenderConfig, params: Dict):
    """Background fold + finalize on the channel-major kernel output
    ([B, NO, P]): (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]), the
    torch backend's contract; H is the band's height for a band's
    output."""
    B, _, P = out.shape
    is_ = cfg.image_size
    h = P // is_
    dev = out.device
    par = PM._params_vec(params, cfg, dev)
    bg = par[PM.P_BG0:PM.P_BG2 + 1].reshape(1, 3, 1)
    alpha = out[:, 0:1]
    mode = render_mode(cfg)
    if mode == MODE_ALPHA:
        rgb_final = bg.expand(B, 3, P)
        aggr0 = torch.full((B, 1, P), BIG_DEPTH, device=dev)
        aggr1 = torch.full((B, 1, P), -1.0, device=dev)
    elif mode == MODE_HARD:
        aggr0, aggr1 = out[:, 1:2], out[:, 2:3]
        rgb_final = torch.where(aggr1 >= 0, out[:, 3:6], bg)
    else:
        # streaming-softmax merge with the background state (smax eps,
        # ssum exp(eps / gamma), rgb bg * ssum; pallas_backend.py:839-851)
        eps, gamma = par[PM.P_EPS], par[PM.P_GAMMA]
        ssum_k, smax_k = out[:, 1:2], out[:, 2:3]
        m = torch.maximum(eps, smax_k)
        sa = torch.exp((eps - m) / gamma)
        sb = torch.exp((smax_k - m) / gamma)
        ssum = torch.exp(eps / gamma) * sa + ssum_k * sb
        rgb = bg * (torch.exp(eps / gamma) * sa) + out[:, 3:6] * sb
        rgb_final = rgb / ssum
        aggr0, aggr1 = ssum, m
    soft_colors = torch.cat([rgb_final, alpha], dim=1).reshape(B, 4, h, is_)
    aggrs_info = torch.cat([aggr0, aggr1], dim=1).reshape(B, 2, h, is_)
    return soft_colors, aggrs_info


def forward_with_aux(face_vertices, textures, cfg: C.RenderConfig,
                     params: Dict):
    """Same contract as torch_backend.forward, plus the prepass products
    (sorted, packed faces and both hit lists) as the backward's aux;
    winner ids in aggrs_info are input face ids."""
    TS = textures.shape[2]
    check_envelope(cfg, TS)
    profiling.mark('prepass')
    aux = prepass(face_vertices, textures, cfg, params)
    profiling.mark('raster')
    out = rasterize_fwd(aux['tile_counts'], aux['tile_ids'], aux['par'],
                        aux['packed'], aux['perm'], cfg, TS)
    soft_colors, aggrs_info = _finalize_soa(out, cfg,
                                            dict(params, par=aux['par']))
    return soft_colors, aggrs_info, aux


def forward(face_vertices, textures, cfg: C.RenderConfig, params: Dict):
    """Same contract as torch_backend.forward; winner ids in aggrs_info are
    input face ids."""
    soft_colors, aggrs_info, _ = forward_with_aux(face_vertices, textures,
                                                  cfg, params)
    return soft_colors, aggrs_info


def forward_partial(face_vertices, textures, cfg: C.RenderConfig,
                    params: Dict, aux=None, base_offset=0, fvalid=None,
                    row_band=None):
    """A face shard's aggregation carry from the forward kernel, with no
    background fold: a ``torch_backend.empty_carry``-compatible state
    (alpha, smax, ssum, rgb, depth, fidx) that ``torch_backend.
    merge_carries`` merges (pallas_backend.py:860-916).  ``fvalid`` ([F]
    bool) marks faces the caller padded; ``row_band=(row0, height)``
    renders those image rows alone; hard-RGB winner ids are this shard's
    input ids plus ``base_offset``, so they are global across face shards.
    Per-tile face compaction stays off for a face shard (``fvalid`` given
    or ``base_offset`` not 0: its slots' ids would leave the shard's id
    range, pallas_backend.py:876-879); a band of all the faces keeps it.
    Returns (carry, aux); aux (the prepass) serves backward_from_aux."""
    TS = textures.shape[2]
    check_envelope(cfg, TS)
    if aux is None:
        aux = prepass(face_vertices, textures, cfg, params, fvalid, row_band,
                      _whole(base_offset, fvalid))
    out = rasterize_fwd(aux['tile_counts'], aux['tile_ids'], aux['par'],
                        aux['packed'], aux['perm'], cfg, TS, aux['row0'],
                        aux['height'])
    alpha = out[:, 0]
    mode = render_mode(cfg)
    empty = TB.empty_carry(alpha.shape[0], alpha.shape[1], cfg,
                           alpha.device)
    if mode == MODE_ALPHA:
        return (alpha,) + empty[1:], aux
    rgb = out[:, 3:6].transpose(1, 2)
    if mode == MODE_HARD:
        fidx = out[:, 2].to(torch.int32)
        fidx = torch.where(fidx >= 0, fidx + base_offset, fidx)
        return (alpha, empty[1], empty[2], rgb, out[:, 1], fidx), aux
    return (alpha, out[:, 2], out[:, 1], rgb, empty[4], empty[5]), aux


def _whole(base_offset, fvalid):
    """May a render with this base_offset and fvalid compact its faces?
    Only a render of all the faces: no face shard."""
    return isinstance(base_offset, int) and base_offset == 0 \
        and fvalid is None


# pixel columns of the backward kernel, rows of its [B, NPIX, P] input:
# the alpha gradient and the final alpha; for RGB the colour gradient,
# then the winner's input face id (hard) or the final colour, the softmax
# sum and the softmax max (softmax)
PIX_GA, PIX_FA, PIX_GR, PIX_WID = 0, 1, 2, 5
PIX_FR, PIX_SSUM, PIX_SMAX = 5, 8, 9


def _bwd_layout(cfg: C.RenderConfig, TS=1):
    """(NPIX, NO): pixel columns read and gradient rows written by the
    backward kernel.  Rows are [x0 y0 x1 y1 x2 y2], then [z0 z1 z2] for
    softmax RGB, then for RGB the texture rows: 9 vertex colours (vertex j
    channel c at 3 j + c) or 3 TS texels (texel t channel c at 3 t + c)."""
    mode = render_mode(cfg)
    if mode == MODE_ALPHA:
        return 2, 6
    ntex = 9 if cfg.texture_type == C.TEXTURE_VERTEX else 3 * TS
    if mode == MODE_HARD:
        return 6, 6 + ntex
    return 10, 9 + ntex


def _bwd_smem(cfg: C.RenderConfig, TS):
    """Bytes of shared memory a backward block needs to hold its ring of
    two tiles' pixel columns and, for a surface texture of TS > 1 texels,
    its [3 TS, FC] gradient sums.  The kernel keeps the sums there
    while this fits SMEM_LIMIT (TS <= 121 at face_chunk 128) and in its
    columns of its workspace slot in global memory above; vertex colours
    and one texel are summed in registers."""
    npix, _ = _bwd_layout(cfg, TS)
    surface = render_mode(cfg) != MODE_ALPHA \
        and cfg.texture_type == C.TEXTURE_SURFACE and TS > 1
    tex = 3 * TS * cfg.face_chunk if surface else 0
    return (2 * npix * TILE * TILE + tex) * 4


def bwd_slice_count(B, NO, Fp, T, compacted=False):
    """S, the slices the backward kernel cuts each chunk's hit-tile list
    into (one block each): BWD_SLICE_CAP (COMPACT_SLICE_CAP where
    ``compacted``: the chunks of a compacted prepass, which list the
    overflow tiles alone), or the T tiles of a shorter list, or fewer
    where the workspace [B, S, NO, Fp] of float32 would pass
    BWD_WORKSPACE_BYTES; 1 where a single slice passes it, and then the
    kernel needs no workspace (:func:`_bwd_workspace`).  A function of
    shapes alone, so a run's sum order is too."""
    cap = COMPACT_SLICE_CAP if compacted else BWD_SLICE_CAP
    slot = B * NO * Fp * 4
    return max(1, min(cap, T, BWD_WORKSPACE_BYTES // slot))


def _bwd_workspace(out, S, Fs=None):
    """The backward kernel's workspace [B, S, NO, Fs] for the result out
    [B, NO, Fp] whose first Fs columns (None: all) are summed in slices:
    out itself where S = 1 (its one slice writes the result and the C entry
    launches no second pass), else a new tensor."""
    if S == 1:
        return out
    B, NO, Fp = out.shape
    Fs = Fp if Fs is None else Fs
    return torch.empty((B, S, NO, Fs), dtype=out.dtype, device=out.device)


def bwd_slices(n, S):
    """The kernel's partition of a list of n hit tiles into S slices:
    [(start, end)] of list positions, slice s = [s n // S, (s + 1) n // S)
    (n an int or an integer tensor)."""
    return [(s * n // S, (s + 1) * n // S) for s in range(S)]


def _check_bwd_inputs(chunk_counts, chunk_ids, par, packed, perm, pix, cfg,
                      TS, row0, height, n_sliced):
    _check_tensors(packed.device,
                   ('chunk_counts', chunk_counts, torch.int32),
                   ('chunk_ids', chunk_ids, torch.int32),
                   ('par', par, torch.float32),
                   ('packed', packed, torch.float32),
                   ('perm', perm, torch.int32),
                   ('pix', pix, torch.float32))
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    _band(cfg, (row0, height))
    T = _num_tiles(cfg, height)
    if Fp % FC:
        raise ValueError(f'packed face count {Fp} is not a multiple of '
                         f'face_chunk {FC}')
    if FC > MAX_BWD_CHUNK:
        raise ValueError(f'face_chunk {FC} exceeds the backward kernel\'s '
                         f'{MAX_BWD_CHUNK} threads per block')
    K = Fp // FC
    if tuple(chunk_counts.shape) != (B, K) \
            or tuple(chunk_ids.shape) != (B, K, T):
        raise ValueError(f'chunk hit lists must be [B={B}, K={K}] and '
                         f'[B, K, T={T}], got {tuple(chunk_counts.shape)} '
                         f'and {tuple(chunk_ids.shape)}')
    if not 1 <= n_sliced <= K:
        raise ValueError(f'n_sliced={n_sliced} is not in 1..{K}')
    if n_sliced < K and cfg.aggr_alpha_func not in COMPACT_ALPHA:
        raise ValueError(f'appended chunks (n_sliced={n_sliced} < {K}) need '
                         f'an alpha mode that compaction admits, not '
                         f'{cfg.aggr_alpha_func}')
    slabs = (K - n_sliced) // T
    if n_sliced < K and slab_route(cfg, TS) and not (
            K - n_sliced == slabs * T and slabs * FC <= TILE * TILE):
        raise ValueError(f'{K - n_sliced} appended chunks of {FC} faces do '
                         f'not fit the slab layout: slabs a tile for the '
                         f'{T} tiles, at most {TILE * TILE} faces a tile')
    if tuple(perm.shape) != (B, Fp) or tuple(par.shape) != (PM.NPAR,):
        raise ValueError(f'perm must be [{B}, {Fp}] and par [{PM.NPAR}]')
    _check_rows(NI, cfg, TS)
    npix, _ = _bwd_layout(cfg, TS)
    P = height * cfg.image_size
    if tuple(pix.shape) != (B, npix, P):
        raise ValueError(f'pix must be [{B}, {npix}, {P}] for '
                         f'channels={cfg.channels!r}, got '
                         f'{tuple(pix.shape)}')


def slab_route(cfg: C.RenderConfig, TS):
    """Whether compaction's appended chunks go to ``rasterize_bwd_slab``
    (the C entry's rule: alpha, or hard RGB whose texture sums live in
    registers, over vertex colours or one texel)."""
    mode = render_mode(cfg)
    return mode == MODE_ALPHA or (mode == MODE_HARD and (
        TS == 1 or cfg.texture_type == C.TEXTURE_VERTEX))


def rasterize_bwd(chunk_counts, chunk_ids, par, packed, perm, pix,
                  cfg: C.RenderConfig, TS=1, row0=0, height=None,
                  n_sliced=None):
    """The backward kernel: per-face gradient rows [B, NO, Fp] float32 in
    sorted face order (see _bwd_layout), from the pixel columns pix
    [B, NPIX, P] (PIX_*) in row-major pixel order.  TS: texels per face of
    surface textures.  The sums run over image rows [row0, row0 + height)
    (None: all), P = height x image_size, with the hit lists of that
    band's tiles.  The first n_sliced chunks (None: all) are cut into
    slices; the chunks after them, compaction's appended slabs, which list
    at most one tile each, get one block each.

    CUDA tensors launch ``csrc/rasterize_bwd.cu`` on the current stream:
    one block per (sliced chunk, batch element, slice of the chunk's hit
    list) into a workspace [B, S, NO, n_sliced x FC] (S =
    :func:`bwd_slice_count` of those columns, ``compacted`` where chunks
    follow them), then the slices summed in
    a fixed order; where S = 1, that pass straight into the result; and
    the appended chunks straight into the result: ``rasterize_bwd_slab``,
    a block per (tile, batch element) holding the tile's slabs and a
    warp per surviving face, for alpha and hard RGB over vertex colours
    or one texel, else the first kernel, a block per (appended chunk,
    batch element) and a thread per face.  ``LAUNCHES['rasterize_bwd']``
    counts one per call, for all its passes, and
    ``LAUNCHES['rasterize_bwd_slab']`` one per call that launched
    ``rasterize_bwd_slab``.  CPU tensors run :func:`rasterize_bwd_plain`.
    A recorded step (``profiling.recorder()``) counts
    'compact.slab_survivors', the slots that ``rasterize_bwd_slab``'s
    blocks keep ([B, T], summed when the counts are read, so the step
    launches nothing for it; on the CPU :func:`slab_survivors`).
    """
    height = cfg.image_size if height is None else height
    check_envelope(cfg, TS)
    K = packed.shape[2] // cfg.face_chunk
    n_sliced = K if n_sliced is None else n_sliced
    _check_bwd_inputs(chunk_counts, chunk_ids, par, packed, perm, pix, cfg,
                      TS, row0, height, n_sliced)
    record = (profiling.recorder() is not None and n_sliced < K
              and slab_route(cfg, TS))
    if packed.device.type == 'cpu':
        if record:
            profiling.count('compact.slab_survivors', slab_survivors(
                packed, chunk_counts, chunk_ids, n_sliced, cfg,
                par[PM.P_MARGIN], row0, height))
        return rasterize_bwd_plain(chunk_counts, chunk_ids, par, packed,
                                   perm, pix, cfg, TS, row0, height,
                                   n_sliced)
    if packed.device.type != 'cuda':
        raise ValueError(f'no backward kernel for device {packed.device}')

    from gendr_tpu_torch import _build
    lib = _build.load('rasterize_bwd')
    B, NI, Fp = packed.shape
    _, NO = _bwd_layout(cfg, TS)
    T = chunk_ids.shape[2]
    Fs = n_sliced * cfg.face_chunk
    S = bwd_slice_count(B, NO, Fs, T, compacted=Fs < Fp)
    out = torch.empty((B, NO, Fp), dtype=torch.float32, device=packed.device)
    ws = _bwd_workspace(out, S, Fs)
    stream = torch.cuda.current_stream(packed.device)
    slab = ctypes.c_int(0)
    # each slab block's survivors of its cull, where a step is recorded
    survivors = torch.empty((B, T), dtype=torch.int32,
                            device=packed.device) if record else None
    err = lib.gendr_rasterize_bwd(
        chunk_counts.data_ptr(), chunk_ids.data_ptr(), T,
        par.data_ptr(), packed.data_ptr(), perm.data_ptr(), pix.data_ptr(),
        ws.data_ptr(), out.data_ptr(), B, NI, NO, Fp, cfg.face_chunk, S,
        n_sliced, cfg.image_size, row0, height, cfg.dist_func,
        int(cfg.dist_squared),
        cfg.aggr_alpha_func,
        render_mode(cfg), int(cfg.double_side), cfg.texture_type,
        texture_res(TS), packed.device.index or 0,
        stream.cuda_stream, ctypes.addressof(slab),
        0 if survivors is None else survivors.data_ptr())
    if err != 0:
        raise RuntimeError('rasterize_bwd launch failed: '
                           + lib.gendr_error_string(err).decode())
    LAUNCHES['rasterize_bwd'] += 1
    LAUNCHES['rasterize_bwd_slab'] += slab.value
    if record and slab.value:
        profiling.count('compact.slab_survivors', survivors)
    return out


def rasterize_bwd_plain(chunk_counts, chunk_ids, par, packed, perm, pix,
                        cfg: C.RenderConfig, TS=1, row0=0, height=None,
                        n_sliced=None):
    """The backward kernel's function in plain PyTorch, on any device,
    over image rows [row0, row0 + height) (None: all).

    For each chunk, every pixel of a tile on the chunk's hit list meets
    every face of the chunk: the recomputed coverage, the aggregate-inverse
    alpha rule (hard: the incoming gradient unmultiplied, cu:975-976), the
    winner-masked texture gradient for hard RGB or the softmax colour, z and
    texture chain for softmax RGB, the PDF chain and the closest-point
    weights, summed over the pixels: all the band's pixels for the first
    n_sliced chunks (None: all), those of the listed tiles alone for the
    chunks after them (compaction's slabs, a tile each).  Its columns of
    those chunks are the function of ``rasterize_bwd_slab`` too.
    """
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    K = Fp // FC
    is_ = cfg.image_size
    dev = packed.device
    tx = -(-is_ // TILE)
    mode = render_mode(cfg)
    tid = cfg.aggr_alpha_func
    gamma, near, far = par[PM.P_GAMMA], par[PM.P_NEAR], par[PM.P_FAR]
    _, NO = _bwd_layout(cfg, TS)
    t0 = 9 if mode == MODE_SOFTMAX else 6  # first texture row

    height = is_ if height is None else height
    n_sliced = K if n_sliced is None else n_sliced
    hit = _hit(chunk_counts, chunk_ids, _num_tiles(cfg, height))  # [B,K,T]
    idx = torch.arange(height * is_, device=dev)            # band-local
    ptile = (idx // is_ // TILE) * tx + idx % is_ // TILE   # [P]
    xp_all, yp_all = TB.pixel_grid(is_, height, row0, dev)
    tile_pix = _tile_pixels(is_, height, dev)

    out = torch.zeros((B, NO, Fp), dtype=torch.float32, device=dev)
    for k in range(K):
        tiles = hit[:, k] > 0                               # [B, T]
        if not bool(tiles.any()):
            continue
        if k < n_sliced:
            pixels = slice(None)
            on = tiles[:, ptile]                            # [B, P]
        else:
            pixels = _listed_pixels(tiles.any(0), tile_pix)
            on = tiles[:, ptile[pixels]]
        xp, yp = xp_all[pixels], yp_all[pixels]
        pix_k = pix[:, :, pixels]

        def col(i):
            return pix_k[:, i, :, None]                     # [B, P, 1]
        sl = slice(k * FC, (k + 1) * FC)
        pk = packed[:, :, sl]

        def row(i):
            return pk[:, i, None, :]                        # [B, 1, FC]
        q = PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                          cfg, need_depth=mode != MODE_ALPHA)
        valid = q['valid'] & on[..., None]
        frag = q['frag']

        if tid == C.ALPHA_HARD:
            c = col(PIX_GA).expand(frag.shape)
        else:
            c = col(PIX_GA) * TC.aggregate_backward(tid, col(PIX_FA), frag,
                                                    par[PM.P_TCP])
        c = torch.where(valid, c, 0.0)

        tex_coef = None
        if mode != MODE_ALPHA:
            gr = [col(PIX_GR + ch) for ch in range(3)]
        if mode == MODE_HARD:
            oid = perm[:, None, sl]                         # [B, 1, FC]
            win = valid & q['zvalid'] \
                & (col(PIX_WID).to(torch.int32) == oid)
            tex_coef = [torch.where(win, g, 0.0) for g in gr]
        elif mode == MODE_SOFTMAX:
            cm = valid & q['zvalid'] & q['front_ok']
            zn = (far - q['zp']) / (far - near)
            zps = torch.where(cm, frag * torch.exp((zn - col(PIX_SMAX))
                                                   / gamma)
                              / col(PIX_SSUM), 0.0)
            cols = TB._sample_colors(_chunk_textures(pk, cfg, TS), q['wcn'],
                                     cfg)
            cxyz = (gr[0] * (cols[..., 0] - col(PIX_FR + 0))
                    + gr[1] * (cols[..., 1] - col(PIX_FR + 1))
                    + gr[2] * (cols[..., 2] - col(PIX_FR + 2))) * zps
            tex_coef = [zps * g for g in gr]
            c = c + torch.where(cm, cxyz / torch.where(cm, frag, 1.0), 0.0)
            cz = cxyz / gamma / (near - far) * q['zp'] * q['zp']
            for j in range(3):
                iz = pk[:, pack.R_IZ + j, None, :]
                out[:, 6 + j, sl] = torch.where(
                    cm, cz * q['wcn'][j] * (iz * iz), 0.0).sum(1)

        if tex_coef is not None:
            if cfg.texture_type == C.TEXTURE_VERTEX:
                for j in range(3):
                    for ch in range(3):
                        out[:, t0 + 3 * j + ch, sl] = \
                            (q['wcn'][j] * tex_coef[ch]).sum(1)
            elif TS == 1:
                for ch in range(3):
                    out[:, t0 + ch, sl] = tex_coef[ch].sum(1)
            else:
                ti = G.surface_texel_index(q['wcn'], texture_res(TS))
                gt = TB.texel_sums(torch.stack(tex_coef, -1),
                                   ti.expand(frag.shape), TS)
                out[:, t0:t0 + 3 * TS, sl] = gt.permute(0, 2, 3, 1) \
                    .reshape(B, 3 * TS, FC)

        if cfg.dist_func == C.HEAVISIDE:
            continue  # its PDF is 0: no geometry gradient
        pdf_v = D.pdf(cfg.dist_func, q['sign'], q['dis'], par[PM.P_SCALE],
                      par[PM.P_SHAPE], par[PM.P_SHIFT],
                      gamma_inv=par[PM.P_GINV])
        c = torch.where(valid, c * pdf_v, 0.0)
        if cfg.dist_squared:
            coef = 2.0 * q['sign'] * c
        else:
            coef = q['sign'] * c * q['rdis']
        cx = coef * q['dis_x']
        cy = coef * q['dis_y']
        tw = PM.tw_from_ksel(q['ksel'], q['tv'])
        for i in range(3):
            out[:, 2 * i, sl] = (cx * tw[i]).sum(1)
            out[:, 2 * i + 1, sl] = (cy * tw[i]).sum(1)
    return out


def pixel_columns(soft_colors, aggrs_info, grad_soft_colors,
                  cfg: C.RenderConfig, base_offset=0):
    """The backward kernel's pix input [B, NPIX, P] (PIX_*) from the
    row-major [B, 4, H, W] / [B, 2, H, W] image tensors (H a band's height
    for a band).  Hard-RGB winner ids are global (a face shard's input ids
    plus its base_offset): they are shifted back by ``base_offset`` so the
    kernel compares this shard's input ids (pallas_backend.py:1475-1485);
    ids are exact small integers in float32, and a pixel no face of the
    shard won moves to another id outside it."""
    B, _, H, W = soft_colors.shape
    P = H * W
    g = grad_soft_colors.reshape(B, 4, P)
    fin = soft_colors.reshape(B, 4, P)
    ag = aggrs_info.reshape(B, 2, P)
    cols = [g[:, 3:4], fin[:, 3:4]]
    mode = render_mode(cfg)
    if mode == MODE_HARD:
        cols += [g[:, :3], ag[:, 1:2] - float(base_offset)]
    elif mode == MODE_SOFTMAX:
        cols += [g[:, :3], fin[:, :3], ag]
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def unpermute_grads(rows, perm, textures, cfg: C.RenderConfig,
                    oct_ids=None):
    """The kernel's gradient rows [B, NO, Fp] in sorted face order ->
    (grad_face_vertices [B,F,9], grad_textures [B,F,TS,3] or [B,F,3,3]) in
    input order; the z columns are zero but for softmax RGB
    (pallas_backend.py:1546-1580).  With compaction's oct_ids (the
    prepass's), the rows of the appended slots (geometry and texture
    alike) are first folded onto their faces by ``pack.scatter_slots``
    (pallas_backend.py:1549-1553, 1573-1575)."""
    B, F = textures.shape[:2]
    out = rows.transpose(1, 2)                              # [B, Fp, NO]
    if oct_ids is not None:
        Fp = out.shape[1] - oct_ids.shape[1] * pack.OCT
        out = out[:, :Fp] + pack.scatter_slots(out[:, Fp:], oct_ids,
                                               Fp // pack.OCT)
        perm = perm[:, :Fp]
    # the row of sorted slot i belongs to input face perm[i]; padded faces
    # map past F and are dropped
    res = torch.empty_like(out)
    res.scatter_(1, perm.long()[..., None].expand_as(out), out)
    res = res[:, :F]
    mode = render_mode(cfg)
    gxy = res[..., :6].reshape(B, F, 3, 2)
    if mode == MODE_SOFTMAX:
        gz = res[..., 6:9, None]
    else:
        gz = torch.zeros_like(gxy[..., :1])
    grad_faces = torch.cat([gxy, gz], dim=-1).reshape(B, F, 9)
    if mode == MODE_ALPHA:
        grad_tex = torch.zeros_like(textures)
    else:
        t0 = 9 if mode == MODE_SOFTMAX else 6
        grad_tex = res[..., t0:].reshape(textures.shape)
    return grad_faces, grad_tex


def backward_from_aux(face_vertices, textures, aux, soft_colors, aggrs_info,
                      grad_soft_colors, cfg: C.RenderConfig, params: Dict,
                      base_offset=0, fvalid=None, row_band=None):
    """(grad_face_vertices [B,F,9], grad_textures [B,F,TS,3]) through the
    backward kernel, reusing the forward's prepass (aux; None: made here
    with ``fvalid`` and ``row_band``).  For a face shard's band (the
    sharded path) the image tensors hold the band's rows, their winner ids
    are global (``base_offset``), and the sums cover the band alone: the
    caller adds the bands'."""
    TS = textures.shape[2]
    check_envelope(cfg, TS)
    if aux is None:
        aux = prepass(face_vertices, textures, cfg, params, fvalid, row_band,
                      _whole(base_offset, fvalid))
    elif row_band is not None and _band(cfg, row_band) != (aux['row0'],
                                                            aux['height']):
        raise ValueError(f'row band {row_band} is not the prepass\'s '
                         f'({aux["row0"]}, {aux["height"]})')
    pix = pixel_columns(soft_colors, aggrs_info, grad_soft_colors, cfg,
                        base_offset)
    rows = rasterize_bwd(aux['chunk_counts'], aux['chunk_ids'], aux['par'],
                         aux['packed'], aux['perm'], pix, cfg, TS,
                         aux['row0'], aux['height'],
                         sorted_face_count(aux) // cfg.face_chunk)
    return unpermute_grads(rows, aux['perm'], textures, cfg,
                           aux.get('oct_ids'))
