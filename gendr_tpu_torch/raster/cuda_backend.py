"""Render and its gradient through the hand-written CUDA kernels
(``backend='cuda'``).

Port of ``gendr_tpu/raster/pallas_backend.py``:

* the prepass: ``_sorted_faces`` (Morton sort of the faces by projected
  bbox centre, so a chunk of ``face_chunk`` faces is spatially tight), then
  ``pack.pack_faces``, then ``pack.tile_chunk_mask`` + ``compact_hits``
  (each 16x16 pixel tile's list of hit chunks, and each chunk's list of
  hit tiles for the backward);
* the forward kernel, ``csrc/rasterize_fwd.cu``, through
  :func:`rasterize_fwd`;
* the epilogue ``_finalize_soa``: the background fold and the reshape to
  [B, 4, H, W], in plain torch;
* the backward kernel, ``csrc/rasterize_bwd.cu``, through
  :func:`rasterize_bwd`, on the pixel columns :func:`backward` builds from
  the image gradient, then the un-permute to input face order.

:func:`rasterize_fwd_plain` and :func:`rasterize_bwd_plain` are the
kernels' functions in plain PyTorch: same inputs, same outputs.  The
wrappers launch the kernels for CUDA tensors (or raise) and run the plain
versions only for CPU tensors.

The TPU workarounds are gone: no 128-aligned tiling (the kernel masks the
ragged edge tile, so any image size runs), no split of the hit lists
between SMEM and HBM (a block reads its own list row), no per-tile face
compaction yet (ROADMAP.md).  Configurations outside the kernel's envelope
raise ``ValueError``; ``backend='torch'`` renders them.
"""

from __future__ import annotations

from typing import Dict

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.ops import tconorms as TC
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM
from gendr_tpu_torch.raster import torch_backend as TB
from gendr_tpu_torch.raster.torch_backend import BIG_DEPTH, NEG_INF

TILE = 16  # pixel tile edge: one CUDA block of 16x16 threads per tile
DEFERRED_ALPHA = (C.ALPHA_HARD, C.MAX_TCN, C.PROBABILISTIC_TCN,
                  C.EINSTEIN_TCN)
SMEM_LIMIT = 48 * 1024  # static shared-memory budget of one block

# launches of each kernel, counted where the wrapper launches it
LAUNCHES = {'rasterize_fwd': 0, 'rasterize_bwd': 0}
# the backward kernel's block is one thread per face of a chunk
MAX_BWD_CHUNK = 256


def check_envelope(cfg: C.RenderConfig, TS: int):
    """Raise ValueError for a configuration the kernel does not cover yet
    (TS: texels per face), naming the sub-kernel of ROADMAP.md Queue 2
    that will."""
    if cfg.aggr_alpha_func not in DEFERRED_ALPHA:
        raise ValueError(
            f'backend="cuda" covers the alpha families hard, max, '
            f'probabilistic and einstein; aggr_alpha_func id '
            f'{cfg.aggr_alpha_func} is a parametric fold (sub-kernel K1c, '
            f'not ported yet): use backend="torch"')
    if cfg.channels == 'alpha':
        return
    if cfg.aggr_rgb_func != C.RGB_HARD:
        raise ValueError(
            'backend="cuda" covers hard RGB and channels="alpha"; softmax '
            'RGB is sub-kernel K1b (not ported yet): use backend="torch"')
    if cfg.texture_type != C.TEXTURE_SURFACE:
        raise ValueError(
            'backend="cuda" covers one-texel surface textures; vertex '
            'textures are sub-kernel K1b (not ported yet): use '
            'backend="torch"')
    if TS != 1:
        raise ValueError(
            f'backend="cuda" covers one-texel surface textures; '
            f'TS={TS} texels per face is sub-kernel K1b/K1d '
            f'(not ported yet): use backend="torch"')


def _spread(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _sorted_faces(face_vertices, textures, FC):
    """Pad to a chunk multiple and Morton-sort faces by projected bbox
    centre (tight chunk bboxes make the tile x chunk cull selective).

    Returns (fv, tex, fvalid, perm) with sorted[i] = input[perm[i]]; padded
    faces sort to the end with fvalid False.  The sort is stable, as JAX's
    argsort is, so the order is a function of the inputs alone.
    """
    fv, tex, fvalid, _, _ = TB._pad_faces(face_vertices, textures, FC)
    xs = fv[..., 0::3]
    ys = fv[..., 1::3]
    cx = 0.5 * (xs.amin(-1) + xs.amax(-1))
    cy = 0.5 * (ys.amin(-1) + ys.amax(-1))
    qx = torch.clamp((cx + 1.0) * 512.0, 0, 1023).to(torch.int32)
    qy = torch.clamp((cy + 1.0) * 512.0, 0, 1023).to(torch.int32)
    key = _spread(qx) | (_spread(qy) << 1)
    key = torch.where(fvalid[None, :], key, 0x7FFFFFFF)
    perm = torch.argsort(key, dim=1, stable=True)  # [B, Fp]

    bidx = torch.arange(fv.shape[0], device=fv.device)[:, None]
    return fv[bidx, perm], tex[bidx, perm], fvalid[perm], perm


def prepass(face_vertices, textures, cfg: C.RenderConfig, params: Dict):
    """Sort, pack and build the hit lists: the kernels' inputs (per tile
    its hit chunks for the forward, per chunk its hit tiles for the
    backward)."""
    FC = cfg.face_chunk
    fv, tex, fvalid, perm = _sorted_faces(face_vertices, textures, FC)
    packed = pack.pack_faces(fv, tex, fvalid, cfg,
                             with_tex=cfg.channels != 'alpha')
    margin = pack.cull_margin(cfg, params).to(packed.device)
    mask = pack.tile_chunk_mask(packed, cfg.image_size, TILE, TILE, FC,
                                margin)
    tile_counts, tile_ids, chunk_counts, chunk_ids = pack.compact_hits(mask)
    return dict(packed=packed, perm=perm.to(torch.int32),
                tile_counts=tile_counts, tile_ids=tile_ids,
                chunk_counts=chunk_counts,
                chunk_ids=chunk_ids.contiguous(),
                par=PM._params_vec(params, cfg, packed.device))


def _check_tensors(dev, *named):
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f'{name} is on {x.device}, packed on {dev}')
        if x.dtype != dt:
            raise ValueError(f'{name} must be {dt}, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _check_inputs(tile_counts, tile_ids, par, packed, perm, cfg):
    _check_tensors(packed.device,
                   ('tile_counts', tile_counts, torch.int32),
                   ('tile_ids', tile_ids, torch.int32),
                   ('par', par, torch.float32),
                   ('packed', packed, torch.float32),
                   ('perm', perm, torch.int32))
    B, NI, Fp = packed.shape
    tx = -(-cfg.image_size // TILE)
    T = tx * tx
    if Fp % cfg.face_chunk:
        raise ValueError(f'packed face count {Fp} is not a multiple of '
                         f'face_chunk {cfg.face_chunk}')
    if tuple(tile_counts.shape) != (B, T) or tile_ids.shape[:2] != (B, T):
        raise ValueError(f'hit lists must be [B={B}, T={T}, ...], got '
                         f'{tuple(tile_counts.shape)} and '
                         f'{tuple(tile_ids.shape)}')
    if tuple(perm.shape) != (B, Fp) or tuple(par.shape) != (PM.NPAR,):
        raise ValueError(f'perm must be [{B}, {Fp}] and par [{PM.NPAR}]')
    # alpha-only reads the geometry rows; hard RGB also the one-texel colour
    if NI != (pack.NI_BASE if cfg.channels == 'alpha' else pack.NI):
        raise ValueError(f'packed has {NI} rows, not the layout the kernel '
                         f'reads for channels={cfg.channels!r}')
    if (NI + 1) * cfg.face_chunk * 4 > SMEM_LIMIT:
        raise ValueError(f'face_chunk {cfg.face_chunk} x {NI} rows exceeds '
                         f'the {SMEM_LIMIT}-byte shared-memory stage')


def rasterize_fwd(tile_counts, tile_ids, par, packed, perm,
                  cfg: C.RenderConfig):
    """The forward kernel: [B, NO, P] float32, NO = 6 (alpha, depth,
    winner input id, r, g, b) for hard RGB or 1 (alpha) for channels
    'alpha', in row-major pixel order.

    CUDA tensors launch ``csrc/rasterize_fwd.cu`` on the current stream;
    CPU tensors run :func:`rasterize_fwd_plain`.
    """
    _check_inputs(tile_counts, tile_ids, par, packed, perm, cfg)
    check_envelope(cfg, TS=1)  # the row count above admits one texel
    if packed.device.type == 'cpu':
        return rasterize_fwd_plain(tile_counts, tile_ids, par, packed, perm,
                                   cfg)
    if packed.device.type != 'cuda':
        raise ValueError(f'no forward kernel for device {packed.device}')

    from gendr_tpu_torch import _build
    lib = _build.load('rasterize_fwd')
    B, NI, Fp = packed.shape
    hard_rgb = cfg.channels != 'alpha'
    P = cfg.image_size * cfg.image_size
    out = torch.empty((B, 6 if hard_rgb else 1, P), dtype=torch.float32,
                      device=packed.device)
    stream = torch.cuda.current_stream(packed.device)
    err = lib.gendr_rasterize_fwd(
        tile_counts.data_ptr(), tile_ids.data_ptr(), tile_ids.shape[2],
        par.data_ptr(), packed.data_ptr(), perm.data_ptr(), out.data_ptr(),
        B, NI, Fp, cfg.face_chunk, cfg.image_size, cfg.dist_func,
        int(cfg.dist_squared), cfg.aggr_alpha_func, int(hard_rgb),
        int(cfg.double_side), packed.device.index or 0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError('rasterize_fwd launch failed: '
                           + lib.gendr_error_string(err).decode())
    LAUNCHES['rasterize_fwd'] += 1
    return out


def rasterize_fwd_plain(tile_counts, tile_ids, par, packed, perm,
                        cfg: C.RenderConfig):
    """The kernel's function in plain PyTorch, on any device.

    A pixel folds the chunks its tile lists, in ascending chunk order, and
    within a chunk the faces in ascending sorted order, as a kernel thread
    does; the probabilistic and einstein folds run face by face in that
    order.  Hard-RGB ties on the depth key go to the smaller input face id.
    """
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    K = Fp // FC
    is_ = cfg.image_size
    dev = packed.device
    tx = -(-is_ // TILE)
    T = tx * tx
    hard_rgb = cfg.channels != 'alpha'
    tid = cfg.aggr_alpha_func

    # hit[b, t, k]: chunk k is on tile t's list
    kcap = tile_ids.shape[2]
    listed = (torch.arange(kcap, device=dev)[None, None, :]
              < tile_counts[..., None]).to(torch.int32)
    hit = torch.zeros((B, T, K), dtype=torch.int32, device=dev)
    hit.scatter_add_(2, tile_ids.long(), listed)

    idx = torch.arange(is_ * is_, device=dev)
    ptile = (idx // is_ // TILE) * tx + idx % is_ // TILE   # [P]
    xp, yp = TB.pixel_grid(is_, dev)

    P = is_ * is_
    acc = torch.full((B, P), 1.0 if tid == C.PROBABILISTIC_TCN else 0.0,
                     device=dev)
    best = torch.full((B, P), NEG_INF, device=dev)
    best_id = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    rgb = torch.zeros((B, 3, P), device=dev)
    big_id = torch.iinfo(torch.int32).max

    for k in range(K):
        on = hit[:, ptile, k] > 0                           # [B, P]
        if not bool(on.any()):
            continue
        pk = packed[:, :, k * FC:(k + 1) * FC]

        def row(i):
            return pk[:, i, None, :]                        # [B, 1, FC]
        q = PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                          cfg, need_wcn=False, fwd_only=True,
                          need_depth=hard_rgb)
        valid = q['valid'] & on[..., None]
        frag = torch.where(valid, q['frag'], 0.0)

        if tid == C.ALPHA_HARD:
            acc = torch.where((frag > 0.5).any(-1), 1.0, acc)
        elif tid == C.MAX_TCN:
            acc = torch.maximum(acc, frag.amax(-1))
        elif tid == C.PROBABILISTIC_TCN:
            for f in range(FC):
                acc = acc * (1.0 - frag[..., f])
        else:
            for f in range(FC):
                acc = (acc + frag[..., f]) / (1.0 + acc * frag[..., f])

        if hard_rgb:
            hmask = valid & q['zvalid'] & q['in_loose'] & q['front_ok']
            dm = torch.where(hmask, q['denom'], NEG_INF)     # [B, P, FC]
            dmax = dm.amax(-1)
            oid = perm[:, None, k * FC:(k + 1) * FC]          # [B, 1, FC]
            tie = hmask & (dm == dmax[..., None])
            oid_sel = torch.where(tie, oid, big_id).amin(-1)
            better = (dmax > best) | ((dmax == best) & (oid_sel < best_id))
            pos = (tie & (oid == oid_sel[..., None])).to(torch.int32) \
                .argmax(-1)                                   # [B, P]
            col = pk[:, pack.R_TEX:pack.R_TEX + 3]            # [B, 3, FC]
            col = torch.gather(col, 2, pos[:, None, :].expand(B, 3, P))
            best = torch.where(better, dmax, best)
            best_id = torch.where(better, oid_sel, best_id)
            rgb = torch.where(better[:, None, :], col, rgb)

    alpha = 1.0 - acc if tid == C.PROBABILISTIC_TCN else acc
    if not hard_rgb:
        return alpha[:, None, :]
    has = best > NEG_INF
    depth = torch.where(has, 1.0 / best, BIG_DEPTH)
    fidx = torch.where(has, best_id.to(torch.float32), -1.0)
    return torch.cat([alpha[:, None], depth[:, None], fidx[:, None], rgb],
                     dim=1)


def _finalize_soa(out, cfg: C.RenderConfig, params: Dict):
    """Background fold + finalize on the channel-major kernel output
    ([B, NO, P]): (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]), the
    torch backend's contract."""
    B, _, P = out.shape
    is_ = cfg.image_size
    bg = params['background_color'].to(out.device).reshape(1, 3, 1)
    alpha = out[:, 0:1]
    if cfg.channels == 'alpha':
        rgb_final = bg.expand(B, 3, P)
        aggr0 = torch.full((B, 1, P), BIG_DEPTH, device=out.device)
        aggr1 = torch.full((B, 1, P), -1.0, device=out.device)
    else:
        aggr0, aggr1 = out[:, 1:2], out[:, 2:3]
        rgb_final = torch.where(aggr1 >= 0, out[:, 3:6], bg)
    soft_colors = torch.cat([rgb_final, alpha], dim=1).reshape(B, 4, is_, is_)
    aggrs_info = torch.cat([aggr0, aggr1], dim=1).reshape(B, 2, is_, is_)
    return soft_colors, aggrs_info


def forward_with_aux(face_vertices, textures, cfg: C.RenderConfig,
                     params: Dict):
    """Same contract as torch_backend.forward, plus the prepass products
    (sorted, packed faces and both hit lists) as the backward's aux;
    winner ids in aggrs_info are input face ids."""
    check_envelope(cfg, textures.shape[2])
    aux = prepass(face_vertices, textures, cfg, params)
    out = rasterize_fwd(aux['tile_counts'], aux['tile_ids'], aux['par'],
                        aux['packed'], aux['perm'], cfg)
    soft_colors, aggrs_info = _finalize_soa(out, cfg, params)
    return soft_colors, aggrs_info, aux


def forward(face_vertices, textures, cfg: C.RenderConfig, params: Dict):
    """Same contract as torch_backend.forward; winner ids in aggrs_info are
    input face ids."""
    soft_colors, aggrs_info, _ = forward_with_aux(face_vertices, textures,
                                                  cfg, params)
    return soft_colors, aggrs_info


# pixel columns of the backward kernel, rows of its [B, NPIX, P] input:
# the alpha gradient and the final alpha, then for hard RGB the colour
# gradient and the winner's input face id
PIX_GA, PIX_FA, PIX_GR, PIX_WID = 0, 1, 2, 5


def _bwd_layout(cfg: C.RenderConfig):
    """(NPIX, NO): pixel columns read and gradient rows written by the
    backward kernel.  Rows are [x0 y0 x1 y1 x2 y2] (+ [r g b] of the one
    texel for hard RGB); the z gradients are zero outside softmax RGB."""
    hard_rgb = cfg.channels != 'alpha'
    return (6, 9) if hard_rgb else (2, 6)


def _check_bwd_inputs(chunk_counts, chunk_ids, par, packed, perm, pix, cfg):
    _check_tensors(packed.device,
                   ('chunk_counts', chunk_counts, torch.int32),
                   ('chunk_ids', chunk_ids, torch.int32),
                   ('par', par, torch.float32),
                   ('packed', packed, torch.float32),
                   ('perm', perm, torch.int32),
                   ('pix', pix, torch.float32))
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    tx = -(-cfg.image_size // TILE)
    T = tx * tx
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
    if tuple(perm.shape) != (B, Fp) or tuple(par.shape) != (PM.NPAR,):
        raise ValueError(f'perm must be [{B}, {Fp}] and par [{PM.NPAR}]')
    if NI < pack.NI_BASE:
        raise ValueError(f'packed has {NI} rows, fewer than the '
                         f'{pack.NI_BASE} geometry rows')
    npix, _ = _bwd_layout(cfg)
    P = cfg.image_size * cfg.image_size
    if tuple(pix.shape) != (B, npix, P):
        raise ValueError(f'pix must be [{B}, {npix}, {P}] for '
                         f'channels={cfg.channels!r}, got '
                         f'{tuple(pix.shape)}')


def rasterize_bwd(chunk_counts, chunk_ids, par, packed, perm, pix,
                  cfg: C.RenderConfig):
    """The backward kernel: per-face gradient rows [B, NO, Fp] float32 in
    sorted face order (see _bwd_layout), from the pixel columns pix
    [B, NPIX, P] (PIX_*) in row-major pixel order.

    CUDA tensors launch ``csrc/rasterize_bwd.cu`` on the current stream;
    CPU tensors run :func:`rasterize_bwd_plain`.
    """
    _check_bwd_inputs(chunk_counts, chunk_ids, par, packed, perm, pix, cfg)
    check_envelope(cfg, TS=1)
    if packed.device.type == 'cpu':
        return rasterize_bwd_plain(chunk_counts, chunk_ids, par, packed,
                                   perm, pix, cfg)
    if packed.device.type != 'cuda':
        raise ValueError(f'no backward kernel for device {packed.device}')

    from gendr_tpu_torch import _build
    lib = _build.load('rasterize_bwd')
    B, NI, Fp = packed.shape
    hard_rgb = cfg.channels != 'alpha'
    _, NO = _bwd_layout(cfg)
    out = torch.empty((B, NO, Fp), dtype=torch.float32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device)
    err = lib.gendr_rasterize_bwd(
        chunk_counts.data_ptr(), chunk_ids.data_ptr(), chunk_ids.shape[2],
        par.data_ptr(), packed.data_ptr(), perm.data_ptr(), pix.data_ptr(),
        out.data_ptr(), B, NI, Fp, cfg.face_chunk, cfg.image_size,
        cfg.dist_func, int(cfg.dist_squared), cfg.aggr_alpha_func,
        int(hard_rgb), packed.device.index or 0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError('rasterize_bwd launch failed: '
                           + lib.gendr_error_string(err).decode())
    LAUNCHES['rasterize_bwd'] += 1
    return out


def rasterize_bwd_plain(chunk_counts, chunk_ids, par, packed, perm, pix,
                        cfg: C.RenderConfig):
    """The backward kernel's function in plain PyTorch, on any device.

    For each chunk, every pixel of a tile on the chunk's hit list meets
    every face of the chunk: the recomputed coverage, the aggregate-inverse
    alpha rule (hard: the incoming gradient unmultiplied, cu:975-976), the
    winner-masked texel gradient for hard RGB, the PDF chain and the
    closest-point weights, summed over the pixels.
    """
    B, NI, Fp = packed.shape
    FC = cfg.face_chunk
    K = Fp // FC
    is_ = cfg.image_size
    dev = packed.device
    tx = -(-is_ // TILE)
    T = tx * tx
    hard_rgb = cfg.channels != 'alpha'
    tid = cfg.aggr_alpha_func
    _, NO = _bwd_layout(cfg)

    # hit[b, k, t]: tile t is on chunk k's list
    listed = (torch.arange(T, device=dev)[None, None, :]
              < chunk_counts[..., None]).to(torch.int32)
    hit = torch.zeros((B, K, T), dtype=torch.int32, device=dev)
    hit.scatter_add_(2, chunk_ids.long(), listed)

    idx = torch.arange(is_ * is_, device=dev)
    ptile = (idx // is_ // TILE) * tx + idx % is_ // TILE   # [P]
    xp, yp = TB.pixel_grid(is_, dev)
    ga = pix[:, PIX_GA, :, None]                            # [B, P, 1]
    fa = pix[:, PIX_FA, :, None]

    out = torch.zeros((B, NO, Fp), dtype=torch.float32, device=dev)
    for k in range(K):
        on = hit[:, k, ptile] > 0                           # [B, P]
        if not bool(on.any()):
            continue
        pk = packed[:, :, k * FC:(k + 1) * FC]

        def row(i):
            return pk[:, i, None, :]                        # [B, 1, FC]
        q = PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                          cfg, need_wcn=False, need_depth=hard_rgb)
        valid = q['valid'] & on[..., None]
        frag = q['frag']

        if tid == C.ALPHA_HARD:
            c = ga.expand(frag.shape)
        else:
            c = ga * TC.aggregate_backward(tid, fa, frag, par[PM.P_TCP])
        c = torch.where(valid, c, 0.0)

        if hard_rgb:
            oid = perm[:, None, k * FC:(k + 1) * FC]        # [B, 1, FC]
            win = valid & q['zvalid'] \
                & (pix[:, PIX_WID, :, None].to(torch.int32) == oid)
            for ch in range(3):
                gr = pix[:, PIX_GR + ch, :, None]
                out[:, 6 + ch, k * FC:(k + 1) * FC] = \
                    torch.where(win, gr, 0.0).sum(1)

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
            out[:, 2 * i, k * FC:(k + 1) * FC] = (cx * tw[i]).sum(1)
            out[:, 2 * i + 1, k * FC:(k + 1) * FC] = (cy * tw[i]).sum(1)
    return out


def pixel_columns(soft_colors, aggrs_info, grad_soft_colors,
                  cfg: C.RenderConfig):
    """The backward kernel's pix input [B, NPIX, P] (PIX_*) from the
    row-major [B, 4, H, W] / [B, 2, H, W] image tensors."""
    B = soft_colors.shape[0]
    P = cfg.image_size * cfg.image_size
    g = grad_soft_colors.reshape(B, 4, P)
    cols = [g[:, 3:4], soft_colors.reshape(B, 4, P)[:, 3:4]]
    if cfg.channels != 'alpha':
        cols += [g[:, :3], aggrs_info.reshape(B, 2, P)[:, 1:2]]
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def unpermute_grads(rows, perm, textures, cfg: C.RenderConfig):
    """The kernel's gradient rows [B, NO, Fp] in sorted face order ->
    (grad_face_vertices [B,F,9], grad_textures [B,F,TS,3]) in input order,
    with zero z columns (pallas_backend.py:1546-1580)."""
    B, F = textures.shape[:2]
    # the row of sorted slot i belongs to input face perm[i]; padded faces
    # map past F and are dropped
    out = rows.transpose(1, 2)                              # [B, Fp, NO]
    res = torch.empty_like(out)
    res.scatter_(1, perm.long()[..., None].expand_as(out), out)
    res = res[:, :F]
    gxy = res[..., :6].reshape(B, F, 3, 2)
    grad_faces = torch.cat([gxy, torch.zeros_like(gxy[..., :1])],
                           dim=-1).reshape(B, F, 9)
    if cfg.channels == 'alpha':
        grad_tex = torch.zeros_like(textures)
    else:
        grad_tex = res[..., 6:9].reshape(B, F, 1, 3)
    return grad_faces, grad_tex


def backward_from_aux(face_vertices, textures, aux, soft_colors, aggrs_info,
                      grad_soft_colors, cfg: C.RenderConfig, params: Dict):
    """(grad_face_vertices [B,F,9], grad_textures [B,F,TS,3]) through the
    backward kernel, reusing the forward's prepass (aux)."""
    check_envelope(cfg, textures.shape[2])
    pix = pixel_columns(soft_colors, aggrs_info, grad_soft_colors, cfg)
    rows = rasterize_bwd(aux['chunk_counts'], aux['chunk_ids'], aux['par'],
                         aux['packed'], aux['perm'], pix, cfg)
    return unpermute_grads(rows, aux['perm'], textures, cfg)
