"""Per-face constant packing and the tile x chunk cull (the prepass).

Port of ``gendr_tpu/raster/pack.py``.  Every per-pair quantity that is
*affine in the pixel coordinate* is folded into per-face constants once,
so the per-pair loop does two FMAs per affine value:

  w_i(x, y)    = inv[3i]x + inv[3i+1]y + inv[3i+2]          (cu:38-43)
  tv_k(x, y)   = tA_k x + tB_k y + tC_k        (a0, den from the Gram matrix)

and two exact identities collapse the rest of the distance algebra
(cu:75-165): the unclamped squared edge distance is d2u_k = w_j^2 |m_k|^2
(j the vertex opposite edge k), and clamping the edge parameter adds
(clip(tv)-tv)^2 |e_k|^2.  For hard RGB the z-argmin key 1/zp = w . iz is
affine too (dz rows).

Row layout of the packed tensor (shape [B, NI, F'], structure of arrays):

   0: xmin   1: xmax   2: ymin   3: ymax          (bbox, pre-margin)
   4-12:  inv (row-major 3x3)
  13-21:  tA0 tB0 tC0 tA1 tB1 tC1 tA2 tB2 tC2
  22-27:  ex_k ey_k for k=0,1,2       (edge-k vector = vertex k - vertex k+1)
  28-30:  |e_k|^2
  31-36:  mx_k my_k                   (u = w_j * m_k, j = (k+2)%3)
  37-39:  |m_k|^2
  40:     frontside flag
  41-43:  iz0 iz1 iz2                 (reciprocal vertex depths)
  44:     fvalid
  45-47:  dzA dzB dzC                 (denom = w . iz as an affine)
  48-..:  tex RGB (surface: 3*TS texel rows) | vertex colors (3x3)

The CUDA kernel reads the same rows by the same indices (the ``R_*``
constants are repeated in ``csrc/rasterize_fwd.cu``).
"""

from __future__ import annotations

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops.segments import segment_sum, segments

NI_BASE = 48

# Surface texture sizes above TEXEL_UNROLL_CAP pad their texel rows to a
# TEXEL_BLOCK multiple (the JAX kernels stream texel blocks; the layout is
# kept so the two packages' packed arrays stay comparable row for row).
TEXEL_UNROLL_CAP = 36
TEXEL_BLOCK = 8


def num_rows(texture_type, TS, with_tex=True):
    """Packed row count for a texture configuration (8-aligned).

    Surface textures contribute 3*TS texel-color rows (48..); vertex
    textures contribute 9 rows.  with_tex=False packs geometry rows only.
    """
    if not with_tex:
        return NI_BASE
    if texture_type == C.TEXTURE_VERTEX:
        tex_rows = 9
    elif TS > TEXEL_UNROLL_CAP:
        tex_rows = 3 * (-(-TS // TEXEL_BLOCK) * TEXEL_BLOCK)
    else:
        tex_rows = 3 * TS
    n = NI_BASE + tex_rows
    return -(-n // 8) * 8


# minimal layout (TS=1 surface)
NI = 56

# row indices (see module docstring)
R_BBOX = 0
R_INV = 4
R_TV = 13
R_E = 22
R_E2 = 28
R_M = 31
R_MM = 37
R_FRONT = 40
R_IZ = 41
R_FVALID = 44
R_DZ = 45
R_TEX = 48


def pack_faces(face_vertices, textures, fvalid, cfg: C.RenderConfig,
               with_tex=True):
    """face_vertices: [B, F', 9]; textures: [B, F', TS, 3]; fvalid: [F'] or
    [B, F'] bool.  Returns [B, num_rows(...), F'] float32."""
    f = face_vertices
    B, Fp = f.shape[:2]
    TS = textures.shape[2]
    NI = num_rows(cfg.texture_type, TS, with_tex)
    x0, y0, z0 = f[..., 0], f[..., 1], f[..., 2]
    x1, y1, z1 = f[..., 3], f[..., 4], f[..., 5]
    x2, y2, z2 = f[..., 6], f[..., 7], f[..., 8]

    rows = [None] * NI

    rows[R_BBOX + 0] = torch.minimum(torch.minimum(x0, x1), x2)
    rows[R_BBOX + 1] = torch.maximum(torch.maximum(x0, x1), x2)
    rows[R_BBOX + 2] = torch.minimum(torch.minimum(y0, y1), y2)
    rows[R_BBOX + 3] = torch.maximum(torch.maximum(y0, y1), y2)

    # barycentric inverse (determinant clamp of cu:645-657)
    inv_star = [
        y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
        y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
        y0 - y1, x1 - x0, x0 * y1 - x1 * y0,
    ]
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    det = torch.where(det > 0, torch.clamp(det, min=C.DET_EPS),
                      torch.clamp(det, max=-C.DET_EPS))
    inv = [s / det for s in inv_star]
    for i in range(9):
        rows[R_INV + i] = inv[i]

    # Gram matrix rows (cu:659-665) -> per-edge affine tv coefficients
    xs = (x0, x1, x2)
    ys = (y0, y1, y2)
    zs = (z0, z1, z2)
    sym = [[xs[j] * xs[k] + ys[j] * ys[k] + 1.0 for k in range(3)]
           for j in range(3)]
    for k in range(3):
        v0, v1 = k, (k + 1) % 3
        a0 = [sym[v0][i] - sym[v1][i] for i in range(3)]
        den = a0[v0] - a0[v1]
        den = torch.where(den.abs() < 1e-20,
                          torch.where(den < 0, -1e-20, 1e-20), den)
        tA = (inv[0] * a0[0] + inv[3] * a0[1] + inv[6] * a0[2]) / den
        tB = (inv[1] * a0[0] + inv[4] * a0[1] + inv[7] * a0[2]) / den
        tC = (inv[2] * a0[0] + inv[5] * a0[1] + inv[8] * a0[2]
              - a0[v1]) / den
        rows[R_TV + 3 * k + 0] = tA
        rows[R_TV + 3 * k + 1] = tB
        rows[R_TV + 3 * k + 2] = tC
        ex = xs[v0] - xs[v1]
        ey = ys[v0] - ys[v1]
        rows[R_E + 2 * k + 0] = ex
        rows[R_E + 2 * k + 1] = ey
        e2 = ex * ex + ey * ey
        rows[R_E2 + k] = e2
        # m_k = det / |e_k|^2 * (-ey_k, ex_k): the closed form is far better
        # conditioned for thin triangles than the tv/inv chain
        c_over_e2 = det / torch.clamp(e2, min=1e-20)
        mx = -ey * c_over_e2
        my = ex * c_over_e2
        rows[R_M + 2 * k + 0] = mx
        rows[R_M + 2 * k + 1] = my
        rows[R_MM + k] = mx * mx + my * my

    # Point-degenerate faces (all three projected vertices coincide) have
    # no edge direction: every packed distance term is 0, so without a cull
    # they would cover every pixel with frag = CDF(0).  Mask them out.
    point_degenerate = (rows[R_E2 + 0] + rows[R_E2 + 1]
                        + rows[R_E2 + 2]) <= 0.0

    # frontside (cu:55-58)
    rows[R_FRONT] = ((y2 - y0) * (x1 - x0)
                     < (y1 - y0) * (x2 - x0)).to(torch.float32)

    iz = [1.0 / z for z in zs]
    for i in range(3):
        rows[R_IZ + i] = iz[i]
    # hard-RGB depth key as an affine: denom(p) = sum_i w_i(p) iz_i
    for c in range(3):
        rows[R_DZ + c] = (inv[0 + c] * iz[0] + inv[3 + c] * iz[1]
                          + inv[6 + c] * iz[2])

    fval_f = fvalid.to(torch.float32)
    if fval_f.ndim == 1:
        fval_f = fval_f[None, :]
    rows[R_FVALID] = fval_f.expand(B, Fp) \
        * torch.where(point_degenerate, 0.0, 1.0)

    zero = torch.zeros((B, Fp), dtype=torch.float32, device=f.device)
    geom = torch.stack([zero if r is None else r for r in rows[:NI_BASE]],
                       dim=1)
    if not with_tex:
        return geom
    # texture rows: texel (or vertex) t, channel c at row R_TEX + 3 t + c,
    # in one permute, then zeros up to the padded row count
    n = 3 if cfg.texture_type == C.TEXTURE_VERTEX else TS
    tex_rows = textures[:, :, :n].to(torch.float32).permute(0, 2, 3, 1) \
        .reshape(B, 3 * n, Fp)
    pad = geom.new_zeros((B, NI - NI_BASE - 3 * n, Fp))
    return torch.cat([geom, tex_rows, pad], dim=1)


def cull_margin(cfg, params):
    """Semantically exact tile-cull distance.

    A (pixel, face) pair with coverage <= PROBABILITY_THRESHOLD is skipped
    by the reference for both alpha and RGB (cu:784-786), so any outside
    pixel farther than r_prob — where CDF(-r_prob/tau) == 1e-6 — can be
    culled without changing the result.  Combined with the reference's own
    dist_eps cutoff sqrt(dist_eps * tau) (cu:747), the margin is the min of
    the two.  Heavy-tailed CDFs (cauchy, reciprocal, levy) have no useful
    probability radius; heaviside is exactly its bbox.
    """
    tau = params['dist_scale']
    thr_margin = torch.sqrt(params['dist_eps'] * tau)
    # u such that CDF(-u) <= 1e-6 (conservative constants)
    U = {
        C.HEAVISIDE: 0.0,
        C.UNIFORM: 1.0,
        C.CUBIC_HERMITE: 1.0,
        C.WIGNER_SEMICIRCLE: 1.0,
        C.GAUSSIAN: 4.80,
        C.LAPLACE: 13.2,
        C.LOGISTIC: 13.9,
        C.GUDERMANNIAN: 14.5,
        C.GUMBEL_MAX: 2.7,
        C.GUMBEL_MIN: 13.9,
    }
    shift = params['dist_shift'].abs()
    if cfg.dist_func in (C.EXPONENTIAL, C.EXPONENTIAL_REV):
        u = 13.9 + shift
    elif cfg.dist_func in (C.GAMMA, C.GAMMA_REV):
        # exact: saturates at GAMMA_THRESHOLD (cu:304-308)
        u = C.GAMMA_THRESHOLD + shift
    elif cfg.dist_func in U:
        u = U[cfg.dist_func]
    else:  # heavy tails: only the dist_eps cutoff applies
        return thr_margin
    r = u * tau
    if cfg.dist_squared:
        # with dist_squared the CDF input is dis^2 (cu:770-772)
        r = torch.sqrt(u * tau)
    return torch.minimum(thr_margin, r)


def _tile_rects(image_size, tile_w, tile_h, height=None, row0=0,
                device=None):
    """NDC rectangles of the pixel tiles of the band of image rows [row0,
    row0 + height) ([T] each of xmin, xmax, ymin, ymax): tiles numbered
    row-major over a ceil(width / tile_w) x ceil(height / tile_h) grid, a
    ragged edge tile's rectangle the full tile's (it only over-covers).
    For sizes the tile divides, ``gendr_tpu``'s ``_tile_rects``
    (pack.py:419-435) exactly."""
    is_ = image_size
    height = is_ if height is None else height
    tx_n = -(-is_ // tile_w)
    ty_n = -(-height // tile_h)
    t_idx = torch.arange(tx_n * ty_n, device=device)
    ty, tx = t_idx // tx_n, t_idx % tx_n
    c0 = tx * tile_w
    r0 = row0 + ty * tile_h
    tx_min = (2.0 * c0 + 1.0 - is_) / is_
    tx_max = (2.0 * (c0 + tile_w - 1) + 1.0 - is_) / is_
    # y decreases with row index (vertical flip, cu:716-719)
    ty_max = (2.0 * (is_ - 1 - r0) + 1.0 - is_) / is_
    ty_min = (2.0 * (is_ - 1 - (r0 + tile_h - 1)) + 1.0 - is_) / is_
    return tx_min, tx_max, ty_min, ty_max


def tile_chunk_mask(packed, image_size, tile_w, tile_h, face_chunk, margin,
                    height=None, row0=0):
    """[B, T, K] int32 mask: does face-chunk k (bbox union + margin) overlap
    2D pixel tile t?  The replacement for the reference's per-thread
    early-exit culls (cu:747, 769, 784).

    ``height``/``row0`` restrict the tiles to the band of image rows
    [row0, row0 + height) (the pixel-sharded path); NDC stays global, as in
    ``gendr_tpu``'s ``_tile_rects`` (pack.py:419-435).  Tiles are numbered
    row-major over a ceil(width / tile_w) x ceil(height / tile_h) grid, so
    a size that the tile does not divide gets ragged edge tiles; their NDC
    rectangle is the full tile's, which only over-covers (a conservative
    cull), and the kernel masks the pixels that lie outside the image or
    the band.  For sizes the tile divides this is ``gendr_tpu``'s mask
    exactly."""
    B = packed.shape[0]
    Fp = packed.shape[2]
    K = Fp // face_chunk
    is_ = image_size
    dev = packed.device

    xmin = packed[:, R_BBOX + 0].reshape(B, K, face_chunk)
    xmax = packed[:, R_BBOX + 1].reshape(B, K, face_chunk)
    ymin = packed[:, R_BBOX + 2].reshape(B, K, face_chunk)
    ymax = packed[:, R_BBOX + 3].reshape(B, K, face_chunk)
    fval = packed[:, R_FVALID].reshape(B, K, face_chunk) > 0
    big = 1e30
    cxmin = torch.where(fval, xmin, big).amin(-1)   # [B, K]
    cxmax = torch.where(fval, xmax, -big).amax(-1)
    cymin = torch.where(fval, ymin, big).amin(-1)
    cymax = torch.where(fval, ymax, -big).amax(-1)

    tx_min, tx_max, ty_min, ty_max = _tile_rects(is_, tile_w, tile_h,
                                                 height, row0, dev)
    ov_x = (tx_min[None, :, None] <= cxmax[:, None, :] + margin) & \
           (tx_max[None, :, None] >= cxmin[:, None, :] - margin)
    ov_y = (ty_min[None, :, None] <= cymax[:, None, :] + margin) & \
           (ty_max[None, :, None] >= cymin[:, None, :] - margin)
    return (ov_x & ov_y).to(torch.int32)  # [B, T, K]


def compact_hits(mask):
    """Compact the [B, T, K] overlap mask into iteration lists.

    Returns (tile_counts [B,T], tile_ids [B,T,K]) listing hit chunk ids per
    tile in ascending order, and (chunk_counts [B,K], chunk_ids [B,K,T])
    listing hit tile ids per chunk (the backward's lists).
    """
    hit = mask > 0
    # ascending ids first: stable argsort of (1 - hit)
    tile_ids = torch.argsort(1 - mask, dim=2, stable=True).to(torch.int32)
    tile_counts = hit.sum(2).to(torch.int32)
    chunk_ids = torch.argsort(1 - mask, dim=1, stable=True)
    chunk_ids = chunk_ids.transpose(1, 2).to(torch.int32)  # [B, K, T]
    chunk_counts = hit.sum(1).to(torch.int32)
    return tile_counts, tile_ids, chunk_counts, chunk_ids


# ---------------------------------------------------------------------------
# Per-tile face compaction (octet-granular), gendr_tpu/raster/pack.py:412-610
# ---------------------------------------------------------------------------

OCT = 8          # compaction granule: 8 Morton-consecutive faces
OCT_CAP = 16     # octets per tile slab -> OCT_CAP*OCT = 128 slots = 1 chunk


def compact_plan(fv, tex, fvalid, image_size, tile_w, tile_h, margin,
                 n_chunks, face_chunk, height=None, row0=0, slabs=1):
    """Per-tile face compaction plan (gendr_tpu's ``compact_plan``).

    fv: [B, Fp, 9] Morton-sorted faces; tex: [B, Fp, TS, 3] or None (no
    texture rows: channels 'alpha'); fvalid: [B, Fp] or [Fp] bool.  Groups
    faces into octets (OCT Morton-consecutive faces) and, per pixel tile of
    the band of rows [row0, row0 + height), compacts the hit octets (octet
    bbox union + margin overlaps the tile) into up to ``slabs`` dedicated
    128-slot chunks appended after the Fp faces (chunk ids n_chunks +
    t * slabs + j).  A tile whose hit octets pass slabs * OCT_CAP keeps its
    chunk-granular hit list (a per-tile fallback), so correctness never
    depends on the cap.

    Returns a dict:
      slot_fv [B, S, 9], slot_tex [B, S, TS, 3] (None without tex),
          slot_fvalid [B, S] (S = T * slabs * OCT_CAP * OCT): the appended
          faces; dead slots (padding, overflow tiles) have fvalid 0.
      oct_ids [B, T * slabs * OCT_CAP] int32: the source octet of each
          slot group (the backward's slot -> face sum, scatter_slots).
      tile_counts [B, T], tile_ids [B, T, max(K, slabs) + 1]: the forward's
          lists: a compacted tile lists its appended chunks, an overflow
          tile its original hit chunks.
      chunk_counts [B, K'], chunk_ids [B, K', T]: the backward's lists over
          the K' = n_chunks + T * slabs chunks.
    """
    # an appended slab IS one kernel chunk: its slot count must equal the
    # face-chunk width or the K + t*slabs + j chunk-id addressing breaks
    assert OCT_CAP * OCT == face_chunk, (OCT_CAP, OCT, face_chunk)
    CAP = slabs * OCT_CAP
    B, Fp = fv.shape[:2]
    K = n_chunks
    noct = Fp // OCT
    dev = fv.device
    xs = fv[..., 0::3]
    ys = fv[..., 1::3]
    if fvalid.ndim == 1:
        fvalid = fvalid[None, :].expand(B, Fp)
    big = 1e30
    fxmin = torch.where(fvalid, xs.amin(-1), big).reshape(B, noct, OCT)
    fxmax = torch.where(fvalid, xs.amax(-1), -big).reshape(B, noct, OCT)
    fymin = torch.where(fvalid, ys.amin(-1), big).reshape(B, noct, OCT)
    fymax = torch.where(fvalid, ys.amax(-1), -big).reshape(B, noct, OCT)
    oxmin = fxmin.amin(-1)
    oxmax = fxmax.amax(-1)
    oymin = fymin.amin(-1)
    oymax = fymax.amax(-1)

    txmin, txmax, tymin, tymax = _tile_rects(image_size, tile_w, tile_h,
                                             height, row0, dev)
    T = txmin.shape[0]
    ov = ((txmin[None, :, None] <= oxmax[:, None, :] + margin)
          & (txmax[None, :, None] >= oxmin[:, None, :] - margin)
          & (tymin[None, :, None] <= oymax[:, None, :] + margin)
          & (tymax[None, :, None] >= oymin[:, None, :] - margin))
    # [B, T, noct] octet-hit mask
    ov_i = ov.to(torch.int32)
    n_oct = ov_i.sum(-1, dtype=torch.int32)                   # [B, T]
    overflow = n_oct > CAP
    active = (n_oct > 0) & ~overflow
    # slabs a tile needs: ceil(n_oct / OCT_CAP), 0 if inactive
    nslab = torch.where(active,
                        -(-torch.clamp(n_oct, max=CAP) // OCT_CAP), 0)

    # the first CAP hit octets of each tile, in ascending Morton order
    oct_sort = torch.argsort(1 - ov_i, dim=2, stable=True).to(torch.int32)
    oct_ids = oct_sort[:, :, :CAP]                            # [B, T, CAP]
    oct_slot_valid = (torch.arange(CAP, device=dev)[None, None, :]
                      < n_oct[..., None]) & active[..., None]  # [B, T, CAP]

    # gather the slot faces (and textures) octet-wise: contiguous 8-face
    # slices
    flat_ids = oct_ids.reshape(B, T * CAP)
    idx = flat_ids.long()[..., None]

    def octets(x):
        xo = x.reshape(B, noct, -1)
        return torch.gather(xo, 1, idx.expand(B, T * CAP, xo.shape[2]))
    slot_fv = octets(fv).reshape(B, T * CAP * OCT, 9)
    slot_tex = None
    if tex is not None:
        slot_tex = octets(tex).reshape((B, T * CAP * OCT) + tex.shape[2:])
    slot_fvalid = octets(fvalid) \
        & oct_slot_valid.reshape(B, T * CAP)[..., None]
    slot_fvalid = slot_fvalid.reshape(B, T * CAP * OCT)

    # forward hit lists: chunk-granular for overflow tiles, the tile's
    # nslab appended chunks otherwise; capacity max(K, slabs) + 1 covers
    # both list shapes
    chunk_mask = _chunk_mask_from_octets(ov_i, face_chunk)    # [B, T, K]
    orig_sorted = torch.argsort(1 - chunk_mask, dim=2,
                                stable=True).to(torch.int32)
    orig_counts = chunk_mask.sum(-1, dtype=torch.int32)
    Kcap = max(K, slabs) + 1
    ids_over = torch.cat(
        [orig_sorted,
         torch.zeros((B, T, Kcap - K), dtype=torch.int32, device=dev)], 2)
    slot_chunk0 = K + torch.arange(T, dtype=torch.int32, device=dev) * slabs
    ids_compact = (slot_chunk0[None, :, None]
                   + torch.arange(Kcap, dtype=torch.int32,
                                  device=dev)[None, None, :])
    tile_ids = torch.where(overflow[..., None], ids_over,
                           ids_compact.expand(B, T, Kcap))
    tile_counts = torch.where(overflow, orig_counts, nslab)

    # backward lists over K' = K + T * slabs chunks: the original chunks
    # serve only overflow tiles; appended chunk K + t * slabs + j serves
    # tile t when active and j < nslab(t)
    mask_oo = chunk_mask * overflow[..., None].to(torch.int32)
    mask_oo_t = mask_oo.transpose(1, 2)                       # [B, K, T]
    orig_tiles = torch.argsort(1 - mask_oo_t, dim=2,
                               stable=True).to(torch.int32)
    orig_tcounts = mask_oo_t.sum(-1, dtype=torch.int32)
    slot_tiles = torch.arange(T, dtype=torch.int32, device=dev)[
        None, :, None, None].expand(B, T, slabs, T).reshape(B, T * slabs, T)
    slot_counts = (torch.arange(slabs, dtype=torch.int32,
                                device=dev)[None, None, :]
                   < nslab[..., None]).to(torch.int32).reshape(B, T * slabs)
    chunk_ids = torch.cat([orig_tiles, slot_tiles], 1)
    chunk_counts = torch.cat([orig_tcounts, slot_counts], 1)

    return dict(slot_fv=slot_fv, slot_tex=slot_tex,
                slot_fvalid=slot_fvalid, oct_ids=flat_ids,
                tile_counts=tile_counts.to(torch.int32),
                tile_ids=tile_ids.contiguous(),
                chunk_counts=chunk_counts,
                chunk_ids=chunk_ids.contiguous())


def _chunk_mask_from_octets(ov, face_chunk):
    """[B, T, noct] octet-hit mask -> [B, T, K] int32 chunk-hit mask (a
    chunk is hit iff any of its octets is)."""
    B, T, noct = ov.shape
    opc = face_chunk // OCT
    return (ov.reshape(B, T, noct // opc, opc) > 0).any(-1).to(torch.int32)


def scatter_slots(slot_vals, oct_ids, noct):
    """The slot -> face sum of the backward: slot_vals [B, S, C], per-slot
    values in slot order (S = G * OCT); oct_ids [B, G], the source octet
    of each slot group.  Returns [B, noct * OCT, C]: each face's sum over
    every tile that compacted it, in ascending slot order (the order of
    the tiles), with no atomics and static shapes (``ops.segments``); the
    rows of a group whose octet no slot names are 0.  Slots are octet-
    contiguous, so the sum runs over G groups of OCT rows."""
    B, S, Cc = slot_vals.shape
    G = oct_ids.shape[1]
    v = slot_vals.reshape(B, G, OCT * Cc)
    out = segment_sum(v, segments(oct_ids, noct))
    return out.reshape(B, noct * OCT, Cc)


def _spread(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_order(fv, fvalid):
    """Spatial (Morton / Z-curve) face order: [B, Fp] permutation of the
    faces fv [B, Fp, 9] by the interleaved bits of their projected bbox
    centres (gendr_tpu's ``morton_order``, the key of its
    ``pallas_backend._sorted_faces``), so a chunk of consecutive faces is
    spatially tight; faces whose fvalid ([Fp] bool) is False sort to the
    end.  The sort is stable, so ties keep input order."""
    xs = fv[..., 0::3]
    ys = fv[..., 1::3]
    cx = 0.5 * (xs.amin(-1) + xs.amax(-1))
    cy = 0.5 * (ys.amin(-1) + ys.amax(-1))
    qx = torch.clamp((cx + 1.0) * 512.0, 0, 1023).to(torch.int32)
    qy = torch.clamp((cy + 1.0) * 512.0, 0, 1023).to(torch.int32)
    key = _spread(qx) | (_spread(qy) << 1)
    key = torch.where(fvalid[None, :], key, 0x7FFFFFFF)
    return torch.argsort(key, dim=1, stable=True)
