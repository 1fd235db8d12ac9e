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

    if with_tex:
        if cfg.texture_type == C.TEXTURE_VERTEX:
            for j in range(3):
                for c in range(3):
                    rows[R_TEX + 3 * j + c] = textures[:, :, j, c]
        else:
            for t in range(TS):
                for c in range(3):
                    rows[R_TEX + 3 * t + c] = textures[:, :, t, c]

    zero = torch.zeros((B, Fp), dtype=torch.float32, device=f.device)
    rows = [zero if r is None else r for r in rows]
    return torch.stack(rows, dim=1)


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


def tile_chunk_mask(packed, image_size, tile_w, tile_h, face_chunk, margin):
    """[B, T, K] int32 mask: does face-chunk k (bbox union + margin) overlap
    2D pixel tile t?  The replacement for the reference's per-thread
    early-exit culls (cu:747, 769, 784).

    Tiles are numbered row-major over a ceil(size / tile) grid, so a size
    that the tile does not divide gets ragged edge tiles; their NDC
    rectangle is the full tile's, which only over-covers (a conservative
    cull), and the kernel masks the pixels that lie outside the image.
    For sizes the tile divides this is ``gendr_tpu``'s mask exactly."""
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

    tx_n = -(-is_ // tile_w)
    ty_n = -(-is_ // tile_h)
    t_idx = torch.arange(tx_n * ty_n, device=dev)
    ty, tx = t_idx // tx_n, t_idx % tx_n
    c0 = tx * tile_w
    r0 = ty * tile_h
    tx_min = (2.0 * c0 + 1.0 - is_) / is_
    tx_max = (2.0 * (c0 + tile_w - 1) + 1.0 - is_) / is_
    # y decreases with row index (vertical flip, cu:716-719)
    ty_max = (2.0 * (is_ - 1 - r0) + 1.0 - is_) / is_
    ty_min = (2.0 * (is_ - 1 - (r0 + tile_h - 1)) + 1.0 - is_) / is_

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
