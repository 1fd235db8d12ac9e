"""Plain PyTorch streaming rasterizer: a loop over face chunks with
associative folds (``backend='torch'``).

Port of ``gendr_tpu/raster/xla_backend.py``.  Each step evaluates a
[B, P, CF] pixel x face-chunk block of the shared pair math.  Forward: the
per-pixel aggregation state (alpha t-conorm fold, streaming softmax-depth
RGB, or hard z-argmin) is carried across chunks: the t-conorm is
associative and the softmax is a streaming logsumexp.  Backward: each
chunk recomputes its pairs and reduces its gradient over the pixels
(deterministic: no atomics).  The ``lax.scan`` of the JAX package is a
Python loop here.

The image is walked in bands of rows, so that no step holds more than
``PAIR_BUDGET`` pair elements whatever the image size; a caller may also
render one band of the image alone (``row_band``, the pixel-sharded path
of ``gendr_tpu_torch.parallel``).  The forward carry is exposed as
``empty_carry`` / ``background_carry`` / ``forward_carry`` /
``merge_carries`` / ``finalize`` so that face shards fold their own carries
and merge them.

It covers every alpha family, both RGB modes and both texture types: it is
the oracle the CUDA kernel (``cuda_backend``) is held against, and the
backend a user picks explicitly for configurations the kernel does not
cover yet.  It runs on any device.
"""

from __future__ import annotations

from typing import Dict

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.ops import tconorms as T
from gendr_tpu_torch.ops.segments import segment_sum, segments
from gendr_tpu_torch.raster import geometry as G
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM

BIG_DEPTH = 10000000.0  # cu:739
NEG_INF = -1e30
# The most [B, P_band, CF] pair elements one step of forward_carry or
# backward evaluates; the image is walked in bands of whole rows under it.
# A step holds some 190 bytes per pair element: a 1536x1536 frame of the
# panda_dist sweep (3.0e8 elements in one step) peaked at 52.6 GiB, in
# bands under this budget at 3.10 GiB (NVIDIA H100 80GB HBM3, 700.00 W;
# chip_smoke.py).
PAIR_BUDGET = 1 << 24


def _band_rows(B, image_size, cf):
    """Rows of the image per step under PAIR_BUDGET (at least one)."""
    return max(1, PAIR_BUDGET // (B * image_size * cf))


def pixel_grid(image_size: int, height=None, row0=0, device=None):
    """NDC pixel centers, flattened row-major over rows [row0, row0 +
    height) of the output image (cu:712-719: yi = is-1-row is the vertical
    flip).  NDC stays global, so a band's pixels are bitwise the same rows
    of the full image's."""
    is_ = image_size
    height = is_ if height is None else height
    idx = torch.arange(height * is_, dtype=torch.int32, device=device)
    rows, cols = row0 + idx // is_, idx % is_
    yi = (is_ - 1 - rows).to(torch.float32)
    xi = cols.to(torch.float32)
    return (2.0 * xi + 1.0 - is_) / is_, (2.0 * yi + 1.0 - is_) / is_


def tconorm_chunk_reduce(tid: int, frags, p):
    """Reduce the face axis (last) with the t-conorm.

    Associativity + commutativity make any tree order equivalent to the
    reference's sequential fold up to float rounding; this keeps the JAX
    package's grouping (an ascending-stride roll butterfly over a
    zero-padded power-of-two width) so the two agree to the ulp.
    """
    n = frags.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = frags.new_zeros(frags.shape[:-1] + (m - n,))
        frags = torch.cat([frags, pad], dim=-1)
    h = 1
    while h < m:
        frags = T.fold_step(tid, frags, torch.roll(frags, h, dims=-1), p)
        h *= 2
    return frags[..., 0]


def _pair_quantities(pk, xp, yp, cfg: C.RenderConfig, par, fwd_only=False):
    """All per-(pixel, face) quantities for one chunk.

    pk: [B, NI, CF] packed per-face constants; xp, yp: [P]; par:
    pairmath._params_vec.  Every returned array broadcasts to [B, P, CF].
    """
    def row(i):
        return pk[:, i, None, :]       # [B, 1, CF]
    return PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                         cfg, need_wcn=True, fwd_only=fwd_only,
                         need_depth=cfg.channels != 'alpha')


def _sample_colors(tex, wcn, cfg: C.RenderConfig):
    """Per-pair colors [B, P, CF, 3] (forward_sample_texture, cu:175-191)."""
    B, CF, TS, _ = tex.shape
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w0, w1, w2 = wcn
        t = tex[:, None]  # [B,1,CF,3,3]
        return (w0[..., None] * t[..., 0, :] + w1[..., None] * t[..., 1, :]
                + w2[..., None] * t[..., 2, :])
    if TS == 1:
        return tex[:, None, :, 0, :].expand(wcn[0].shape + (3,))
    R = int(round(TS ** 0.5))
    ti = G.surface_texel_index(wcn, R)  # [B,P,CF]
    tex_flat = tex.reshape(B, CF * TS, 3)
    cf_idx = torch.arange(CF, device=tex.device)[None, None, :]
    bidx = torch.arange(B, device=tex.device)[:, None, None]
    return tex_flat[bidx, cf_idx * TS + ti]


def _sample_winner_color(tex, win_cf, w_clip_win, cfg: C.RenderConfig):
    """Color of the hard-RGB winning face per pixel. win_cf: [B, P]."""
    B, CF, TS, _ = tex.shape
    bidx = torch.arange(B, device=tex.device)[:, None]
    tex_win = tex[bidx, win_cf]  # [B, P, TS, 3]
    if cfg.texture_type == C.TEXTURE_VERTEX:
        w0, w1, w2 = w_clip_win
        return (w0[..., None] * tex_win[..., 0, :]
                + w1[..., None] * tex_win[..., 1, :]
                + w2[..., None] * tex_win[..., 2, :])
    if TS == 1:
        return tex_win[..., 0, :]
    R = int(round(TS ** 0.5))
    ti = G.surface_texel_index(w_clip_win, R)  # [B,P]
    pidx = torch.arange(ti.shape[1], device=tex.device)[None, :]
    return tex_win[bidx, pidx, ti]


def _pad_faces(face_vertices, textures, cf):
    """Pad the face axis to a multiple of cf; returns (fv, tex, fvalid, nc,
    Fp) with fvalid [Fp] bool marking the real faces."""
    B, F = face_vertices.shape[:2]
    nc = -(-F // cf)
    Fp = nc * cf
    if Fp != F:
        face_vertices = torch.nn.functional.pad(face_vertices,
                                                (0, 0, 0, Fp - F))
        textures = torch.nn.functional.pad(textures,
                                           (0, 0, 0, 0, 0, Fp - F))
    fvalid = torch.arange(Fp, device=face_vertices.device) < F
    return face_vertices, textures, fvalid, nc, Fp


def background_carry(B, P, bg, cfg: C.RenderConfig, params: Dict):
    """The initial per-pixel aggregation state holding the background
    (cu:728-739).  bg: [B, P, 3]."""
    dev = bg.device
    eps = params['aggr_rgb_eps']
    gamma = params['aggr_rgb_gamma']
    alpha0 = torch.zeros((B, P), dtype=torch.float32, device=dev)
    smax0 = torch.ones((B, P), dtype=torch.float32, device=dev) * eps
    ssum0 = torch.ones((B, P), dtype=torch.float32, device=dev) \
        * torch.exp(eps / gamma)
    if cfg.aggr_rgb_func == C.RGB_SOFTMAX and cfg.channels != 'alpha':
        rgb0 = bg * ssum0[..., None]
    else:
        rgb0 = bg
    depth0 = torch.full((B, P), BIG_DEPTH, dtype=torch.float32, device=dev)
    fidx0 = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    return (alpha0, smax0, ssum0, rgb0, depth0, fidx0)


def empty_carry(B, P, cfg: C.RenderConfig, device=None):
    """The identity aggregation state (no background) that a face shard
    folds its faces into (xla_backend.py:205-212)."""
    del cfg  # one layout for every mode
    return (torch.zeros((B, P), dtype=torch.float32, device=device),
            torch.full((B, P), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((B, P), dtype=torch.float32, device=device),
            torch.zeros((B, P, 3), dtype=torch.float32, device=device),
            torch.full((B, P), BIG_DEPTH, dtype=torch.float32,
                       device=device),
            torch.full((B, P), -1, dtype=torch.int32, device=device))


def merge_carries(a, b, cfg: C.RenderConfig, params: Dict):
    """Merge two aggregation states; ``a`` covers faces that precede ``b``
    (xla_backend.py:215-238): the t-conorm folds the two alphas, the
    streaming softmax rescales both sums to the larger max, and the hard-RGB
    z-argmin keeps ``a``'s winner on a tie (strict <)."""
    alpha_a, smax_a, ssum_a, rgb_a, depth_a, fidx_a = a
    alpha_b, smax_b, ssum_b, rgb_b, depth_b, fidx_b = b
    dev = alpha_a.device
    gamma = params['aggr_rgb_gamma'].to(dev)
    if cfg.aggr_alpha_func == C.ALPHA_HARD:
        alpha = torch.maximum(alpha_a, alpha_b)
    else:
        alpha = T.fold_step(cfg.aggr_alpha_func, alpha_a, alpha_b,
                            params['aggr_alpha_t_conorm_p'].to(dev))
    m = torch.maximum(smax_a, smax_b)
    sa = torch.exp((smax_a - m) / gamma)
    sb = torch.exp((smax_b - m) / gamma)
    ssum = ssum_a * sa + ssum_b * sb
    better = depth_b < depth_a
    depth = torch.where(better, depth_b, depth_a)
    fidx = torch.where(better, fidx_b, fidx_a)
    if cfg.aggr_rgb_func == C.RGB_HARD:
        rgb = torch.where(better[..., None], rgb_b, rgb_a)
    else:
        rgb = rgb_a * sa[..., None] + rgb_b * sb[..., None]
    return (alpha, m, ssum, rgb, depth, fidx)


def forward_carry(face_vertices, textures, fvalid, carry0,
                  cfg: C.RenderConfig, params: Dict, base_offset=0,
                  row_band=None):
    """Fold all face chunks into ``carry0``.  Inputs must already be padded
    to a multiple of the chunk size; fvalid: [Fp] bool.  ``base_offset``
    shifts the face ids recorded for hard RGB (a face shard's first global
    id); ``row_band=(row0, height)`` renders only those rows of the image
    (carry0 then holds height * image_size pixels).

    The rows are walked in bands of at most PAIR_BUDGET pair elements per
    step; each pixel folds the same faces in the same order whatever the
    band, so the result is bitwise that of one band."""
    B, Fp = face_vertices.shape[:2]
    dev = face_vertices.device
    is_ = cfg.image_size
    row0, height = row_band if row_band is not None else (0, is_)
    cf = min(cfg.face_chunk, max(Fp, 1))
    par = PM._params_vec(params, cfg, dev)
    packed = pack.pack_faces(face_vertices, textures, fvalid, cfg,
                             with_tex=False)
    step = _band_rows(B, is_, cf)
    parts = []
    for r in range(0, height, step):
        h = min(step, height - r)
        pix = slice(r * is_, (r + h) * is_)
        xp, yp = pixel_grid(is_, h, row0 + r, dev)
        parts.append(_fold_chunks(packed, textures, tuple(
            c[:, pix] for c in carry0), xp, yp, cf, cfg, params, par,
            base_offset))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(c, dim=1) for c in zip(*parts))


def _fold_chunks(packed, textures, carry, xp, yp, cf, cfg: C.RenderConfig,
                 params: Dict, par, base_offset):
    """forward_carry on the pixels (xp, yp): every chunk, in order."""
    B, _, Fp = packed.shape
    dev = packed.device
    nc = Fp // cf
    gamma = params['aggr_rgb_gamma']
    tid = cfg.aggr_alpha_func
    bidx = torch.arange(B, device=dev)[:, None]
    pidx = torch.arange(xp.shape[0], device=dev)[None, :]

    alpha, smax, ssum, rgb, depth_min, fidx = carry
    for k in range(nc):
        pk = packed[:, :, k * cf:(k + 1) * cf]
        tex = textures[:, k * cf:(k + 1) * cf]
        q = _pair_quantities(pk, xp, yp, cfg, par, fwd_only=True)
        frag, valid = q['frag'], q['valid']

        # -- alpha aggregation (cu:791-801)
        if tid == C.ALPHA_HARD:
            alpha = torch.where((frag > 0.5).any(-1), 1.0, alpha)
        else:
            chunk_agg = tconorm_chunk_reduce(tid, frag, par[PM.P_TCP])
            alpha = T.fold_step(tid, alpha, chunk_agg, par[PM.P_TCP])

        # -- RGB aggregation
        if cfg.channels == 'alpha':
            continue  # silhouette-only: depth/RGB skipped entirely
        if cfg.aggr_rgb_func == C.RGB_HARD:
            # z-argmin among pixels inside the face (cu:815-822); ranked by
            # 1/denom, ties to the first (lowest input id) face
            hmask = valid & q['zvalid'] & q['in_loose'] & q['front_ok']
            zp_m = torch.where(hmask, 1.0 / q['denom'], torch.inf)
            win_cf = torch.argmin(zp_m, dim=-1)  # [B,P]
            zmin_chunk = zp_m[bidx, pidx, win_cf]
            w_clip_win = tuple(wc.expand_as(zp_m)[bidx, pidx, win_cf]
                               for wc in q['wcn'])
            color_win = _sample_winner_color(tex, win_cf, w_clip_win, cfg)
            better = zmin_chunk < depth_min
            depth_min = torch.where(better, zmin_chunk, depth_min)
            fidx = torch.where(better, base_offset + k * cf
                               + win_cf.to(torch.int32), fidx)
            rgb = torch.where(better[..., None], color_win, rgb)
        else:
            # streaming softmax over zp_norm weighted by coverage
            # (cu:824-839)
            cmask = valid & q['zvalid'] & q['front_ok']
            zp_norm = (params['far'] - q['zp']) / (params['far']
                                                   - params['near'])
            zn = torch.where(cmask, zp_norm, NEG_INF)
            m_new = torch.maximum(smax, zn.amax(-1))
            scale_old = torch.exp((smax - m_new) / gamma)
            expz = torch.exp((zn - m_new[..., None]) / gamma)
            wexp = torch.where(cmask, frag * expz, 0.0)
            colors = _sample_colors(tex, q['wcn'], cfg)
            ssum = ssum * scale_old + wexp.sum(-1)
            rgb = rgb * scale_old[..., None] \
                + torch.einsum('bpc,bpck->bpk', wexp, colors)
            smax = m_new

    return (alpha, smax, ssum, rgb, depth_min, fidx)


def finalize(carry, cfg: C.RenderConfig):
    """Carry -> (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]); H follows
    from the carry's pixel count (a band's height on the pixel-sharded
    path), W = cfg.image_size."""
    alpha, smax, ssum, rgb, depth_min, fidx = carry
    B = alpha.shape[0]
    is_ = cfg.image_size
    h = alpha.shape[1] // is_
    if cfg.channels == 'alpha' or cfg.aggr_rgb_func == C.RGB_HARD:
        # alpha-only carries the background untouched
        rgb_final = rgb
        aggr0, aggr1 = depth_min, fidx.to(torch.float32)
    else:
        rgb_final = rgb / ssum[..., None]
        aggr0, aggr1 = ssum, smax
    soft_colors = torch.cat([rgb_final, alpha[..., None]], dim=-1)
    soft_colors = soft_colors.reshape(B, h, is_, 4).permute(0, 3, 1, 2)
    aggrs_info = torch.stack([aggr0, aggr1], dim=1).reshape(B, 2, h, is_)
    return soft_colors.contiguous(), aggrs_info


def forward(face_vertices, textures, cfg: C.RenderConfig, params: Dict):
    """Returns (soft_colors [B,4,H,W], aggrs_info [B,2,H,W]).

    face_vertices [B, F, 9]; textures [B, F, TS, 3] (vertex: [B, F, 3, 3]).
    Semantics of ``forward_render_cuda_kernel`` (cu:680-862), streamed over
    face chunks.  aggrs_info holds (depth, winner input face id) for hard
    RGB and alpha-only, (softmax sum, softmax max) for softmax RGB.
    """
    B, F = face_vertices.shape[:2]
    P = cfg.image_size * cfg.image_size
    cf = min(cfg.face_chunk, max(F, 1))
    face_vertices, textures, fvalid, _, _ = _pad_faces(
        face_vertices, textures, cf)
    bg = params['background_color'].to(face_vertices.device) \
        .reshape(1, 1, 3).expand(B, P, 3)
    carry0 = background_carry(B, P, bg, cfg, params)
    carry = forward_carry(face_vertices, textures, fvalid, carry0, cfg,
                          params)
    return finalize(carry, cfg)


def forward_with_aux(face_vertices, textures, cfg: C.RenderConfig,
                     params: Dict):
    """forward plus the residual the backward needs beyond its inputs:
    none, the packed constants are recomputed bitwise in the backward."""
    soft_colors, aggrs_info = forward(face_vertices, textures, cfg, params)
    return soft_colors, aggrs_info, None


def backward(face_vertices, textures, soft_colors, aggrs_info,
             grad_soft_colors, cfg: C.RenderConfig, params: Dict,
             base_offset=0, row_band=None):
    """Returns (grad_face_vertices [B,F,9], grad_textures [B,F,TS,3]).

    Semantics of ``backward_render_cuda_kernel`` (cu:866-1065): recompute
    the per-pair coverage, apply the aggregate-inverse t-conorm rule, the
    softmax RGB chain and the closest-point distance chain, and reduce
    each chunk's pairs over the pixels.  ``base_offset`` and ``row_band``
    as in forward_carry: the image tensors then hold only that band, and
    the hard-RGB winner ids are global (this shard's ids + base_offset).

    The rows are walked in bands of at most PAIR_BUDGET pair elements per
    step and the bands' sums added: with more than one band the pixel sum
    is grouped otherwise than in one, so the gradient agrees with a
    one-band run within float32 rounding, not bitwise.
    """
    B, F = face_vertices.shape[:2]
    dev = face_vertices.device
    is_ = cfg.image_size
    row0, height = row_band if row_band is not None else (0, is_)
    P = soft_colors.shape[2] * soft_colors.shape[3]
    cf = min(cfg.face_chunk, max(F, 1))

    fv_p, tex_p, fvalid, _, _ = _pad_faces(face_vertices, textures, cf)
    par = PM._params_vec(params, cfg, dev)
    packed = pack.pack_faces(fv_p, tex_p, fvalid, cfg, with_tex=False)

    # pixel-space tensors as [B, P, .]
    g = grad_soft_colors.permute(0, 2, 3, 1).reshape(B, P, 4)
    final = soft_colors.permute(0, 2, 3, 1).reshape(B, P, 4)
    aggr = aggrs_info.reshape(B, 2, P)
    step = _band_rows(B, is_, cf)
    grad_faces = grad_tex = None
    for r in range(0, height, step):
        h = min(step, height - r)
        pix = slice(r * is_, (r + h) * is_)
        xp, yp = pixel_grid(is_, h, row0 + r, dev)
        gf, gt = _backward_chunks(packed, tex_p, xp, yp, g[:, pix],
                                  final[:, pix], aggr[:, :, pix], cf, cfg,
                                  params, par, base_offset)
        if grad_faces is None:
            grad_faces, grad_tex = gf, gt
        else:
            grad_faces, grad_tex = grad_faces + gf, grad_tex + gt
    return grad_faces[:, :F], grad_tex[:, :F]


def _backward_chunks(packed, tex_p, xp, yp, g, final, aggr, cf,
                     cfg: C.RenderConfig, params: Dict, par, base_offset):
    """backward's per-face sums over the pixels (xp, yp), whose [B, P, .]
    image columns are g, final and aggr: [B, Fp, 9] and [B, Fp, TS, 3]."""
    B, _, Fp = packed.shape
    TS = tex_p.shape[2]
    dev = packed.device
    nc = Fp // cf
    gamma = params['aggr_rgb_gamma']
    near, far = params['near'], params['far']
    aggr0, aggr1 = aggr[:, 0], aggr[:, 1]  # (ssum, smax) or (depth, idx)
    gA = g[..., 3]

    gfaces, gtexs = [], []
    for k in range(nc):
        pk = packed[:, :, k * cf:(k + 1) * cf]
        tex = tex_p[:, k * cf:(k + 1) * cf]
        q = _pair_quantities(pk, xp, yp, cfg, par)
        frag, valid = q['frag'], q['valid']
        w_clip = q.get('wcn')

        # alpha path (cu:973-987)
        if cfg.aggr_alpha_func == C.ALPHA_HARD:
            # reference quirk: the incoming alpha grad flows into the
            # coverage chain un-multiplied (cu:975-976 only skips the
            # t-conorm factor)
            c_grad_xy = gA[..., None].expand(frag.shape)
        else:
            c_grad_xy = gA[..., None] * T.aggregate_backward(
                cfg.aggr_alpha_func, final[..., 3:4], frag, par[PM.P_TCP])
        c_grad_xy = torch.where(valid, c_grad_xy, 0.0)

        gz = None
        gtex_coef = None  # [B,P,CF,3] per-channel texture-grad coefficient
        if cfg.channels == 'alpha':
            pass
        elif cfg.aggr_rgb_func == C.RGB_HARD:
            # texture grad only to the winning face (cu:997-1004); winner
            # ids are input face ids
            zmask = valid & q['zvalid']
            cf_ids = base_offset + k * cf \
                + torch.arange(cf, device=dev)[None, None, :]
            win = zmask & (aggr1[..., None].to(torch.int32) == cf_ids)
            gtex_coef = torch.where(win[..., None], g[:, :, None, :3], 0.0)
        else:
            zp = q['zp']
            cmask = valid & q['zvalid'] & q['front_ok']
            zp_norm = (far - zp) / (far - near)
            # aggr0 = softmax_sum, aggr1 = softmax_max (cu:916-917, 1010)
            zp_softmax = torch.where(
                cmask,
                frag * torch.exp((torch.where(cmask, zp_norm, NEG_INF)
                                  - aggr1[..., None]) / gamma)
                / aggr0[..., None], 0.0)
            colors = _sample_colors(tex, w_clip, cfg)
            diff = colors - final[:, :, None, :3]  # color_k - final_k
            c_xyz = torch.einsum('bpk,bpck->bpc', g[..., :3], diff) \
                * zp_softmax  # cu:1012-1023
            gtex_coef = zp_softmax[..., None] * g[:, :, None, :3]
            c_grad_xy = c_grad_xy + torch.where(
                cmask, c_xyz / torch.where(cmask, frag, 1.0), 0.0)  # cu:1024
            c_z = c_xyz / gamma / (near - far) * zp * zp  # cu:1026
            # w_clip_j / z_j^2 == wcn_j * iz_j^2 (cu:1027-1029)
            iz = tuple(pk[:, pack.R_IZ + j, None, :] for j in range(3))
            gz = tuple(torch.where(cmask, c_z * w_clip[j] * (iz[j] * iz[j]),
                                   0.0) for j in range(3))

        # distance chain (cu:1034-1052)
        pdf_v = D.pdf(cfg.dist_func, q['sign'], q['dis'], par[PM.P_SCALE],
                      par[PM.P_SHAPE], par[PM.P_SHIFT],
                      gamma_inv=par[PM.P_GINV])
        c_grad_xy = torch.where(valid, c_grad_xy * pdf_v, 0.0)

        tw = PM.tw_from_ksel(q['ksel'], q['tv'])
        if cfg.dist_squared:
            base_coef = 2.0 * q['sign'] * c_grad_xy
        else:
            # |(dis_x, dis_y)| == dis by construction, so the direction
            # normalization reuses the rsqrt that produced dis
            # (cu:1046-1050)
            base_coef = q['sign'] * c_grad_xy * q['rdis']

        gface = []
        for j in range(3):
            gx = (base_coef * tw[j] * q['dis_x']).sum(1)  # [B, CF]
            gy = (base_coef * tw[j] * q['dis_y']).sum(1)
            gzj = gz[j].sum(1) if gz is not None else torch.zeros_like(gx)
            gface.extend([gx, gy, gzj])
        gfaces.append(torch.stack(gface, dim=-1))  # [B, CF, 9]

        # texture gradients (backward_sample_texture, cu:194-214)
        if gtex_coef is None:
            gtex = torch.zeros((B, cf) + tex_p.shape[2:], device=dev)
        elif cfg.texture_type == C.TEXTURE_VERTEX:
            gtex = torch.stack([torch.einsum('bpc,bpck->bck', w_clip[j],
                                             gtex_coef) for j in range(3)],
                               dim=2)  # [B, CF, 3, 3]
        elif TS == 1:
            gtex = gtex_coef.sum(1)[:, :, None, :]
        else:
            ti = G.surface_texel_index(w_clip, int(round(TS ** 0.5)))
            gtex = texel_sums(gtex_coef, ti.expand(frag.shape), TS)
        gtexs.append(gtex)

    return torch.cat(gfaces, dim=1), torch.cat(gtexs, dim=1)


def texel_sums(coef, ti, TS):
    """Each pair's texture-gradient coefficient coef [B, P, CF, 3] summed
    into the texel ti [B, P, CF] (int) it samples: [B, CF, TS, 3].  A
    fixed-order segment sum over face * TS + texel (``ops.segments``): each
    texel's pairs are added from 0 in ascending pixel order, the order
    ``scatter_add_`` takes on the CPU, and with no atomics on the card."""
    B, _, cf = ti.shape
    idx = (torch.arange(cf, device=ti.device) * TS + ti).reshape(B, -1)
    out = segment_sum(coef.reshape(B, -1, 3), segments(idx, cf * TS))
    return out.reshape(B, cf, TS, 3)


def backward_from_aux(face_vertices, textures, aux, soft_colors, aggrs_info,
                      grad_soft_colors, cfg: C.RenderConfig, params: Dict,
                      base_offset=0, row_band=None):
    del aux  # None: see forward_with_aux
    return backward(face_vertices, textures, soft_colors, aggrs_info,
                    grad_soft_colors, cfg, params, base_offset, row_band)
