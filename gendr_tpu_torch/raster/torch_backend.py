"""Plain PyTorch streaming rasterizer: a loop over face chunks with
associative folds (``backend='torch'``).

Port of the forward half of ``gendr_tpu/raster/xla_backend.py``.  Each
step evaluates a [B, P, CF] pixel x face-chunk block of the shared pair
math, and the per-pixel aggregation state (alpha t-conorm fold, streaming
softmax-depth RGB, or hard z-argmin) is carried across chunks: the
t-conorm is associative and the softmax is a streaming logsumexp.  The
``lax.scan`` of the JAX package is a Python loop here.

It covers every alpha family, both RGB modes and both texture types: it is
the oracle the CUDA kernel (``cuda_backend``) is held against, and the
backend a user picks explicitly for configurations the kernel does not
cover yet.  It runs on any device.
"""

from __future__ import annotations

from typing import Dict

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import tconorms as T
from gendr_tpu_torch.raster import geometry as G
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import pairmath as PM

BIG_DEPTH = 10000000.0  # cu:739
NEG_INF = -1e30


def pixel_grid(image_size: int, device=None):
    """NDC pixel centers, flattened row-major over the output image
    (cu:712-719: yi = is-1-row is the vertical flip)."""
    is_ = image_size
    idx = torch.arange(is_ * is_, dtype=torch.int32, device=device)
    rows, cols = idx // is_, idx % is_
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


def _pair_quantities(pk, xp, yp, cfg: C.RenderConfig, par):
    """All per-(pixel, face) quantities for one chunk.

    pk: [B, NI, CF] packed per-face constants; xp, yp: [P]; par:
    pairmath._params_vec.  Every returned array broadcasts to [B, P, CF].
    """
    def row(i):
        return pk[:, i, None, :]       # [B, 1, CF]
    return PM._pair_math(row, xp[None, :, None], yp[None, :, None], par,
                         cfg, need_wcn=True,
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


def forward_carry(face_vertices, textures, fvalid, carry0,
                  cfg: C.RenderConfig, params: Dict):
    """Fold all face chunks into ``carry0``.  Inputs must already be padded
    to a multiple of the chunk size; fvalid: [Fp] bool."""
    B, Fp = face_vertices.shape[:2]
    dev = face_vertices.device
    xp, yp = pixel_grid(cfg.image_size, dev)
    cf = min(cfg.face_chunk, max(Fp, 1))
    nc = Fp // cf
    gamma = params['aggr_rgb_gamma']
    par = PM._params_vec(params, cfg, dev)
    packed = pack.pack_faces(face_vertices, textures, fvalid, cfg,
                             with_tex=False)
    tid = cfg.aggr_alpha_func
    bidx = torch.arange(B, device=dev)[:, None]
    pidx = torch.arange(xp.shape[0], device=dev)[None, :]

    alpha, smax, ssum, rgb, depth_min, fidx = carry0
    for k in range(nc):
        pk = packed[:, :, k * cf:(k + 1) * cf]
        tex = textures[:, k * cf:(k + 1) * cf]
        q = _pair_quantities(pk, xp, yp, cfg, par)
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
            fidx = torch.where(better, k * cf + win_cf.to(torch.int32),
                               fidx)
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
    """Carry -> (soft_colors [B,4,H,W], aggrs_info [B,2,H,W])."""
    alpha, smax, ssum, rgb, depth_min, fidx = carry
    B = alpha.shape[0]
    is_ = cfg.image_size
    if cfg.channels == 'alpha' or cfg.aggr_rgb_func == C.RGB_HARD:
        # alpha-only carries the background untouched
        rgb_final = rgb
        aggr0, aggr1 = depth_min, fidx.to(torch.float32)
    else:
        rgb_final = rgb / ssum[..., None]
        aggr0, aggr1 = ssum, smax
    soft_colors = torch.cat([rgb_final, alpha[..., None]], dim=-1)
    soft_colors = soft_colors.reshape(B, is_, is_, 4).permute(0, 3, 1, 2)
    aggrs_info = torch.stack([aggr0, aggr1], dim=1).reshape(B, 2, is_, is_)
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
