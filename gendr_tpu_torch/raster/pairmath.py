"""Per-(pixel, face) pair math of the forward and backward passes.

Port of ``gendr_tpu/raster/pairmath.py``: barycentrics from the packed
affine rows, the packed-constant signed distance (pack.py identities), the
CDF, the bbox gate and the probability cull; for the gradient also the
closest feature (the selected edge, its parameter and the distance
vector).  The plain backends evaluate it on [B, P, CF] broadcast blocks;
the CUDA kernels (``csrc/pairmath.cuh``) run the same operation sequence
per thread.

All inputs arrive through a ``row(i)`` accessor over the packed per-face
constant rows plus broadcastable pixel coordinates, so the code is
shape-agnostic.
"""

from __future__ import annotations

from typing import Dict

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.raster import pack

# parameter-vector slots (the kernel reads them from a [16] device vector);
# P_ROW0 stays 0: the kernels and the plain path take a row band's first
# row as an argument
(P_SCALE, P_SHAPE, P_SHIFT, P_THR, P_TCP, P_EPS, P_GAMMA, P_NEAR, P_FAR,
 P_GINV1, P_GINV, P_BG0, P_BG1, P_BG2, P_ROW0, P_MARGIN) = range(16)
NPAR = 16


def params_vector(params: Dict, cfg=None):
    """The [16] float32 parameter vector of ``params`` (the keys of
    config.RenderParams), derived where the parameters are.

    Numbers (config.RenderParams.as_dict makes them float32 scalars on the
    CPU) derive it on the CPU, so each derived slot rounds as the JAX
    package's does; nothing is read back from the card.  A parameter given
    as a tensor on the card derives it there, with the others copied to it
    (its gamma normalizers then round as the card's lgamma does).  A
    parameter of shape [n] (a schedule of dist_scale, say) gives [n, 16],
    row k the vector of its k-th value.

    P_MARGIN is the per-pair bbox-gate radius.  Pixels farther than this
    from a face's vertex-derived bbox have true coverage <=
    PROBABILITY_THRESHOLD, so the reference drops them (cu:784); the gate
    drops them without evaluating the barycentric algebra, whose fp32
    blow-up on near-degenerate sliver faces otherwise reports phantom
    "inside" along thin bands far from the mesh.  With cfg the radius is
    pack.cull_margin (the tile x chunk cull's value); without it, the
    reference's looser bbox-exit bound sqrt(dist_eps * tau) (cu:747).
    """
    f32 = torch.float32
    dev = next((v.device for k, v in params.items() if k != 'par'
                and isinstance(v, torch.Tensor) and v.device.type != 'cpu'),
               torch.device('cpu'))
    p = {k: to_device(torch.as_tensor(v, dtype=f32), dev)
         for k, v in params.items() if k != 'par'}
    if cfg is not None:
        margin = pack.cull_margin(cfg, p)
    else:
        margin = torch.sqrt(p['dist_eps'] * p['dist_scale'])
    bg = p['background_color'].reshape(3)
    slots = torch.broadcast_tensors(
        p['dist_scale'],
        p['dist_shape'],
        p['dist_shift'],
        p['dist_eps'] * p['dist_scale'],
        p['aggr_alpha_t_conorm_p'],
        p['aggr_rgb_eps'],
        p['aggr_rgb_gamma'],
        p['near'],
        p['far'],
        # gamma normalizers 1/Gamma(shape+1) and 1/Gamma(max(shape, 1e-6))
        torch.exp(-torch.lgamma(p['dist_shape'] + 1.0)),
        torch.exp(-torch.lgamma(torch.clamp(p['dist_shape'], min=1e-6))),
        bg[0], bg[1], bg[2],
        torch.zeros((), dtype=f32, device=dev),
        margin.to(f32))
    return torch.stack(slots, dim=-1)


def _params_vec(params: Dict, cfg=None, device=None):
    """The [16] vector a backend reads: ``params['par']`` where the render
    put it there (:func:`vector_params`), else :func:`params_vector`;
    copied to ``device`` unless it is there."""
    par = params.get('par')
    if par is None:
        par = params_vector(params, cfg)
    return par if device is None else to_device(par, device)


def vector_params(par, host=None):
    """The params dict of a render whose [16] vector is ``par`` (on the
    inputs' device): 'par', and each parameter a view of its slot, of
    ``host`` where given (the same vector on the CPU, so plain code that
    reads a parameter as a number reads it without a copy from the card).
    dist_eps is not among them: the vector holds it only inside P_THR and
    P_MARGIN, which the backends read."""
    v = par if host is None else host
    return dict(par=par, dist_scale=v[P_SCALE], dist_shape=v[P_SHAPE],
                dist_shift=v[P_SHIFT], aggr_alpha_t_conorm_p=v[P_TCP],
                aggr_rgb_eps=v[P_EPS], aggr_rgb_gamma=v[P_GAMMA],
                near=v[P_NEAR], far=v[P_FAR],
                background_color=v[P_BG0:P_BG2 + 1])


def _dis_from_dis2(dis2, cfg):
    """(dis, rdis) from the squared distance: one rsqrt serves |dis| for the
    CDF and 1/|dis| for the backward's direction normalization.  The 1e-30
    floor keeps dis exact down to 1e-15; rdis is clamped to 1e6 (the
    reference's max(|dis|, 1e-6) floor, cu:1050)."""
    if cfg.dist_squared:
        return dis2, None
    rdis = torch.rsqrt(torch.clamp(dis2, min=1e-30))
    return dis2 * rdis, torch.clamp(rdis, max=1e6)


def sel3(idx, c):
    """Pick c[idx] per element for a 3-tuple of candidate arrays."""
    return torch.where(idx == 0, c[0], torch.where(idx == 1, c[1], c[2]))


def tw_from_ksel(ksel, tv):
    """Closest-point barycentric weights from the selected edge and its
    (inside-folded) edge parameter: edge k runs vertex k -> k+1, the
    opposite vertex k+2 gets weight 0 (the reference backward's ``t + w0``
    combination, cu:1044-1052)."""
    one_m = 1.0 - tv
    zero = torch.zeros_like(tv)
    return (sel3(ksel, (tv, zero, one_m)), sel3(ksel, (one_m, tv, zero)),
            sel3(ksel, (zero, one_m, tv)))


def _pair_math(row, xp, yp, par, cfg: C.RenderConfig, need_wcn=True,
               fwd_only=False, need_depth=True):
    """Per-(pixel, face) math.

    row(i): the i-th packed per-face constant, broadcastable against the
    pixel coordinates xp, yp.  Returns a dict of broadcast arrays; each
    field mirrors the reference per-thread quantity cited inline.
    fwd_only=False adds the closest-feature fields the gradient needs
    (ksel, tv, dis_x, dis_y, rdis); frag is bitwise the same either way.
    """
    thr = par[P_THR]

    w0 = row(pack.R_INV + 0) * xp + row(pack.R_INV + 1) * yp \
        + row(pack.R_INV + 2)
    w1 = row(pack.R_INV + 3) * xp + row(pack.R_INV + 4) * yp \
        + row(pack.R_INV + 5)
    w2 = row(pack.R_INV + 6) * xp + row(pack.R_INV + 7) * yp \
        + row(pack.R_INV + 8)

    # bbox gate (P_MARGIN): bounds every contribution to the pixels the
    # reference keeps, however badly the barycentric algebra of a sliver
    # face misbehaves in fp32.  Inside the gate nothing below changes.
    mbb = par[P_MARGIN]
    bb = (xp >= row(pack.R_BBOX + 0) - mbb) \
        & (xp <= row(pack.R_BBOX + 1) + mbb) \
        & (yp >= row(pack.R_BBOX + 2) - mbb) \
        & (yp <= row(pack.R_BBOX + 3) + mbb)

    # the three barycentric rows sum to 1 by construction, so all w_i > 0
    # already implies every w_i < 1
    wmin = torch.minimum(torch.minimum(w0, w1), w2)
    inside = (wmin > 0) & bb
    in_loose = (wmin >= 0) & bb

    q = dict(w=(w0, w1, w2), inside=inside, in_loose=in_loose)

    if cfg.dist_func == C.HEAVISIDE:
        frag = torch.where(in_loose, 1.0, 0.0)
        cull = ~bb
        if not fwd_only:
            zero = torch.zeros_like(w0)
            q.update(sign=torch.where(inside, 1.0, -1.0), dis=zero,
                     dis_x=zero, dis_y=zero, tv=zero,
                     ksel=torch.zeros_like(w0, dtype=torch.int32),
                     rdis=zero)
    elif fwd_only:
        # The forward needs only dis^2: the region decision tree
        # (cu:127-139) exists to FIND the minimizing clamped edge, so a
        # plain min over the three clamped edge distances gives the same
        # value.
        ws = (w0, w1, w2)
        d2u_min = None
        d2c_min = None
        for k in range(3):
            tv = row(pack.R_TV + 3 * k) * xp \
                + row(pack.R_TV + 3 * k + 1) * yp \
                + row(pack.R_TV + 3 * k + 2)
            wj = ws[(k + 2) % 3]
            d2u = wj * wj * row(pack.R_MM + k)
            dd = torch.clamp(tv, 0.0, 1.0) - tv
            d2c = d2u + dd * dd * row(pack.R_E2 + k)
            d2u_min = d2u if d2u_min is None else torch.minimum(d2u_min, d2u)
            d2c_min = d2c if d2c_min is None else torch.minimum(d2c_min, d2c)
        dis2 = torch.where(inside, d2u_min, d2c_min)
        cull = ((~inside) & (dis2 >= thr)) | ~bb
        dis, _ = _dis_from_dis2(dis2, cfg)
        sign = torch.where(inside, 1.0, -1.0)
        frag = D.cdf(cfg.dist_func, sign, dis, par[P_SCALE], par[P_SHAPE],
                     par[P_SHIFT], gamma_inv1=par[P_GINV1])
        q.update(sign=sign, dis=dis)
    else:
        # Per edge, fold the inside/outside cases up front: inside pairs
        # rank edges by the unclamped foot distance (cu:91-120), outside
        # pairs by the clamped-segment distance (cu:127-139); a first-min
        # argmin selects the closest feature.  At a corner two edges tie,
        # but both clamp to the same corner point (same dis_x/dis_y, tv in
        # {0, 1}), so the gradient does not depend on which tie wins.
        ws = (w0, w1, w2)
        tvs, dds, d2sel = [], [], []
        for k in range(3):
            tv = row(pack.R_TV + 3 * k) * xp \
                + row(pack.R_TV + 3 * k + 1) * yp \
                + row(pack.R_TV + 3 * k + 2)
            wj = ws[(k + 2) % 3]
            tvc = torch.clamp(tv, 0.0, 1.0)
            dd = tvc - tv
            u2 = wj * wj * row(pack.R_MM + k)
            c2 = u2 + dd * dd * row(pack.R_E2 + k)
            tvs.append(torch.where(inside, tv, tvc))
            dds.append(dd)
            d2sel.append(torch.where(inside, u2, c2))

        sel0 = (d2sel[0] <= d2sel[1]) & (d2sel[0] <= d2sel[2])
        sel1 = (~sel0) & (d2sel[1] <= d2sel[2])
        ksel = torch.where(sel0, 0, torch.where(sel1, 1, 2)) \
            .to(torch.int32)

        # distance vector of the selected feature: u = w_j m_k for the
        # unclamped foot, plus dd * e_k where the edge parameter clamps
        wj_sel = sel3(ksel, (w2, w0, w1))
        dis_x = wj_sel * sel3(ksel, tuple(row(pack.R_M + 2 * k)
                                          for k in range(3)))
        dis_y = wj_sel * sel3(ksel, tuple(row(pack.R_M + 2 * k + 1)
                                          for k in range(3)))
        out_dd = torch.where(inside, 0.0, sel3(ksel, dds))
        dis_x = dis_x + out_dd * sel3(
            ksel, tuple(row(pack.R_E + 2 * k) for k in range(3)))
        dis_y = dis_y + out_dd * sel3(
            ksel, tuple(row(pack.R_E + 2 * k + 1) for k in range(3)))

        # the same min as the forward branch, so a recomputed coverage
        # equals the forward's bitwise (the max t-conorm's backward finds
        # its winner by exact equality, cu:574-575)
        dis2 = torch.minimum(torch.minimum(d2sel[0], d2sel[1]), d2sel[2])
        cull = ((~inside) & (dis2 >= thr)) | ~bb
        dis, rdis = _dis_from_dis2(dis2, cfg)
        sign = torch.where(inside, 1.0, -1.0)
        frag = D.cdf(cfg.dist_func, sign, dis, par[P_SCALE], par[P_SHAPE],
                     par[P_SHIFT], gamma_inv1=par[P_GINV1])
        q.update(sign=sign, dis=dis, dis_x=dis_x, dis_y=dis_y,
                 tv=sel3(ksel, tvs), ksel=ksel)
        if rdis is not None:
            q['rdis'] = rdis
    q['cull'] = cull

    valid = (~cull) & (frag > 1e-6) & (row(pack.R_FVALID) > 0)
    q['frag'] = torch.where(valid, frag, 0.0)
    q['valid'] = valid

    if not need_depth:
        return q

    if cfg.aggr_rgb_func == C.RGB_HARD:
        # The z-argmin only ranks inside-loose pixels (cu:815-822), where the
        # clipped barycentrics equal the raw ones and sum to 1, so zp =
        # 1/denom: the argmin over zp is an argmax over the affine denom and
        # the [near, far] window is denom in [1/far, 1/near].
        denom = row(pack.R_DZ + 0) * xp + row(pack.R_DZ + 1) * yp \
            + row(pack.R_DZ + 2)
        q['denom'] = denom
        q['zvalid'] = (denom >= 1.0 / par[P_FAR]) \
            & (denom <= 1.0 / par[P_NEAR])
        if need_wcn:
            q['wcn'] = (w0, w1, w2)
    else:
        # clipped barycentrics, depth (cu:807-810)
        wc0 = torch.clamp(w0, 0.0, 1.0)
        wc1 = torch.clamp(w1, 0.0, 1.0)
        wc2 = torch.clamp(w2, 0.0, 1.0)
        s = torch.clamp(wc0 + wc1 + wc2, min=1e-5)
        denom = (wc0 * row(pack.R_IZ + 0) + wc1 * row(pack.R_IZ + 1)
                 + wc2 * row(pack.R_IZ + 2))
        zp = s / denom
        if need_wcn:
            q['wcn'] = (wc0 / s, wc1 / s, wc2 / s)
        q['zp'] = zp
        q['zvalid'] = (zp >= par[P_NEAR]) & (zp <= par[P_FAR])
    if cfg.double_side:
        q['front_ok'] = torch.ones_like(valid)
    else:
        q['front_ok'] = row(pack.R_FRONT) > 0
    return q
