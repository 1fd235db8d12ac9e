"""The pair count the rooflines are held to: from the problem (each
face's screen-space bbox widened by the cull margin, the pixel centres in
it), equal to a brute-force count over every pixel and face, and equal to
the count the program's own gate gives from its packed rows, whatever its
face_chunk and compaction."""

import numpy as np
import pytest
import torch

from benchmark import problem
from benchmark.reference import raster as R


def scene(seed=0, B=2, F=40):
    rng = np.random.RandomState(seed)
    centre = rng.uniform(-0.9, 0.9, (B, F, 1, 2))
    xy = centre + rng.uniform(-0.25, 0.25, (B, F, 3, 2))
    z = rng.uniform(2.0, 3.0, (B, F, 3, 1))
    return torch.as_tensor(np.concatenate([xy, z], -1), dtype=torch.float32)


def brute(xy, S, m):
    c = (2 * torch.arange(S, dtype=torch.float64) + 1 - S) / S
    x = c[None, None, None, :]
    y = c[None, None, :, None]
    lo = xy.double().amin(2) - m
    hi = xy.double().amax(2) + m
    inx = (x >= lo[..., 0, None, None]) & (x <= hi[..., 0, None, None])
    iny = (y >= lo[..., 1, None, None]) & (y <= hi[..., 1, None, None])
    return float((inx & iny).sum())


@pytest.mark.parametrize('S,dist,tau,eps', [(16, 'logistic', 0.1, 100),
                                            (16, 'logistic', 1e-3, 100),
                                            (24, 'uniform', 10 ** -1.5, 300),
                                            (16, 'heaviside', 1.0, 0)])
def test_count_equals_brute_force(S, dist, tau, eps):
    xy = scene()[..., :2]
    m = R.cull_margin(dist, tau, eps)
    assert R.count_pairs(xy, S, m) == brute(xy, S, m)


def _program_count(fv, S, tau, face_chunk, compact):
    from gendr_tpu_torch import GenDR
    from gendr_tpu_torch.raster import cuda_backend as CB
    from gendr_tpu_torch.raster import pack, render as RR
    from gendr_tpu_torch.raster import pairmath as PM
    g = GenDR(image_size=S, dist_func='logistic', dist_scale=tau,
              dist_eps=100, aggr_rgb_func='hard', channels='alpha',
              face_chunk=face_chunk)
    cfg, params = RR.render_config(**g.render_kwargs(), compact=compact)
    tex = torch.zeros(fv.shape[0], fv.shape[1], 1, 3)
    aux = CB.prepass(fv.reshape(fv.shape[0], fv.shape[1], 9), tex, cfg,
                     params)
    pk = aux['packed'][:, :, :CB.sorted_face_count(aux)].double()
    m = float(aux['par'][PM.P_MARGIN])

    def centres(lo, hi):
        a = torch.ceil(((lo - m) * S + S - 1) / 2).clamp(0, S)
        b = torch.floor(((hi + m) * S + S - 1) / 2).clamp(-1, S - 1)
        return (b - a + 1).clamp(min=0)
    nx = centres(pk[:, pack.R_BBOX + 0], pk[:, pack.R_BBOX + 1])
    ny = centres(pk[:, pack.R_BBOX + 2], pk[:, pack.R_BBOX + 3])
    return float((nx * ny * (pk[:, pack.R_FVALID] > 0)).sum())


@pytest.mark.parametrize('face_chunk,compact', [(128, 'off'), (128, 'auto'),
                                                (64, 'off'), (32, 'off')])
def test_count_is_the_programs_gate(face_chunk, compact):
    fv = scene(1, B=2, F=150)
    S, tau = 32, 1e-2
    ours = R.count_pairs(fv[..., :2], S, R.cull_margin('logistic', tau, 100))
    assert ours == _program_count(fv, S, tau, face_chunk, compact)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert problem.bound_s(67e12, 0) == pytest.approx(1.0)
    assert problem.bound_s(0, 3.35e12) == pytest.approx(1.0)
    w = problem.render_work(1e9, 200, 1280, 64)
    assert problem.bound_s(w['fwd_flops'], w['fwd_bytes']) == \
        pytest.approx(73e9 / 67e12)
