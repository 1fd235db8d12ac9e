"""The port's CDF zoo and t-conorm folds against gendr_tpu.ops on a
linspace (templates: tests/test_distributions.py, tests/test_tconorms.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.ops import distributions as JD
from gendr_tpu.ops import tconorms as JT
from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.ops import tconorms as T

XS = np.linspace(-4.0, 4.0, 161).astype(np.float32)

# (shape, shift) per id: gamma needs a shape; the asymmetric families are
# exercised with a nonzero shift
DIST_PARAMS = {
    C.GAMMA: (2.0, 0.1), C.GAMMA_REV: (1.5, 0.1),
    C.LEVY: (0.0, 0.1), C.LEVY_REV: (0.0, 0.1),
    C.EXPONENTIAL: (0.0, 0.05), C.EXPONENTIAL_REV: (0.0, 0.05),
}


@pytest.mark.parametrize('fid', range(18))
@pytest.mark.parametrize('scale', [1.0, 0.3])
def test_cdf_matches_jax(fid, scale):
    # Tolerance 2e-6: the JAX package evaluates erfc, arctan and arcsin by
    # rational/polynomial approximations (|eps| <= 1.5e-7 for erfc), the
    # port by torch.special.erfc / torch.atan / torch.asin.
    shape, shift = DIST_PARAMS.get(fid, (0.0, 0.0))
    sign = np.where(XS >= 0, 1.0, -1.0).astype(np.float32)
    x = np.abs(XS)
    want = np.asarray(JD.cdf(fid, jnp.asarray(sign), jnp.asarray(x), scale,
                             shape, shift))
    got = D.cdf(fid, torch.from_numpy(sign), torch.from_numpy(x), scale,
                shape, shift).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_cdf_gamma_precomputed_normalizer():
    sign = torch.ones(9)
    x = torch.linspace(0.0, 2.0, 9)
    ginv1 = torch.exp(-torch.lgamma(torch.tensor(3.0)))
    np.testing.assert_array_equal(
        D.cdf(C.GAMMA, sign, x, 0.5, 2.0, 0.0, gamma_inv1=ginv1).numpy(),
        D.cdf(C.GAMMA, sign, x, 0.5, 2.0, 0.0).numpy())


def test_sigmoid_forward_seam():
    for fid in range(18):
        shape, shift = DIST_PARAMS.get(fid, (0.0, 0.0))
        got = D.sigmoid_forward(fid, -1.0, 0.25, 0.5, shape, shift)
        want = JD.sigmoid_forward(fid, -1.0, 0.25, 0.5, shape, shift)
        assert abs(got - want) < 2e-6, fid
    with pytest.raises(ValueError):
        D.cdf(18, torch.ones(1), torch.ones(1), 1.0)


# (id, valid p): every family, parametric ones at two parameters
FOLDS = [
    (JC.MAX_TCN, 0.0), (JC.PROBABILISTIC_TCN, 0.0), (JC.EINSTEIN_TCN, 0.0),
    (JC.HAMACHER_TCN, 0.5), (JC.HAMACHER_TCN, 2.0),
    (JC.FRANK_TCN, 0.5), (JC.FRANK_TCN, 3.0),
    (JC.YAGER_TCN, 0.5), (JC.YAGER_TCN, 2.0),
    (JC.ACZEL_ALSINA_TCN, 0.5), (JC.ACZEL_ALSINA_TCN, 2.0),
    (JC.DOMBI_TCN, 2.0),
    (JC.SCHWEIZER_SKLAR_TCN, -1.0), (JC.SCHWEIZER_SKLAR_TCN, -2.5),
]

# the saturation edges (0, 1 - 1e-9, 1) are where the guards act
VALS = np.concatenate([np.linspace(0.0, 1.0, 41),
                       [1e-7, 1 - 1e-7, 1 - 1e-9]]).astype(np.float32)


@pytest.mark.parametrize('tid,p', FOLDS)
def test_fold_step_matches_jax(tid, p):
    # Tolerance 2e-6 absolute: frank's expm1 is torch.expm1 here and a
    # 7-term Taylor (relative error <= 3.3e-7) in the JAX package; pow/log
    # round differently between the two libraries.
    a, b = np.meshgrid(VALS, VALS, indexing='ij')
    want = np.asarray(JT.fold_step(tid, jnp.asarray(a), jnp.asarray(b), p))
    got = T.fold_step(tid, torch.from_numpy(a), torch.from_numpy(b),
                      p).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # zero is the exact neutral element of every fold
    zero = torch.zeros_like(torch.from_numpy(a))
    np.testing.assert_array_equal(
        T.fold_step(tid, torch.from_numpy(a), zero, p).numpy(), a)
    np.testing.assert_array_equal(
        T.fold_step(tid, zero, torch.from_numpy(b), p).numpy(), b)


def test_t_conorm_forward_seam():
    for tid, p in FOLDS:
        got = T.t_conorm_forward(tid, 0.3, 0.6, 0, p)
        want = JT.t_conorm_forward(tid, 0.3, 0.6, 0, p)
        assert abs(got - want) < 2e-6, (tid, p)
    with pytest.raises(ValueError):
        T.fold_step(10, torch.ones(1), torch.ones(1), 1.0)
