"""The 18-distribution CDF zoo of the generalized differentiable renderer.

``cdf`` maps a signed pixel-to-face distance to a per-face coverage
probability ("soft fragment").  Port of ``gendr_tpu/ops/distributions.py``;
the function ids and formulas (every guard constant and early-out
threshold) mirror the reference CUDA implementation
(``gendr/cuda/generalized_renderer_cuda_kernel.cu:242-363``).  The CUDA
forward kernel (``csrc/rasterize_fwd.cu``) carries the same switch.

The JAX package carries its own erfc/arctan/arcsin approximations because
Mosaic has no lowering for them; here they are ``torch.special.erfc``,
``torch.atan`` and ``torch.asin``.  ``pdf`` comes with the backward kernel.

Conventions (same as the reference):
  * ``x`` is the non-negative distance magnitude; ``sign`` is +1 inside the
    triangle, -1 outside.
  * ``scale`` is tau; ``shape``/``shift`` parametrize gamma/levy/exponential.
"""

from __future__ import annotations

import math

import torch

from gendr_tpu_torch import config as C

_PI = math.pi


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _safe_exp(x):
    # exp with clipped input: keeps untaken torch.where branches finite
    return torch.exp(torch.clamp(x, -87.0, 87.0))


def cdf(dist_func: int, sign, x, scale, shape=0.0, shift=0.0,
        gamma_inv1=None):
    """CDF of the selected distribution evaluated at sign*x with scale tau.

    Matches ``sigmoid_forward_cuda`` (cu:242-363) branch by branch.
    ``gamma_inv1`` optionally supplies 1/Gamma(shape+1) precomputed outside.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    sign = _f32(sign, x)
    scale = _f32(scale, x)
    u = sign * x / scale

    if dist_func == C.HEAVISIDE:
        return torch.where(sign > 0, 1.0, 0.0).expand_as(u)

    if dist_func == C.LOGISTIC:
        return 1.0 / (1.0 + _safe_exp(-u))

    if dist_func == C.CAUCHY:
        return torch.atan(u) / _PI + 0.5

    if dist_func == C.RECIPROCAL:
        # cu:261's u/(1 + x/scale)/2 + 0.5 with one divide, as the JAX
        # package writes it
        return 0.5 * sign * x / (scale + x) + 0.5

    if dist_func == C.LAPLACE:
        e = 0.5 * _safe_exp(-x / scale)
        return torch.where(sign < 0, e, 1.0 - e)

    if dist_func == C.UNIFORM:
        return torch.clamp(0.5 * u + 0.5, 0.0, 1.0)

    if dist_func == C.GUDERMANNIAN:
        return torch.atan(torch.tanh(u / 2.0)) * 2.0 / _PI + 0.5

    if dist_func == C.CUBIC_HERMITE:
        y = torch.clamp(0.5 * u + 0.5, 0.0, 1.0)
        return 3.0 * y * y - 2.0 * y * y * y

    if dist_func == C.GAUSSIAN:
        # normcdf(u) = 0.5*erfc(-u/sqrt(2)) (cu:293)
        return 0.5 * torch.special.erfc(-u / math.sqrt(2.0))

    if dist_func in (C.GAMMA, C.GAMMA_REV):
        return _gamma_cdf(dist_func, sign, x, scale, shape, shift,
                          gamma_inv1)

    if dist_func == C.WIGNER_SEMICIRCLE:
        # cu:320-327; in-branch |x| < scale so the sqrt argument is >= 0
        sq = torch.sqrt(torch.clamp(scale * scale - x * x, min=0.0))
        mid = 0.5 + (sign * x * sq) / (_PI * scale * scale) \
            + torch.asin(torch.clamp(u, -1.0, 1.0)) / _PI
        return torch.where(u < -1.0, 0.0, torch.where(u < 1.0, mid, 1.0))

    if dist_func == C.GUMBEL_MAX:
        return _safe_exp(-_safe_exp(-u))

    if dist_func == C.GUMBEL_MIN:
        return 1.0 - _safe_exp(-_safe_exp(u))

    shift = _f32(shift, x)
    if dist_func in (C.LEVY, C.LEVY_REV):
        if dist_func == C.LEVY:
            xs = sign * x + shift * scale
        else:
            xs = -(sign * x - shift * scale)  # cu:343
        lo = xs <= 1e-6
        xs_safe = torch.clamp(xs, min=1e-6)
        y = torch.special.erfc(torch.sqrt(scale / 2.0 / xs_safe))
        if dist_func == C.LEVY:
            return torch.where(lo, 0.0, y)
        return torch.where(lo, 1.0, 1.0 - y)

    if dist_func in (C.EXPONENTIAL, C.EXPONENTIAL_REV):
        if dist_func == C.EXPONENTIAL:
            xs = sign * x + shift * scale
        else:
            xs = -(sign * x - shift * scale)
        lo = xs < 0.0
        y = 1.0 - _safe_exp(-torch.clamp(xs, min=0.0) / scale)
        if dist_func == C.EXPONENTIAL:
            return torch.where(lo, 0.0, y)
        return torch.where(lo, 1.0, 1.0 - y)

    raise ValueError(f'unknown dist_func id: {dist_func}')


def _gamma_cdf(dist_func, sign, x, scale, shape, shift, gamma_inv1=None):
    """Regularized lower incomplete gamma via the same 32-term Kummer
    (confluent hypergeometric) series as the reference (cu:295-318):

        P(p, z) = z^p e^{-z} * sum_{i>=0} z^i / Gamma(p+1+i)
    """
    shift = _f32(shift, x)
    if dist_func == C.GAMMA:
        xs = sign * x + shift * scale
    else:
        xs = -(sign * x - shift * scale)  # cu:306
    zero_out = xs <= 0.0
    z = torch.clamp(xs, min=1e-30) / scale
    saturate = z > C.GAMMA_THRESHOLD

    shape = _f32(shape, x)
    # 1 / Gamma(p+1) = exp(-lgamma(p+1)); p >= 0 enforced by caller
    inv_gamma_p1 = torch.exp(-torch.lgamma(shape + 1.0)) \
        if gamma_inv1 is None else _f32(gamma_inv1, x)
    kummers = inv_gamma_p1
    factor = inv_gamma_p1
    for i in range(1, C.NUM_STEPS_GAMMA):
        factor = factor * z / (shape + i)
        kummers = kummers + factor
    y = torch.pow(z, shape) * _safe_exp(-z) * kummers
    y = torch.where(saturate, 1.0, y)
    y = torch.where(zero_out, 0.0, y)
    if dist_func == C.GAMMA:
        return y
    return 1.0 - y


def sigmoid_forward(function_id, sign, x, scale=1.0, dist_shape=-10.0,
                    dist_shift=-10.0):
    """Scalar CDF seam (the reference's pybind export,
    generalized_renderer_cuda.cpp:195-237)."""
    return float(cdf(int(function_id), sign, x, scale, dist_shape,
                     dist_shift))
