"""T-conorm zoo: 9 soft OR operators for alpha-channel aggregation.

Port of ``gendr_tpu/ops/tconorms.py``.  ``fold_step`` is the binary
t-conorm used in the streaming fold over faces; formulas mirror the
reference CUDA implementation (``gendr/cuda/generalized_renderer_cuda_kernel.cu:473-563``)
including every ``max(..., 1e-6)`` guard, and frank's ``p**(1-a) - 1``
terms are ``expm1((1-a) * log(p))`` as in the JAX package (the same
function without the powf cancellation at the a -> 1 saturation edge).
``aggregate_backward`` comes with the backward kernel.

Folding with ``b = 0`` is the identity for every t-conorm here, which is
what makes masked (culled) faces drop out of the aggregation.
"""

from __future__ import annotations

import torch

from gendr_tpu_torch import config as C


def _zero_identity(a, b, res):
    """Exact neutral-element fold: a ⊥ 0 = a and 0 ⊥ b = b, bitwise.

    0 is the neutral element of every t-conorm, but the parametric
    families' arithmetic only reproduces it up to rounding (frank's
    log1p(expm1(t)) round trip, yager's pow round trip).  With the exact
    identity, a chunk of culled faces folds to nothing in every backend,
    whatever grouping its fold tree uses.
    """
    return torch.where(b == 0.0, a, torch.where(a == 0.0, b, res))


def fold_step(t_conorm_id: int, a, b, p=0.0):
    """a ⊥ b for the selected t-conorm (cu:473-563)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)

    if t_conorm_id == C.MAX_TCN:
        return torch.maximum(a, b)

    if t_conorm_id == C.PROBABILISTIC_TCN:
        return a + b - a * b

    if t_conorm_id == C.EINSTEIN_TCN:
        return (a + b) / (1.0 + a * b)

    p = torch.as_tensor(p, dtype=torch.float32, device=a.device)

    if t_conorm_id == C.HAMACHER_TCN:  # p >= 0
        an, bn = 1.0 - a, 1.0 - b
        c = (an * bn) / torch.clamp(p + (1.0 - p) * (an + bn - an * bn),
                                    min=1e-6)
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.FRANK_TCN:  # p > 0, p != 1
        lnp = torch.log(p)
        ea = torch.expm1((1.0 - a) * lnp)
        eb = torch.expm1((1.0 - b) * lnp)
        c = torch.log1p(ea * eb / (p - 1.0)) / lnp
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.YAGER_TCN:  # p > 0
        c = torch.clamp(
            1.0 - torch.pow(torch.pow(a, p) + torch.pow(b, p), 1.0 / p),
            min=0.0)
        return _zero_identity(a, b, 1.0 - c)

    if t_conorm_id == C.ACZEL_ALSINA_TCN:  # p > 0
        an, bn = 1.0 - a, 1.0 - b
        an_s = torch.clamp(an, min=1e-30)
        bn_s = torch.clamp(bn, min=1e-30)
        c = torch.exp(-torch.pow(
            torch.pow(-torch.log(an_s), p) + torch.pow(-torch.log(bn_s), p),
            1.0 / p))
        # cu:528-529: if 1-a < 1e-8 (or 1-b) the result saturates to 1
        res = torch.where((an < 1e-8) | (bn < 1e-8), 1.0, 1.0 - c)
        return _zero_identity(a, b, res)

    if t_conorm_id == C.DOMBI_TCN:  # p > 0
        an, bn = 1.0 - a, 1.0 - b
        an_s = torch.clamp(an, min=1e-30)
        bn_s = torch.clamp(bn, min=1e-30)
        c = 1.0 / (1.0 + torch.pow(
            torch.pow((1.0 - an_s) / an_s, p)
            + torch.pow((1.0 - bn_s) / bn_s, p), 1.0 / p))
        res = torch.where((an < 1e-8) | (bn < 1e-8), 1.0, 1.0 - c)
        return _zero_identity(a, b, res)

    if t_conorm_id == C.SCHWEIZER_SKLAR_TCN:  # p < 0
        an = torch.clamp(1.0 - a, min=1e-30)
        bn = torch.clamp(1.0 - b, min=1e-30)
        c = torch.pow(torch.pow(an, p) + torch.pow(bn, p) - 1.0, 1.0 / p)
        return _zero_identity(a, b, 1.0 - c)

    raise ValueError(f'unknown t_conorm id: {t_conorm_id}')


def t_conorm_forward(t_conorm_id, a_existing, b_new, face_id=0,
                     t_conorm_p=0.0):
    """Scalar fold seam (the reference's pybind export,
    generalized_renderer_cuda.cpp:211-237)."""
    return float(fold_step(int(t_conorm_id), a_existing, b_new, t_conorm_p))
