"""T-conorm zoo: 9 soft OR operators for alpha-channel aggregation.

Port of ``gendr_tpu/ops/tconorms.py``.  ``fold_step`` is the binary
t-conorm used in the streaming fold over faces; ``aggregate_backward`` is
the reference's aggregate-inverse gradient rule: dA/db_i is rebuilt from
the total aggregate A and b_i alone, so no per-face partial products are
stored.  Formulas mirror the reference CUDA implementation
(``gendr/cuda/generalized_renderer_cuda_kernel.cu:473-614``) including
every ``max(..., 1e-6)`` guard, and frank's ``p**(1-a) - 1`` terms are
``expm1((1-a) * log(p))`` as in the JAX package (the same function without
the powf cancellation at the a -> 1 saturation edge).

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


def aggregate_backward(t_conorm_id: int, a_all, b, p=0.0):
    """dA/db_i reconstructed from the total aggregate A = a_all and b_i
    alone (cu:566-614), with every guard of the reference."""
    a_all = torch.as_tensor(a_all, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a_all.device)

    if t_conorm_id == C.MAX_TCN:
        # exact float equality, as in the reference (cu:574-575)
        return torch.where(a_all == b, 1.0, 0.0)

    if t_conorm_id == C.PROBABILISTIC_TCN:
        return (1.0 - a_all) / torch.clamp(1.0 - b, min=1e-6)

    if t_conorm_id == C.EINSTEIN_TCN:
        return (1.0 - a_all * a_all) / torch.clamp(1.0 - b * b, min=1e-6)

    p = torch.as_tensor(p, dtype=torch.float32, device=a_all.device)

    if t_conorm_id == C.HAMACHER_TCN:
        num = (1.0 - a_all) * (-a_all - p * (1.0 - a_all) + p + 1.0)
        den = (1.0 - b) * (-b - p * (1.0 - b) + p + 1.0)
        return num / torch.clamp(den, min=1e-6)

    if t_conorm_id == C.FRANK_TCN:
        # cu:586-589's powf differences, as expm1 (same guard scale)
        lnp = torch.log(p)
        d = torch.expm1((1.0 - b) * lnp)
        d_guard = d + torch.where(d >= 0, 1e-6, -1e-6)  # copysign(1e-6, d)
        return torch.exp((a_all - b) * lnp) \
            * torch.expm1((1.0 - a_all) * lnp) / d_guard

    if t_conorm_id == C.YAGER_TCN:
        b_s = torch.clamp(b, min=1e-30)
        a_s = torch.clamp(a_all, min=1e-30)
        val = torch.pow(b_s, p - 1.0) * torch.pow(a_s, 1.0 - p)
        return torch.where(a_all == 1.0, 0.0, val)

    if t_conorm_id == C.ACZEL_ALSINA_TCN:
        log_b = -torch.log1p(torch.clamp(-b, min=-1.0 + 1e-6))
        log_a = -torch.log1p(torch.clamp(-a_all, min=-1.0 + 1e-6))
        return (1.0 - a_all) \
            * torch.pow(torch.clamp(log_b, min=1e-30), p - 1.0) \
            * torch.pow(torch.clamp(log_a, min=1e-30), 1.0 - p) \
            / torch.clamp(1.0 - b, min=1e-6)

    if t_conorm_id == C.DOMBI_TCN:
        bn = torch.clamp(1.0 - b, min=1e-6)
        an = torch.clamp(1.0 - a_all, min=1e-6)
        b_s = torch.clamp(b, min=1e-30)
        a_s = torch.clamp(a_all, min=1e-30)
        return (1.0 - a_all) * (1.0 - a_all) \
            * torch.pow(b_s / bn, p - 1.0) \
            * torch.pow(a_s / an, 1.0 - p) / bn / bn

    if t_conorm_id == C.SCHWEIZER_SKLAR_TCN:
        an = torch.clamp(1.0 - a_all, min=1e-6)
        bn = torch.clamp(1.0 - b, min=1e-6)
        bp = torch.pow(bn, p)
        ap = torch.pow(an, p)
        inner = torch.pow(torch.pow(-bp + ap + 1.0, 1.0 / p), p)
        return torch.pow(bn, p - 1.0) \
            * torch.pow(bp + inner - 1.0, (1.0 - p) / p)

    raise ValueError(f'unknown t_conorm id: {t_conorm_id}')


def t_conorm_forward(t_conorm_id, a_existing, b_new, face_id=0,
                     t_conorm_p=0.0):
    """Scalar fold seam (the reference's pybind export,
    generalized_renderer_cuda.cpp:211-237)."""
    return float(fold_step(int(t_conorm_id), a_existing, b_new, t_conorm_p))


def t_conorm_backward(t_conorm_id, a_all, b_current, number_of_faces=0,
                      t_conorm_p=0.0):
    """Scalar aggregate-inverse seam (the reference's pybind export)."""
    return float(aggregate_backward(int(t_conorm_id), a_all, b_current,
                                    t_conorm_p))
