"""The ULP probes' op table, kernel wrappers, inputs and comparison.

The render gates compare each CUDA kernel with its plain PyTorch version,
so they rest on how nvcc's build of the device functions of
``csrc/pairmath.cuh`` rounds against PyTorch's ops.  The probes measure
that, one function at a time: ``csrc/ulp_probe.cu`` evaluates an op
elementwise on the card, and the same op written in torch (``OPS`` below,
the kernels' plain versions) is evaluated on the card and on the CPU.  A
list of cases runs in one launch (``run_cases``: the cases' inputs packed
behind a case table, ``pack``).

Port of the shared parts of ``tools/ulp_check.py``, ``tools/ulp_bisect.py``
and ``tools/ulp_smem.py``: their inputs (numpy ``RandomState``, the same
seeds and ranges), their op lists and their bit-for-bit comparison with
the worst inputs.  The JAX tools held Mosaic against XLA; here the two
sides are nvcc and PyTorch.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.ops import distributions as D
from gendr_tpu_torch.ops import tconorms as T

NQ = 5          # parameters of an op (csrc/ulp_probe.cu NQ)
SCALE = 5e-2
PI = math.pi
LN2 = float(np.log(2.0))

# launches of each probe kernel, counted where the wrapper launches it
LAUNCHES = {'ulp_elementwise': 0, 'ulp_param_vector': 0}


def _wig_sq(x):
    return torch.sqrt(torch.clamp(SCALE * SCALE - x * x, min=0.0))


def _kummer(z, recip):
    kum = fac = 0.5  # 1/Gamma(3)
    for i in range(1, 32):
        fac = fac * z * (1.0 / (2.0 + i)) if recip else fac * z / (2.0 + i)
        kum = kum + fac
    return kum


def _eu_plus_inv(y):
    return torch.exp(y) + 1.0 / torch.exp(y)


def _asin_den(x):
    return torch.sqrt(torch.clamp(1.0 - x * x, min=1e-12))


def _f32(v, like):
    """A parameter (a Python float, or an element of the parameter vector)
    as a float32 tensor on like's device: it then enters the arithmetic as
    an operand, as in the port's ops, not as a scalar PyTorch may fold."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _frank_t(a, b, p):
    p = _f32(p, a)
    lnp = torch.log(p)
    return torch.expm1((1.0 - a) * lnp) * torch.expm1((1.0 - b) * lnp) \
        / (p - 1.0)


def _u(s, x, q):
    return s * x / _f32(q[0], x)


def _wigner_sq(x, q):
    scale = _f32(q[0], x)
    return torch.sqrt(torch.clamp(scale * scale - x * x, min=0.0))


def _wigner_full(s, x, q):
    scale = _f32(q[0], x)
    u = s * x / scale
    sq = torch.sqrt(torch.clamp(scale * scale - x * x, min=0.0))
    mid = 0.5 + (s * x * sq) / (PI * scale * scale) \
        + torch.asin(torch.clamp(u, -1.0, 1.0)) / PI
    return torch.where(u < -1.0, 0.0, torch.where(u < 1.0, mid, 1.0))


def _cubic_y(s, x, q):
    return torch.clamp(0.5 * _u(s, x, q) + 0.5, 0.0, 1.0)


class Op(NamedTuple):
    id: int           # the op's id in csrc/ulp_probe.cu (OP_<NAME>)
    kind: str         # 'primitive' (one function or IEEE operation),
    #                   'chain', 'cdf', 'pdf', 'fold' or 'fold_backward'
    torch: Callable   # (x, y, q) -> the op in torch, q the NQ parameters


# name -> op; the torch expressions follow the JAX tools' (and, for the
# first four, are the port's own ops, which the plain versions call)
OPS = {
    'CDF': Op(0, 'cdf', lambda s, x, q: D.cdf(
        int(q[0]), s, x, q[1], q[2], q[3], gamma_inv1=q[4])),
    'PDF': Op(1, 'pdf', lambda s, x, q: D.pdf(
        int(q[0]), s, x, q[1], q[2], q[3], gamma_inv=q[4])),
    'FOLD_STEP': Op(2, 'fold', lambda a, b, q: T.fold_step(
        int(q[0]), a, b, q[1])),
    'AGGREGATE_BACKWARD': Op(3, 'fold_backward', lambda a, b, q:
                             T.aggregate_backward(int(q[0]), a, b, q[1])),
    'FRANK_EA': Op(4, 'chain', lambda a, b, q: torch.expm1(
        (1.0 - a) * torch.log(_f32(q[0], a)))),
    'FRANK_T': Op(5, 'chain', lambda a, b, q: _frank_t(a, b, q[0])),
    'FRANK_C': Op(6, 'chain', lambda a, b, q: torch.log1p(
        _frank_t(a, b, q[0])) / torch.log(_f32(q[0], a))),

    'DIV_CONST': Op(7, 'primitive', lambda x, y, q: x / SCALE),
    'DIV_TRACED': Op(8, 'primitive', lambda x, y, q: x / y),
    'RECIP': Op(9, 'primitive', lambda x, y, q: 1.0 / x),
    'EXP': Op(10, 'primitive', lambda x, y, q: torch.exp(x)),
    'TANH': Op(11, 'primitive', lambda x, y, q: torch.tanh(x)),
    'SQRT': Op(12, 'primitive', lambda x, y, q: torch.sqrt(x)),
    'RSQRT': Op(13, 'primitive', lambda x, y, q: torch.rsqrt(x)),
    'LOG': Op(14, 'primitive', lambda x, y, q: torch.log(x)),
    'POW_1_5': Op(15, 'primitive', lambda x, y, q: torch.pow(x, 1.5)),
    'POW_2': Op(16, 'primitive', lambda x, y, q: torch.pow(x, 2.0)),
    'POW_TRACED': Op(17, 'primitive', lambda x, y, q: torch.pow(
        x, y * 40.0)),
    'MUL_ADD': Op(18, 'primitive', lambda x, y, q: x * y + 0.5),
    'THREE_MUL': Op(19, 'primitive', lambda x, y, q: x * y * x),
    'DIV_CHAIN_CONST': Op(20, 'chain', lambda x, y, q:
                          2.0 / x / PI / SCALE),
    'DIV_CHAIN_TRACED': Op(21, 'chain', lambda x, y, q: 2.0 / x / PI / y),
    'DIV_FOLDED_CONST': Op(22, 'primitive', lambda x, y, q:
                           x / (PI * SCALE * SCALE)),
    'EU_PLUS_INV': Op(23, 'chain', lambda x, y, q: _eu_plus_inv(x)),
    'GUD_PDF_FULL': Op(24, 'chain', lambda x, y, q:
                       2.0 / _eu_plus_inv(x) / PI / SCALE),
    'GUD_PDF_REFACTOR': Op(25, 'chain', lambda x, y, q:
                           2.0 / (_eu_plus_inv(x) * (PI * SCALE))),
    'WIG_SQ': Op(26, 'chain', lambda x, y, q: _wig_sq(x)),
    'WIG_MID': Op(27, 'chain', lambda x, y, q:
                  (x * _wig_sq(x)) / (PI * SCALE * SCALE)),
    'WIG_MID_TRACED': Op(28, 'chain', lambda x, y, q:
                         (x * _wig_sq(x)) / (PI * y * y)),
    'ASIN_CLIP_DIV': Op(29, 'chain', lambda x, y, q: torch.asin(
        torch.clamp(x / SCALE, -1.0, 1.0))),
    'ATAN': Op(30, 'primitive', lambda x, y, q: torch.atan(x)),
    'WIG_FULL': Op(31, 'chain', lambda x, y, q:
                   0.5 + (x * _wig_sq(x)) / (PI * SCALE * SCALE)
                   + torch.asin(torch.clamp(x / SCALE, -1.0, 1.0)) / PI),
    'KUMMER_DIV': Op(32, 'chain', lambda z, y, q: _kummer(z, False)),
    'KUMMER_RECIP': Op(33, 'chain', lambda z, y, q: _kummer(z, True)),
    'POW_EXP': Op(34, 'chain', lambda z, y, q:
                  torch.pow(z, 2.0) * torch.exp(-z)),
    'POW_TRACED_EXP': Op(35, 'chain', lambda z, y, q:
                         torch.pow(z, y * 40.0) * torch.exp(-z)),
    'GAMMA_FULL_DIV': Op(36, 'chain', lambda z, y, q:
                         torch.pow(z, 2.0) * torch.exp(-z)
                         * _kummer(z, False)),
    'GAMMA_FULL_RECIP': Op(37, 'chain', lambda z, y, q:
                           torch.pow(z, 2.0) * torch.exp(-z)
                           * _kummer(z, True)),
    'EXPM1_LN2': Op(38, 'primitive', lambda a, b, q: torch.expm1(
        (1.0 - a) * LN2)),
    'LOG1P': Op(39, 'primitive', lambda a, b, q: torch.log1p(a)),
    'FRANK_C_CONST': Op(40, 'chain', lambda a, b, q: torch.log1p(
        torch.expm1((1.0 - a) * LN2) * torch.expm1((1.0 - b) * LN2)
        / (2.0 - 1.0)) / LN2),

    'U': Op(41, 'chain', _u),
    'X_OVER_SCALE': Op(42, 'primitive', lambda s, x, q: x / _f32(q[0], x)),
    'LOGISTIC': Op(43, 'chain', lambda s, x, q:
                   1.0 / (1.0 + torch.exp(-_u(s, x, q)))),
    'CUBIC_Y': Op(44, 'chain', _cubic_y),
    'CUBIC_FULL': Op(45, 'chain', lambda s, x, q: (
        lambda c: 3.0 * c * c - 2.0 * c * c * c)(_cubic_y(s, x, q))),
    'RECIP_FULL': Op(46, 'chain', lambda s, x, q:
                     _u(s, x, q) / (1.0 + x / _f32(q[0], x)) / 2.0 + 0.5),
    'RECIP_SINGLE_DIV': Op(47, 'chain', lambda s, x, q:
                           0.5 * s * x / (_f32(q[0], x) + x) + 0.5),
    'WIGNER_FULL': Op(48, 'chain', _wigner_full),
    'WIGNER_SQ': Op(49, 'chain', lambda s, x, q: _wigner_sq(x, q)),
    'WIGNER_MID': Op(50, 'chain', lambda s, x, q:
                     (s * x * _wigner_sq(x, q))
                     / (PI * _f32(q[0], x) * _f32(q[0], x))),
    'ASIN_CLIP_U': Op(51, 'chain', lambda s, x, q: torch.asin(
        torch.clamp(_u(s, x, q), -1.0, 1.0))),
    'ATAN_U': Op(52, 'chain', lambda s, x, q: torch.atan(_u(s, x, q))),

    'ONE_MINUS_XX': Op(53, 'primitive', lambda x, y, q: 1.0 - x * x),
    'ASIN_DEN': Op(54, 'chain', lambda x, y, q: _asin_den(x)),
    'ASIN_RATIO': Op(55, 'chain', lambda x, y, q: x / _asin_den(x)),
    'ASIN_ATAN': Op(56, 'chain', lambda x, y, q: torch.atan(
        x / _asin_den(x))),
    'ASIN': Op(57, 'primitive', lambda x, y, q: torch.asin(x)),
    'ASIN_ALT': Op(58, 'chain', lambda x, y, q: torch.atan(
        x / torch.sqrt(torch.clamp((1.0 - x) * (1.0 + x), min=1e-12)))),
}


def _pad_params(q):
    q = [float(v) for v in q]
    if len(q) > NQ:
        raise ValueError(f'an op takes at most {NQ} parameters, got {len(q)}')
    return q + [0.0] * (NQ - len(q))


def _check_inputs(x, y):
    for name, t in (('x', x), ('y', y)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous float32')
    if y.device != x.device or y.shape != x.shape:
        raise ValueError(f'y is {tuple(y.shape)} on {y.device}, x '
                         f'{tuple(x.shape)} on {x.device}')


def ulp_elementwise(op: str, x, y=None, q: Sequence[float] = ()):
    """OPS[op] elementwise on x (and y, of x's shape), float32, with the
    parameters q passed to the kernel by value: a table of one case.

    CUDA tensors launch ``csrc/ulp_probe.cu``'s ulp_elementwise kernel on
    the current stream; CPU tensors evaluate the op's torch expression.
    """
    _check_inputs(x, x if y is None else y)
    return run_cases([Case(op, op, x, y, q)], 'ulp_elementwise',
                     x.device)[0]


def ulp_param_vector(op: str, x, y=None, q=None):
    """OPS[op] elementwise on x (and y), with the parameters of the
    float32 vector q [NQ] on x's device (read to the host) in a table of
    one case, which the kernel reads from device memory inside, the way
    the render kernels read their parameter vector.

    CUDA tensors launch ``csrc/ulp_probe.cu``'s ulp_param_vector kernel;
    CPU tensors evaluate the op's torch expression on q's elements.
    """
    _check_inputs(x, x if y is None else y)
    if q.dtype != torch.float32 or tuple(q.shape) != (NQ,) \
            or q.device != x.device or not q.is_contiguous():
        raise ValueError(f'q must be float32 [{NQ}] on {x.device}')
    return run_cases([Case(op, op, x, y, tuple(q.tolist()))],
                     'ulp_param_vector', x.device)[0]


# -- a table of cases, one launch ----------------------------------------

# one row of the kernels' case table (csrc/ulp_probe.cu ProbeCase): the
# op's id, its elements, the offsets of its x (and output) and y in the
# packed inputs, its parameters
CASE_DTYPE = np.dtype([('op', '<i4'), ('n', '<i4'), ('x', '<i4'),
                       ('y', '<i4'), ('q', '<f4', (NQ,))])
BLOCK_ELEMS = 256    # elements a block takes (csrc/ulp_probe.cu)
TABLE_CASES = 112    # cases of one ulp_elementwise launch (csrc/ulp_probe.cu)
TABLE_ALIGN = 32     # floats: the inputs start on a 128-byte boundary


class Packed(NamedTuple):
    table: np.ndarray   # [cases] CASE_DTYPE
    words: int          # floats the table takes at the buffer's start
    n_in: int           # floats of the inputs after it: every x, each
    #                     rounded up to BLOCK_ELEMS, then every second y
    n_out: int          # floats of the packed output: the x region


def pack(cases) -> Packed:
    """The case table of cases: each x (and its output) at a multiple of
    BLOCK_ELEMS in the order given, then the y of each case that has a
    second input; a case with one input reads its x as y.  The parameters
    are padded to NQ."""
    table = np.zeros(len(cases), CASE_DTYPE)
    x = 0
    for row, c in zip(table, cases):
        row['op'], row['n'], row['x'] = OPS[c.op].id, _numel(c.x), x
        row['q'] = _pad_params(c.q)
        x += -(-int(row['n']) // BLOCK_ELEMS) * BLOCK_ELEMS
    y = x
    for row, c in zip(table, cases):
        if _has_y(c):
            row['y'], y = y, y + int(row['n'])
        else:
            row['y'] = row['x']
    words = -(-table.nbytes // 4 // TABLE_ALIGN) * TABLE_ALIGN
    return Packed(table, words, y, x)


def _numel(a):
    return int(np.prod(a.shape))


def _has_y(case):
    return case.y is not None and case.y is not case.x


def _inputs(cases, packed, device):
    """The table, then every x padded to its block, then every second y,
    as one float32 tensor on device: one copy from the host where the
    inputs are numpy arrays, one concatenation on the card where they are
    tensors there."""
    head = np.zeros(packed.words, np.float32)
    head[:packed.table.nbytes // 4] = packed.table.view(np.float32)
    parts = [head]
    for row, c in zip(packed.table, cases):
        pad = -int(row['n']) % BLOCK_ELEMS
        parts += [c.x, np.zeros(pad, np.float32)] if pad else [c.x]
    parts += [c.y for c in cases if _has_y(c)]
    if all(isinstance(p, np.ndarray) for p in parts):
        return torch.from_numpy(np.concatenate(
            [np.ravel(p).astype(np.float32, copy=False) for p in parts])) \
            .to(device)
    return torch.cat([torch.as_tensor(p, device=device).reshape(-1)
                      for p in parts])


def launches(cases: int, kernel: str) -> int:
    """Launches of kernel for a table of that many cases: ulp_elementwise's
    table is a kernel argument of at most TABLE_CASES cases."""
    return -(-cases // TABLE_CASES) if kernel == 'ulp_elementwise' else 1


def launch(kernel, packed: Packed, inputs, out):
    """Runs kernel over the packed table: inputs is _inputs' tensor on the
    card, out the packed output [n_out].  Counts the launches."""
    from gendr_tpu_torch import _build
    lib = _build.load('ulp_probe')
    table = np.ascontiguousarray(packed.table)
    count = len(table)
    dev_in = inputs.data_ptr() + 4 * packed.words
    tail = (packed.n_in, out.data_ptr(), packed.n_out,
            out.device.index or 0,
            torch.cuda.current_stream(out.device).cuda_stream)
    if kernel == 'ulp_elementwise':
        err = lib.gendr_ulp_elementwise(table.ctypes.data, count, dev_in,
                                        *tail)
    elif kernel == 'ulp_param_vector':
        err = lib.gendr_ulp_param_vector(table.ctypes.data,
                                         inputs.data_ptr(), count, dev_in,
                                         *tail)
    else:
        raise ValueError(f'no probe kernel {kernel!r}')
    if err != 0:
        raise RuntimeError(f'{kernel} launch failed: '
                           + lib.gendr_error_string(err).decode())
    LAUNCHES[kernel] += launches(count, kernel)
    return out


def run_cases(cases, kernel: str, device='cuda'):
    """Every case through one probe kernel ('ulp_elementwise' or
    'ulp_param_vector'): the outputs, one a case, shaped as its x.

    On the card the cases' inputs are packed (``pack``) into one tensor,
    copied to the card once, and the kernel runs the whole table in one
    launch (ulp_elementwise: one a TABLE_CASES cases); the outputs are
    views of one packed tensor.  On the CPU each case evaluates its op's
    torch expression, the parameters as floats for ulp_elementwise and as
    a float32 vector for ulp_param_vector, as each kernel takes them.
    """
    if kernel not in LAUNCHES:
        raise ValueError(f'no probe kernel {kernel!r}')
    device = torch.device(device)
    if device.type == 'cpu':
        outs = []
        for c in cases:
            x = torch.as_tensor(c.x)
            y = torch.as_tensor(c.y) if _has_y(c) else x
            q = _pad_params(c.q)
            if kernel == 'ulp_param_vector':
                q = torch.tensor(q, dtype=torch.float32)
            outs.append(OPS[c.op].torch(x, y, q))
        return outs
    if device.type != 'cuda':
        raise ValueError(f'no probe kernel for device {device}')
    packed = pack(cases)
    out = torch.empty(packed.n_out, dtype=torch.float32, device=device)
    launch(kernel, packed, _inputs(cases, packed, device), out)
    return [out[int(r['x']):int(r['x'] + r['n'])].view(tuple(c.x.shape))
            for r, c in zip(packed.table, cases)]


# -- inputs, as the JAX tools make them ------------------------------------

def dist_inputs(n=8 * 2048, seed=0):
    """(sign, x) pairs concentrated where rendering evaluates the CDF:
    x in [0, ~4 margin], denser near 0 and near the compact-support edge
    x = scale (tools/ulp_check.py:85-102)."""
    rng = np.random.RandomState(seed)
    xs = np.concatenate([
        rng.rand(n // 4).astype(np.float32) * 4.0 * SCALE,
        rng.rand(n // 4).astype(np.float32) * SCALE,           # inside support
        (SCALE * (1.0 + (rng.rand(n // 4).astype(np.float32) - 0.5)
                  * 1e-3)),                                    # support edge
        rng.rand(n // 4).astype(np.float32) * 1e-3 * SCALE,    # near zero
    ]).astype(np.float32)
    signs = np.where(rng.rand(xs.size) < 0.5, 1.0, -1.0).astype(np.float32)
    pad = (-xs.size) % 1024
    xs = np.pad(xs, (0, pad))
    signs = np.pad(signs, (0, pad), constant_values=1.0)
    return signs.reshape(8, -1), xs.reshape(8, -1)


def saturation_inputs():
    """Coverage pairs (a, b), half uniform on [0, 1) and half in the
    saturation band 1 - 1e-5 U (tools/ulp_check.py:151-162)."""
    rng = np.random.RandomState(1)
    a = np.concatenate([
        rng.rand(4096).astype(np.float32),
        1.0 - rng.rand(4096).astype(np.float32) * 1e-5,
    ])
    b = np.concatenate([
        rng.rand(4096).astype(np.float32),
        1.0 - rng.rand(4096).astype(np.float32) * 1e-5,
    ])
    rng.shuffle(a), rng.shuffle(b)
    return (a.astype(np.float32).reshape(8, -1),
            b.astype(np.float32).reshape(8, -1))


DIST_PARAMS = {
    'gamma': dict(shape=2.0),
    'gamma_rev': dict(shape=2.0),
    'levy': dict(shift=0.1),
    'levy_rev': dict(shift=0.1),
    'exponential': dict(shift=0.05),
    'gumbel_max': dict(shift=0.05),
}

ALL_DISTS = ['uniform', 'cubic_hermite', 'wigner_semicircle', 'gaussian',
             'laplace', 'logistic', 'gudermannian', 'cauchy', 'reciprocal',
             'gumbel_max', 'gumbel_min', 'exponential', 'exponential_rev',
             'gamma', 'gamma_rev', 'levy', 'levy_rev']

# one valid parameter per t-conorm family (animations/t_conorms.py:34-37)
T_CONORM_PARAMS = [('max', 0.0), ('probabilistic', 0.0), ('einstein', 0.0),
                   ('hamacher', 0.5), ('frank', 2.0), ('yager', 2.0),
                   ('aczel_alsina', 2.0), ('dombi', 2.0),
                   ('schweizer_sklar', -2.0)]


class Case(NamedTuple):
    name: str
    op: str
    x: np.ndarray
    y: Optional[np.ndarray] = None
    q: tuple = ()


def check_cases(names=ALL_DISTS):
    """ulp_check's cases: cdf and pdf of each distribution on dist_inputs,
    then fold_step and aggregate_backward of every t-conorm on
    saturation_inputs."""
    sign, x = dist_inputs()
    cases = []
    for nm in names:
        kw = DIST_PARAMS.get(nm, {})
        shape, shift = kw.get('shape', 0.0), kw.get('shift', 0.0)
        ginv1 = math.exp(-math.lgamma(shape + 1.0))
        cases.append(Case(f'cdf[{nm}]', 'CDF', sign, x,
                          (C.DIST_FUNC_MAP[nm], SCALE, shape, shift, ginv1)))
    for nm in names:
        kw = DIST_PARAMS.get(nm, {})
        shape, shift = kw.get('shape', 0.0), kw.get('shift', 0.0)
        ginv = math.exp(-math.lgamma(max(shape, 1e-6)))
        cases.append(Case(f'pdf[{nm}]', 'PDF', sign, x,
                          (C.DIST_FUNC_MAP[nm], SCALE, shape, shift, ginv)))
    a, b = saturation_inputs()
    for op in ('FOLD_STEP', 'AGGREGATE_BACKWARD'):
        for nm, p in T_CONORM_PARAMS:
            cases.append(Case(f'{nm} p={p:g} {op.lower()}', op, a, b,
                              (C.AGGR_ALPHA_FUNC_MAP[nm], p)))
    return cases


def bisect_cases():
    """ulp_bisect's cases: primitive operations and chains, parameters as
    constants and as a second input (tools/ulp_bisect.py:67-164)."""
    rng = np.random.RandomState(0)

    def rand(lo, width):
        return rng.rand(8, 2048).astype(np.float32) * np.float32(width) \
            + np.float32(lo)
    x = rand(1e-4, 0.2)
    y = rand(-1.5, 3.0)
    u = rand(-3.0, 6.0)
    svec = np.full((8, 2048), SCALE, np.float32)
    cases = [
        Case('div const: x / 0.05', 'DIV_CONST', x),
        Case('div traced: x / s', 'DIV_TRACED', x, svec),
        Case('recip: 1.0 / x', 'RECIP', x),
        Case('exp(y)', 'EXP', y),
        Case('exp(u) wide', 'EXP', u),
        Case('tanh(y)', 'TANH', y),
        Case('sqrt(x)', 'SQRT', x),
        Case('rsqrt(x)', 'RSQRT', x),
        Case('log(x)', 'LOG', x),
        Case('pow(x, 1.5)', 'POW_1_5', x),
        Case('pow(x, 2.0)', 'POW_2', x),
        Case('pow(x, s) traced', 'POW_TRACED', x, svec),
        Case('mul-add a*b+0.5 (fma shape)', 'MUL_ADD', x, y),
        Case('three-mul x*y*x', 'THREE_MUL', x, y),
        Case('div chain 2/x/pi/0.05', 'DIV_CHAIN_CONST', x),
        Case('div chain traced 2/x/pi/s', 'DIV_CHAIN_TRACED', x, svec),
        Case('div by folded const x/(pi*0.05^2)', 'DIV_FOLDED_CONST', x),
        Case('eu + 1/eu', 'EU_PLUS_INV', y),
        Case('gud-pdf full 2/(eu+1/eu)/pi/0.05', 'GUD_PDF_FULL', y),
        Case('gud-pdf refactor 2/((eu+1/eu)*(pi*0.05))', 'GUD_PDF_REFACTOR',
             y),
    ]
    xs = rand(0.0, SCALE)  # inside support
    cases += [
        Case('wig sq term', 'WIG_SQ', xs),
        Case('wig mid = x*sq/(pi*s^2)', 'WIG_MID', xs),
        Case('wig mid traced s', 'WIG_MID_TRACED', xs, svec),
        Case('arcsin(x/0.05)', 'ASIN_CLIP_DIV', xs),
        Case('arctan(y)', 'ATAN', y),
        Case('wig full', 'WIG_FULL', xs),
    ]
    z = rand(1e-4, 8.0)
    cases += [
        Case('kummer series (div)', 'KUMMER_DIV', z),
        Case('kummer series (recip-mul)', 'KUMMER_RECIP', z),
        Case('z^shape * exp(-z)', 'POW_EXP', z),
        Case('z^shape traced * exp(-z)', 'POW_TRACED_EXP', z, svec),
        Case('gamma full (div kummer)', 'GAMMA_FULL_DIV', z),
        Case('gamma full (recip kummer)', 'GAMMA_FULL_RECIP', z),
    ]
    a = rand(0.0, 1.0)
    b = rand(0.0, 1.0)
    cases += [
        Case('expm1((1-a)*ln2)', 'EXPM1_LN2', a),
        Case('log1p(t)', 'LOG1P', a),
        Case('frank c = log1p(ea*eb/(p-1))/lnp', 'FRANK_C_CONST', a, b),
    ]
    return cases


def smem_cases():
    """ulp_smem's cases: chains whose parameters come from a vector
    [scale, shape] or [p] (tools/ulp_smem.py:84-191)."""
    rng = np.random.RandomState(0)
    par = (SCALE, 2.0)
    x = rng.rand(8, 2048).astype(np.float32) * np.float32(0.2) \
        + np.float32(1e-5)
    s = np.where(rng.rand(8, 2048) < 0.5, 1.0, -1.0).astype(np.float32)
    cases = [
        Case('u = s*x/scale', 'U', s, x, par),
        Case('x/scale', 'X_OVER_SCALE', s, x, par),
        Case('logistic: 1/(1+exp(-u))', 'LOGISTIC', s, x, par),
        Case('cubic y = clip(.5u+.5)', 'CUBIC_Y', s, x, par),
        Case('cubic full 3y^2-2y^3', 'CUBIC_FULL', s, x, par),
        Case('recip full u/(1+x/s)/2+.5', 'RECIP_FULL', s, x, par),
        Case('recip single-div .5*s*x/(scale+x)+.5', 'RECIP_SINGLE_DIV', s,
             x, par),
        Case('wigner full', 'WIGNER_FULL', s, x, par),
        Case('wigner sq', 'WIGNER_SQ', s, x, par),
        Case('wigner mid-term x*sq/(pi*s^2)', 'WIGNER_MID', s, x, par),
        Case('arcsin(clip(u))', 'ASIN_CLIP_U', s, x, par),
        Case('arctan(u)', 'ATAN_U', s, x, par),
        Case('gamma cdf (kummer, shape from the vector)', 'CDF', s, x,
             (C.GAMMA, SCALE, 2.0, 0.0, 0.5)),
    ]
    xc = rng.rand(8, 2048).astype(np.float32) * np.float32(2.0) \
        - np.float32(1.0)
    cases += [
        Case('asin: 1 - x*x', 'ONE_MINUS_XX', xc),
        Case('asin: den = sqrt(max(1-x*x, 1e-12))', 'ASIN_DEN', xc),
        Case('asin: x/den', 'ASIN_RATIO', xc),
        Case('asin: arctan(x/den)', 'ASIN_ATAN', xc),
        Case('asin: full arcsin(x)', 'ASIN', xc),
        Case('asin alt: den2 = (1-x)*(1+x)', 'ASIN_ALT', xc),
    ]

    def band(seed):
        v = np.concatenate([
            rng.rand(8192).astype(np.float32),
            1.0 - rng.rand(8192).astype(np.float32) * 1e-5,
        ]).astype(np.float32)
        return v[np.random.RandomState(seed).permutation(16384)] \
            .reshape(8, 2048)
    av, bv = band(3), band(4)
    cases += [
        Case('frank fold_step (p from the vector)', 'FOLD_STEP', av, bv,
             (C.FRANK_TCN, 2.0)),
        Case('frank aggregate_backward (p from the vector)',
             'AGGREGATE_BACKWARD', av, bv, (C.FRANK_TCN, 2.0)),
        Case('frank ea=expm1((1-a)*log(p))', 'FRANK_EA', av, bv, (2.0,)),
        Case('frank ea*eb/(p-1)', 'FRANK_T', av, bv, (2.0,)),
        Case('frank log1p(t)/lnp', 'FRANK_C', av, bv, (2.0,)),
    ]
    return cases


# -- comparison -------------------------------------------------------------

def ulp_distance(a, b):
    """Per-element distance in float32 steps between two arrays (int64),
    as the JAX tools count it: the difference of the bit patterns."""
    ia = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


class Diff(NamedTuple):
    n_differ: int     # elements whose bits differ
    max_ulp: int
    max_abs: float
    max_rel: float    # largest |got - want| / max(|want|, 1)
    worst: tuple      # (flat index, got, want, ulp) of the largest
    #                   ulp distances

    def __str__(self):
        if not self.n_differ:
            return 'BITWISE'
        return (f'{self.n_differ} DIFFER max_ulp={self.max_ulp} '
                f'max_abs={self.max_abs:.3g}')


def diff(got, want, report_worst=3) -> Diff:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    differ = got.view(np.uint32) != want.view(np.uint32)
    # two NaNs of different payload are the same answer
    differ &= ~(np.isnan(got) & np.isnan(want))
    n = int(differ.sum())
    if not n:
        return Diff(0, 0, 0.0, 0.0, ())
    ulp = np.where(differ, ulp_distance(got, want), 0)
    with np.errstate(invalid='ignore'):
        err = np.where(differ, np.abs(got.astype(np.float64) - want), 0.0)
    err = np.nan_to_num(err, nan=np.inf)
    rel = err / np.maximum(np.abs(np.nan_to_num(want.astype(np.float64))),
                           1.0)
    worst = tuple((int(i), float(got.ravel()[i]), float(want.ravel()[i]),
                   int(ulp.ravel()[i]))
                  for i in np.argsort(-ulp.ravel())[:report_worst]
                  if differ.ravel()[i])
    return Diff(n, int(ulp.max()), float(err.max()), float(rel.max()), worst)


class Result(NamedTuple):
    case: Case
    kernel: str
    card: Diff        # kernel vs the torch expression on the card
    cpu: Diff         # kernel vs the torch expression on the CPU


def compare(cases, kernel: str, outs) -> list:
    """A Result for each case's kernel output in outs (tensors on the
    card): against its torch expression on the card, the parameters as
    the kernel takes them, and on the CPU.  The kernel's outputs and the
    card's torch outputs are fetched to the host once each."""
    device = outs[0].device
    want_card = []
    for c in cases:
        x = torch.as_tensor(c.x, device=device)
        y = torch.as_tensor(c.y, device=device) if _has_y(c) else x
        q = _pad_params(c.q)
        if kernel == 'ulp_param_vector':
            q = torch.tensor(q, dtype=torch.float32, device=device)
        want_card.append(OPS[c.op].torch(x, y, q))
    got, want_card = (_split(torch.cat([t.reshape(-1) for t in ts]).cpu()
                             .numpy(), cases) for ts in (outs, want_card))
    want_cpu = run_cases(cases, 'ulp_elementwise', 'cpu')
    return [Result(c, kernel, diff(g, w), diff(g, cpu.numpy()))
            for c, g, w, cpu in zip(cases, got, want_card, want_cpu)]


def _split(flat, cases):
    """flat, the cases' outputs end to end, cut into one array a case."""
    ends = np.cumsum([_numel(c.x) for c in cases])
    return [flat[e - _numel(c.x):e].reshape(c.x.shape)
            for c, e in zip(cases, ends)]


def report(result: Result, file=None):
    """One line per result, and under it the inputs of the worst elements
    against the torch expression on the card."""
    c = result.case
    print(f'  {c.name:<50s} card: {result.card} | cpu: {result.cpu}',
          file=file, flush=True)
    y = c.x if c.y is None else c.y
    for i, got, want, ulp in result.card.worst:
        print(f'      in=[{c.x.ravel()[i]:.9g}, {y.ravel()[i]:.9g}] '
              f'torch={want:.9g} kernel={got:.9g} ulp={ulp}', file=file,
              flush=True)


def main(title, cases, kernel):
    """A probe command line: every case through one kernel on the card,
    in one launch (``run_cases``), against its torch expression on the
    card and on the CPU.  Returns the exit code: 1 without a card, else
    0."""
    if not torch.cuda.is_available():
        print(f'{title}: torch.cuda.is_available() is False; the probes '
              f'compare a CUDA kernel with torch and need an NVIDIA GPU',
              file=sys.stderr)
        return 1
    print(f'== {title}: {kernel} vs torch on '
          f'{torch.cuda.get_device_name(0)} and on the CPU ==')
    results = compare(cases, kernel, run_cases(cases, kernel))
    for r in results:
        report(r)
    n_card = sum(r.card.n_differ > 0 for r in results)
    n_cpu = sum(r.cpu.n_differ > 0 for r in results)
    print(f'{len(results)} ops: {len(results) - n_card} bitwise with torch '
          f'on the card, {len(results) - n_cpu} with torch on the CPU')
    return 0
