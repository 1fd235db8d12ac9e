"""The ULP probes of the port (gendr_tpu_torch.tools) on the CPU.

The probe kernels run only on the card (tests/test_torch_kernels.py holds
them against torch there).  Here:

* the op table and ``csrc/ulp_probe.cu`` agree on every op id;
* each op's torch expression, the kernels' plain version, is held against
  the JAX function or expression it mirrors (``D.cdf``, ``D.pdf``,
  ``T.fold_step``, ``T.aggregate_backward`` and the chains of
  tools/ulp_bisect.py and tools/ulp_smem.py) on the tools' own inputs;
* on CPU tensors both wrappers evaluate that expression and launch nothing;
* the case table that runs a whole probe phase in one launch: its rows
  against ``OPS`` and the cases, the packed inputs under the kernels'
  block-to-case rule, ``run_cases`` on the CPU against the one-case
  wrappers, and the table's layout and the C entries' signatures against
  ``csrc/ulp_probe.cu``;
* the three command lines exit 1 without a card.

Tolerances, per kind of op, as |got - want| <= tol * max(|want|, 1): a few
float32 steps at 1.  cdf and fold 2e-6 (tests/test_torch_ops.py's: the JAX
package's erfc, arctan, arcsin and expm1 are polynomial approximations,
torch's are libm's); pdf, the primitive operations and the chains 1e-5
(tests/test_torch_ops.py's for the PDFs: a chain divides by the scale
5e-2 or sums 32 series terms).  The aggregate-inverse rules divide by
1 - b or by frank's 1e-6 guard, and the tools' inputs put half the
operands within 1e-5 of 1 and feed an `a_all` that is no aggregate of `b`,
so the two libraries' last ulp of 1 - b is amplified up to 1e5-fold there:
they are held to 1e-5 off that band (1 - b >= 1e-3 and 1 - a >= 1e-3) and
only to finiteness-agreement on it.  The wigner semicircle's cdf and pdf
are likewise held off the support's edge (|1 - x / scale| >= 1e-2; a
quarter of the tool's inputs sit within 5e-4 of it), where
sqrt(scale^2 - x^2) cancels (the JAX package squares a Python float scale
in double, the port a float32 one) and the square root's and the
arcsine's slopes grow without bound.
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu.ops import distributions as JD
from gendr_tpu.ops import tconorms as JT
from gendr_tpu_torch import _build
from gendr_tpu_torch.tools import _ulp, ulp_bisect, ulp_check, ulp_smem
from torch_threads import one_torch_thread  # noqa: F401

SCALE, PI, LN2 = _ulp.SCALE, _ulp.PI, _ulp.LN2
TOL = dict(cdf=2e-6, fold=2e-6, pdf=1e-5, fold_backward=1e-5,
           primitive=1e-5, chain=1e-5)


def test_op_ids_match_the_cuda_source():
    src = (_build.CSRC / 'ulp_probe.cu').read_text()
    ids = {name: int(val) for name, val in
           re.findall(r'\bOP_([A-Z0-9_]+) = (\d+),', src)}
    assert ids == {name: op.id for name, op in _ulp.OPS.items()}
    assert sorted(ids.values()) == list(range(len(ids)))
    assert f'NUM_OPS = {len(ids)}' in src
    assert f'constexpr int NQ = {_ulp.NQ};' in src
    assert '#include "pairmath.cuh"' in src
    # every case of the three tools names an op of the table and fits NQ
    cases = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()
    assert len(cases) == 111
    assert {c.op for c in cases} == set(_ulp.OPS)
    assert all(len(c.q) <= _ulp.NQ and c.x.dtype == np.float32
               and c.x.shape[0] == 8 for c in cases)


def _jsq(x):
    return jnp.sqrt(jnp.maximum(SCALE * SCALE - x * x, 0.0))


def _jkummer(z, recip):
    kum = fac = 0.5
    for i in range(1, 32):
        fac = fac * z * (1.0 / (2.0 + i)) if recip else fac * z / (2.0 + i)
        kum = kum + fac
    return kum


def _jeu(y):
    return jnp.exp(y) + 1.0 / jnp.exp(y)


def _jden(x):
    return jnp.sqrt(jnp.maximum(1.0 - x * x, 1e-12))


def _jfrank_t(a, b, p):
    lnp = jnp.log(jnp.float32(p))
    return JT._expm1((1.0 - a) * lnp) * JT._expm1((1.0 - b) * lnp) \
        / (jnp.float32(p) - 1.0)


def _jwigner(s, x, q):
    scale = jnp.float32(q[0])
    u = s * x / scale
    sq = jnp.sqrt(jnp.maximum(scale * scale - x * x, 0.0))
    mid = 0.5 + (s * x * sq) / (PI * scale * scale) \
        + JD.arcsin(jnp.clip(u, -1.0, 1.0)) / PI
    return jnp.where(u < -1.0, 0.0, jnp.where(u < 1.0, mid, 1.0))


def _ju(s, x, q):
    return s * x / jnp.float32(q[0])


# the JAX side of every op: the package's functions for the first four,
# the expressions of tools/ulp_bisect.py and tools/ulp_smem.py for the rest
JAX_OPS = {
    'CDF': lambda s, x, q: JD.cdf(int(q[0]), s, x, q[1], q[2], q[3],
                                  gamma_inv1=q[4]),
    'PDF': lambda s, x, q: JD.pdf(int(q[0]), s, x, q[1], q[2], q[3],
                                  gamma_inv=q[4]),
    'FOLD_STEP': lambda a, b, q: JT.fold_step(int(q[0]), a, b, q[1]),
    'AGGREGATE_BACKWARD': lambda a, b, q: JT.aggregate_backward(
        int(q[0]), a, b, q[1]),
    'FRANK_EA': lambda a, b, q: JT._expm1(
        (1.0 - a) * jnp.log(jnp.float32(q[0]))),
    'FRANK_T': lambda a, b, q: _jfrank_t(a, b, q[0]),
    'FRANK_C': lambda a, b, q: jnp.log1p(_jfrank_t(a, b, q[0]))
    / jnp.log(jnp.float32(q[0])),
    'DIV_CONST': lambda x, y, q: x / SCALE,
    'DIV_TRACED': lambda x, y, q: x / y,
    'RECIP': lambda x, y, q: 1.0 / x,
    'EXP': lambda x, y, q: jnp.exp(x),
    'TANH': lambda x, y, q: jnp.tanh(x),
    'SQRT': lambda x, y, q: jnp.sqrt(x),
    'RSQRT': lambda x, y, q: jax.lax.rsqrt(x),
    'LOG': lambda x, y, q: jnp.log(x),
    'POW_1_5': lambda x, y, q: jnp.power(x, 1.5),
    'POW_2': lambda x, y, q: jnp.power(x, 2.0),
    'POW_TRACED': lambda x, y, q: jnp.power(x, y * 40.0),
    'MUL_ADD': lambda x, y, q: x * y + 0.5,
    'THREE_MUL': lambda x, y, q: x * y * x,
    'DIV_CHAIN_CONST': lambda x, y, q: 2.0 / x / PI / SCALE,
    'DIV_CHAIN_TRACED': lambda x, y, q: 2.0 / x / PI / y,
    'DIV_FOLDED_CONST': lambda x, y, q: x / (PI * SCALE * SCALE),
    'EU_PLUS_INV': lambda x, y, q: _jeu(x),
    'GUD_PDF_FULL': lambda x, y, q: 2.0 / _jeu(x) / PI / SCALE,
    'GUD_PDF_REFACTOR': lambda x, y, q: 2.0 / (_jeu(x) * (PI * SCALE)),
    'WIG_SQ': lambda x, y, q: _jsq(x),
    'WIG_MID': lambda x, y, q: (x * _jsq(x)) / (PI * SCALE * SCALE),
    'WIG_MID_TRACED': lambda x, y, q: (x * _jsq(x)) / (PI * y * y),
    'ASIN_CLIP_DIV': lambda x, y, q: JD.arcsin(
        jnp.clip(x / SCALE, -1.0, 1.0)),
    'ATAN': lambda x, y, q: JD.arctan(x),
    'WIG_FULL': lambda x, y, q: 0.5 + (x * _jsq(x)) / (PI * SCALE * SCALE)
    + JD.arcsin(jnp.clip(x / SCALE, -1.0, 1.0)) / PI,
    'KUMMER_DIV': lambda z, y, q: _jkummer(z, False),
    'KUMMER_RECIP': lambda z, y, q: _jkummer(z, True),
    'POW_EXP': lambda z, y, q: jnp.power(z, 2.0) * jnp.exp(-z),
    'POW_TRACED_EXP': lambda z, y, q: jnp.power(z, y * 40.0) * jnp.exp(-z),
    'GAMMA_FULL_DIV': lambda z, y, q: jnp.power(z, 2.0) * jnp.exp(-z)
    * _jkummer(z, False),
    'GAMMA_FULL_RECIP': lambda z, y, q: jnp.power(z, 2.0) * jnp.exp(-z)
    * _jkummer(z, True),
    'EXPM1_LN2': lambda a, b, q: JT._expm1((1.0 - a) * LN2),
    'LOG1P': lambda a, b, q: jnp.log1p(a),
    'FRANK_C_CONST': lambda a, b, q: jnp.log1p(
        JT._expm1((1.0 - a) * LN2) * JT._expm1((1.0 - b) * LN2)
        / (2.0 - 1.0)) / LN2,
    'U': _ju,
    'X_OVER_SCALE': lambda s, x, q: x / jnp.float32(q[0]),
    'LOGISTIC': lambda s, x, q: 1.0 / (1.0 + jnp.exp(-_ju(s, x, q))),
    'CUBIC_Y': lambda s, x, q: jnp.clip(0.5 * _ju(s, x, q) + 0.5, 0.0, 1.0),
    'CUBIC_FULL': lambda s, x, q: (lambda c: 3.0 * c * c - 2.0 * c * c * c)(
        jnp.clip(0.5 * _ju(s, x, q) + 0.5, 0.0, 1.0)),
    'RECIP_FULL': lambda s, x, q: _ju(s, x, q)
    / (1.0 + x / jnp.float32(q[0])) / 2.0 + 0.5,
    'RECIP_SINGLE_DIV': lambda s, x, q: 0.5 * s * x
    / (jnp.float32(q[0]) + x) + 0.5,
    'WIGNER_FULL': _jwigner,
    'WIGNER_SQ': lambda s, x, q: jnp.sqrt(jnp.maximum(
        jnp.float32(q[0]) * jnp.float32(q[0]) - x * x, 0.0)),
    'WIGNER_MID': lambda s, x, q: (s * x * jnp.sqrt(jnp.maximum(
        jnp.float32(q[0]) * jnp.float32(q[0]) - x * x, 0.0)))
    / (PI * jnp.float32(q[0]) * jnp.float32(q[0])),
    'ASIN_CLIP_U': lambda s, x, q: JD.arcsin(
        jnp.clip(_ju(s, x, q), -1.0, 1.0)),
    'ATAN_U': lambda s, x, q: JD.arctan(_ju(s, x, q)),
    'ONE_MINUS_XX': lambda x, y, q: 1.0 - x * x,
    'ASIN_DEN': lambda x, y, q: _jden(x),
    'ASIN_RATIO': lambda x, y, q: x / _jden(x),
    'ASIN_ATAN': lambda x, y, q: JD.arctan(x / _jden(x)),
    'ASIN': lambda x, y, q: JD.arcsin(x),
    'ASIN_ALT': lambda x, y, q: JD.arctan(x / jnp.sqrt(jnp.maximum(
        (1.0 - x) * (1.0 + x), 1e-12))),
}

CASES = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()


@pytest.mark.parametrize('case', CASES, ids=[c.name for c in CASES])
def test_torch_expression_matches_jax(case):
    assert set(JAX_OPS) == set(_ulp.OPS)
    x = case.x
    y = case.x if case.y is None else case.y
    q = _ulp._pad_params(case.q)
    got = _ulp.OPS[case.op].torch(torch.from_numpy(x), torch.from_numpy(y),
                                  q).numpy()
    want = np.asarray(JAX_OPS[case.op](jnp.asarray(x), jnp.asarray(y), q))
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    kind = _ulp.OPS[case.op].kind
    keep = np.ones(x.shape, bool)
    if kind == 'fold_backward':
        keep = (1.0 - x >= 1e-3) & (1.0 - y >= 1e-3)
        assert keep.mean() > 0.2
        # on the saturation band: finite on one side, finite on the other
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    if 'wigner_semicircle' in case.name:
        keep = np.abs(1.0 - y / SCALE) >= 1e-2
        assert keep.mean() > 0.7
    both = keep & np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got[keep]),
                                  np.isfinite(want[keep]))
    err = np.abs(got[both].astype(np.float64) - want[both])
    bound = TOL[kind] * np.maximum(np.abs(want[both]), 1.0)
    assert (err <= bound).all(), _worst_element(case, x, y, q, got, want,
                                                both, err, bound)


def _worst_element(case, x, y, q, got, want, both, err, bound):
    """The failure message: the worst element's inputs and both sides'
    values, and which side gives another value when run again (a one-off
    failure once left that unsaid)."""
    i = int(np.argmax(err - bound))
    again = dict(
        torch=_ulp.OPS[case.op].torch(torch.from_numpy(x),
                                      torch.from_numpy(y), q).numpy(),
        jax=np.asarray(JAX_OPS[case.op](jnp.asarray(x), jnp.asarray(y), q)))
    moved = [side for side, first in (('torch', got), ('jax', want))
             if not np.array_equal(again[side], first, equal_nan=True)]
    return (f'{case.name}: {int((err > bound).sum())} of {err.size} '
            f'elements beyond the bound; the worst at x={float(x[both][i])!r}'
            f' y={float(y[both][i])!r}: got (the port, torch) '
            f'{float(got[both][i])!r}, want (the reference, jax) '
            f'{float(want[both][i])!r}, |difference| {err[i]:.3g} against '
            f'{bound[i]:.3g}; run again, the side that moves: '
            f'{moved or "neither"}')


def test_wrappers_run_the_torch_expression_on_cpu_tensors():
    launches = dict(_ulp.LAUNCHES)
    a, b = (torch.from_numpy(v) for v in _ulp.saturation_inputs())
    q = (6, 2.0)  # yager p=2
    want = _ulp.OPS['FOLD_STEP'].torch(a, b, _ulp._pad_params(q))
    np.testing.assert_array_equal(
        _ulp.ulp_elementwise('FOLD_STEP', a, b, q).numpy(), want.numpy())
    qv = torch.tensor(_ulp._pad_params(q))
    np.testing.assert_array_equal(
        _ulp.ulp_param_vector('FOLD_STEP', a, b, qv).numpy(), want.numpy())
    # one input: y defaults to x
    np.testing.assert_array_equal(_ulp.ulp_elementwise('EXP', a).numpy(),
                                  torch.exp(a).numpy())
    assert _ulp.LAUNCHES == launches
    with pytest.raises(ValueError, match='float32'):
        _ulp.ulp_elementwise('EXP', a.double())
    with pytest.raises(ValueError, match='y is'):
        _ulp.ulp_elementwise('DIV_TRACED', a, b[:4])
    with pytest.raises(ValueError, match='at most'):
        _ulp.ulp_elementwise('EXP', a, q=(1.0,) * 6)
    with pytest.raises(ValueError, match='q must be'):
        _ulp.ulp_param_vector('EXP', a, q=torch.zeros(3))


def test_diff_counts_bits_ulps_and_ignores_nan_pairs():
    want = np.array([1.0, 2.0, np.nan, 0.5], np.float32)
    assert str(_ulp.diff(want, want)) == 'BITWISE'
    got = want.copy()
    got[1] = np.nextafter(np.float32(2.0), np.float32(3.0))
    got[3] = np.nextafter(np.nextafter(np.float32(0.5), np.float32(1.0)),
                          np.float32(1.0))
    d = _ulp.diff(got, want)
    assert (d.n_differ, d.max_ulp) == (2, 2)
    assert d.worst[0][0] == 3 and d.worst[0][3] == 2
    # one step at 2.0 is 2^-22, two steps at 0.5 are 2^-23
    assert d.max_abs == pytest.approx(2 ** -22, rel=1e-6)
    assert d.max_rel == pytest.approx(2 ** -22 / 2.0, rel=1e-6)


@pytest.mark.parametrize('tool', [ulp_check, ulp_bisect, ulp_smem],
                         ids=['ulp_check', 'ulp_bisect', 'ulp_smem'])
def test_probe_command_lines_exit_1_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert tool.main([]) == 1
    assert 'NVIDIA GPU' in capsys.readouterr().err


def _c_type(decl):
    """The ctypes type _build binds a C parameter or return type to."""
    import ctypes
    decl = decl.strip()
    if decl.startswith('const char*'):
        return ctypes.c_char_p
    return ctypes.c_void_p if '*' in decl else ctypes.c_int


C_ENTRIES = sorted(_build.SIGNATURES['ulp_probe'])


@pytest.mark.parametrize('fn', C_ENTRIES)
def test_c_signatures_match_the_cuda_source(fn):
    # each extern "C" function of csrc/ulp_probe.cu, parameter for
    # parameter, against the ctypes types _build.SIGNATURES binds it with
    src = (_build.CSRC / 'ulp_probe.cu').read_text()
    m = re.search(r'extern "C" ([\w\s\*]+?)\s*\b' + fn
                  + r'\(([^)]*)\)', src)
    assert m, fn
    params = [p for p in m.group(2).split(',') if p.strip()]
    argtypes, restype = _build.SIGNATURES['ulp_probe'][fn]
    assert tuple(_c_type(p) for p in params) == argtypes
    assert _c_type(m.group(1)) == restype


def test_case_table_layout_matches_the_cuda_source():
    src = (_build.CSRC / 'ulp_probe.cu').read_text()
    body = re.search(r'struct ProbeCase \{(.*?)\};', src, re.S).group(1)
    fields = re.findall(r'^\s*(int|float) (\w+)(\[NQ\])?;', body, re.M)
    assert [(t, n) for t, n, _ in fields] == [
        ('int', 'op'), ('int', 'n'), ('int', 'x'), ('int', 'y'),
        ('float', 'q')]
    assert _ulp.CASE_DTYPE.names == ('op', 'n', 'x', 'y', 'q')
    assert _ulp.CASE_DTYPE['q'].shape == (_ulp.NQ,)
    assert f'sizeof(ProbeCase) == {_ulp.CASE_DTYPE.itemsize}' in src
    threads = re.search(r'constexpr int PROBE_THREADS = (\d+);', src)
    assert int(threads.group(1)) == _ulp.BLOCK_ELEMS
    assert 'constexpr int BLOCK_ELEMS = PROBE_THREADS;' in src
    assert f'constexpr int TABLE_CASES = {_ulp.TABLE_CASES};' in src
    # the by-value table: two pointers, count, block0 and the cases within
    # the 4 KB of a launch's parameters
    assert 2 * 8 + 8 + _ulp.TABLE_CASES * _ulp.CASE_DTYPE.itemsize <= 4096
    cases = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()
    assert _ulp.launches(len(cases), 'ulp_elementwise') == 1
    assert _ulp.launches(len(cases), 'ulp_param_vector') == 1
    assert _ulp.launches(_ulp.TABLE_CASES + 1, 'ulp_elementwise') == 2
    assert _ulp.launches(_ulp.TABLE_CASES + 1, 'ulp_param_vector') == 1


def _ragged_cases():
    """Cases whose element counts are no multiple of a block, one input
    and two, and a case whose y is its x."""
    rng = np.random.RandomState(3)
    a, b, c = (rng.rand(n).astype(np.float32) for n in (1000, 3000, 1))
    return [_ulp.Case('ragged exp', 'EXP', a),
            _ulp.Case('ragged fold', 'FOLD_STEP', b, rng.rand(3000)
                      .astype(np.float32), (6, 2.0)),
            _ulp.Case('one element', 'DIV_TRACED', c, c),
            _ulp.Case('cdf', 'CDF', a, a[::-1].copy(), (1, 0.05, 0, 0, 1))]


PACK_SETS = dict(phase=CASES, ragged=_ragged_cases())


@pytest.mark.parametrize('name', sorted(PACK_SETS))
def test_case_table_packs_every_case(name):
    cases = PACK_SETS[name]
    packed = _ulp.pack(cases)
    t = packed.table
    ids = {n: op.id for n, op in _ulp.OPS.items()}
    assert t['op'].tolist() == [ids[c.op] for c in cases]
    assert t['n'].tolist() == [c.x.size for c in cases]
    # the x's (and outputs) follow each other, each rounded up to a block
    blocks = -(-t['n'] // _ulp.BLOCK_ELEMS)
    assert t['x'].tolist() == ((np.cumsum(blocks) - blocks)
                               * _ulp.BLOCK_ELEMS).tolist()
    assert packed.n_out == int(blocks.sum()) * _ulp.BLOCK_ELEMS
    # the second inputs after them, in order; one input reads its x as y
    two = [c.y is not None and c.y is not c.x for c in cases]
    ys = t['y'][two]
    assert ys.tolist() == (packed.n_out + np.cumsum(t['n'][two])
                           - t['n'][two]).tolist()
    assert (t['y'][~np.array(two)] == t['x'][~np.array(two)]).all()
    assert packed.n_in == packed.n_out + int(t['n'][two].sum())
    # parameters padded to NQ
    for row, c in zip(t, cases):
        assert row['q'].dtype == np.float32
        np.testing.assert_array_equal(
            row['q'], np.float32(_ulp._pad_params(c.q)))
    assert packed.words % _ulp.TABLE_ALIGN == 0
    assert packed.words * 4 >= t.nbytes
    # the packed buffer: the table's bytes, then the inputs where the table
    # says; the kernels' rule (a block takes BLOCK_ELEMS elements of the last
    # case whose x is at most its first element) reads every element of
    # every case once
    buf = _ulp._inputs(cases, packed, 'cpu').numpy()
    assert buf.size == packed.words + packed.n_in
    assert buf[:t.nbytes // 4].tobytes() == t.tobytes()
    inputs = buf[packed.words:]
    seen = [np.zeros(c.x.size, int) for c in cases]
    for b in range(packed.n_out // _ulp.BLOCK_ELEMS):
        start = b * _ulp.BLOCK_ELEMS
        k = int((t['x'] <= start).sum()) - 1
        i = np.arange(start - t['x'][k],
                      start - t['x'][k] + _ulp.BLOCK_ELEMS)
        i = i[i < t['n'][k]]
        c = cases[k]
        np.testing.assert_array_equal(inputs[t['x'][k] + i],
                                      c.x.ravel()[i])
        y = c.x if c.y is None else c.y
        np.testing.assert_array_equal(inputs[t['y'][k] + i], y.ravel()[i])
        seen[k][i] += 1
    assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize('kernel', ['ulp_elementwise', 'ulp_param_vector'])
def test_run_cases_on_cpu_equals_the_one_case_wrappers(kernel):
    launches = dict(_ulp.LAUNCHES)
    cases = CASES + _ragged_cases()
    outs = _ulp.run_cases(cases, kernel, 'cpu')
    assert len(outs) == len(cases)
    for c, got in zip(cases, outs):
        x = torch.from_numpy(c.x)
        y = None if c.y is None else torch.from_numpy(c.y)
        if kernel == 'ulp_elementwise':
            want = _ulp.ulp_elementwise(c.op, x, y, c.q)
        else:
            want = _ulp.ulp_param_vector(
                c.op, x, y, torch.tensor(_ulp._pad_params(c.q)))
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy(), c.name)
    assert _ulp.LAUNCHES == launches
    with pytest.raises(ValueError, match='no probe kernel'):
        _ulp.run_cases(cases[:1], 'ulp_smem', 'cpu')
