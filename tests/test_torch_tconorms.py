"""The parametric t-conorm folds of the CUDA backend (sub-kernels K1c and
K2c) against gendr_tpu on the CPU.

On CPU tensors ``backend='cuda'`` runs the kernels' plain versions, which
fold a pixel's pairs serially, one ``fold_step`` per face in the order a
kernel thread visits them, and differentiate with ``aggregate_backward``.
They are held, for each of hamacher, frank, yager, aczel_alsina, dombi and
schweizer_sklar at two valid parameters, in alpha-only, hard-RGB and
softmax-RGB renders:

* against ``gendr_tpu``'s ``xla`` backend, image and gradients;
* against the port's own ``backend='torch'``, which keeps the JAX package's
  butterfly grouping of the fold;
* against the Pallas kernels in interpret mode, as tests/test_pallas.py
  runs them;
* two families' gradients against finite differences.

Each family's first parameter runs with the uniform CDF, whose coverage
saturates at exactly 1 (where frank's 1e-6 guard and the 1 - a < 1e-8
saturation of aczel_alsina and dombi act), the second with the logistic.

Tolerances: image max-abs 1e-4 (tests/test_torch_raster.py's); gradients
with tests/test_torch_backward.py's budgeted comparison, atol 2e-4 and
rtol 2e-3 on all but 2 % of the entries.  T-conorms are associative only
in exact arithmetic, so the serial fold and the butterfly differ by
rounding; the ``max(..., 1e-6)`` guards do not change that at these sizes.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster import xla_backend as X
from gendr_tpu_torch import config as C, interop, render
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_render import params_dict, random_scene
from tests.test_torch_backward import (_assert_grads_match, _image_grad,
                                       _port_grads, _xla_grads)
from tests.test_torch_raster import _assert_match, _inputs

J_XF = jax.jit(X.forward, static_argnums=3)

# (family, p, CDF): two valid parameters per family; yager at 0.5 and 4
FOLDS = [('hamacher', 0.5, 'uniform'), ('hamacher', 2.0, 'logistic'),
         ('frank', 2.0, 'uniform'), ('frank', 0.5, 'logistic'),
         ('yager', 0.5, 'uniform'), ('yager', 4.0, 'logistic'),
         ('aczel_alsina', 2.0, 'uniform'), ('aczel_alsina', 0.5, 'logistic'),
         ('dombi', 2.0, 'uniform'), ('dombi', 0.5, 'logistic'),
         ('schweizer_sklar', -2.0, 'uniform'),
         ('schweizer_sklar', -0.5, 'logistic')]
MODES = {'alpha': dict(rgb='hard', channels='alpha'),
         'hard': dict(rgb='hard'), 'softmax': dict(rgb='softmax')}


def _spec(tcn, p, dist, mode):
    return dict(dist=dist, tcn=tcn, p=p, scale=5e-2, **MODES[mode])


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('tcn,p,dist', FOLDS,
                         ids=[f'{t}{p:g}-{d}' for t, p, d in FOLDS])
def test_parametric_fold_plain_matches_xla_and_torch(tcn, p, dist, mode):
    spec = _spec(tcn, p, dist, mode)
    fv, tex, kw, jp, tp = _inputs(spec, 'random')
    tfv, ttex = torch.from_numpy(fv), torch.from_numpy(tex)
    hard_ids = mode == 'hard'

    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), None,
                         JC.RenderConfig.create(**kw), jp)
    launches = dict(CB.LAUNCHES)
    got, got_ag = CB.forward(tfv, ttex,
                             C.RenderConfig.create(backend='cuda', **kw), tp)
    _assert_match(got, got_ag, want, want_ag, hard_ids)
    alpha = got[:, 3]
    assert 0.0 <= float(alpha.min()) and float(alpha.max()) <= 1.0
    assert float(((alpha > 0) & (alpha < 1)).float().mean()) > 0.02
    ref, ref_ag = TB.forward(tfv, ttex, C.RenderConfig.create(**kw), tp)
    _assert_match(got, got_ag, ref.numpy(), ref_ag.numpy(), hard_ids)

    g = _image_grad(spec, fv)
    grads = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    assert CB.LAUNCHES == launches  # CPU: the plain versions
    _assert_grads_match(grads, _xla_grads(fv, tex, kw, jp, g))
    _assert_grads_match(grads, _port_grads(TB, fv, tex, kw, tp, g))
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize('tcn,p,dist,mode', [
    ('hamacher', 0.5, 'uniform', 'alpha'), ('frank', 2.0, 'uniform', 'hard'),
    ('yager', 2.0, 'logistic', 'softmax'),
    ('aczel_alsina', 2.0, 'uniform', 'hard'),
    ('dombi', 2.0, 'logistic', 'alpha'),
    ('schweizer_sklar', -2.0, 'uniform', 'softmax')])
def test_parametric_fold_plain_matches_pallas_interpret(tcn, p, dist, mode):
    """Against the TPU kernels themselves (their 128-lane butterfly fold
    and aggregate-inverse backward), run in interpret mode as
    tests/test_pallas.py runs them (16x16, face_chunk 8, pixel_tile 64)."""
    rng = np.random.RandomState(2)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 1, 3).astype(np.float32)
    g = rng.randn(2, 4, 16, 16).astype(np.float32)
    kw = dict(image_size=16, dist_func=dist, aggr_alpha_func=tcn,
              aggr_rgb_func=MODES[mode]['rgb'], face_chunk=8,
              channels=MODES[mode].get('channels', 'rgba'))
    jp = params_dict(dist_scale=5e-2, aggr_alpha_t_conorm_p=p)
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64, **kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    soft, aggrs, aux = jax.jit(PB.forward_with_aux, static_argnums=2)(
        jfv, jtex, jcfg, jp)
    want = jax.jit(PB.backward_from_aux, static_argnums=6)(
        jfv, jtex, aux, soft, aggrs, jnp.asarray(g), jcfg, jp)
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    got, _ = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex), cfg, tp)
    # winner ids are reported in different orders (Morton rank there, input
    # order here): the image is compared
    assert float(np.abs(got.numpy() - np.asarray(soft)).max()) <= 1e-4
    _assert_grads_match(_port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'},
                                    tp, g), want)


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
@pytest.mark.parametrize('tcn,p', [('yager', 2.0), ('frank', 2.0)])
def test_parametric_fold_gradient_matches_finite_differences(tcn, p,
                                                             backend):
    """Directional derivatives of mean(alpha^2) against central differences
    (h 3e-3), as tests/test_torch_backward.py holds max: the
    aggregate-inverse rule is the fold's true derivative."""
    rng = np.random.RandomState(7)
    fv = torch.from_numpy(random_scene(rng, B=1, F=5).reshape(1, 5, 9))
    tex = torch.ones(1, 5, 1, 3)
    kw = dict(image_size=16, dist_func='logistic', dist_scale=0.1,
              aggr_alpha_func=tcn, aggr_alpha_t_conorm_p=p,
              aggr_rgb_func='hard', face_chunk=8, backend=backend)

    def loss(v):
        return (render(v, tex, **kw)[:, 3] ** 2).mean()

    v = fv.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(v), v)[0]
    h = 3e-3
    for d in np.random.RandomState(0).randn(3, *fv.shape):
        d = torch.from_numpy((d / np.linalg.norm(d)).astype(np.float32))
        fd = float(loss(fv + h * d) - loss(fv - h * d)) / (2 * h)
        assert abs(float((g * d).sum()) - fd) <= 2e-3 * abs(fd), fd
    assert float(loss(fv - 0.05 * g / g.abs().max())) < float(loss(fv))
