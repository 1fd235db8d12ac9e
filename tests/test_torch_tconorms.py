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
  runs them (tests/test_torch_tconorms_pallas.py);
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
from gendr_tpu.raster import xla_backend as X
from gendr_tpu_torch import config as C, render
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_render import random_scene
from tests.test_torch_backward import (_assert_grads_match, _image_grad,
                                       _port_grads, _xla_grads)
from tests.test_torch_raster import _assert_match, _inputs
from torch_threads import one_torch_thread  # noqa: F401

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
