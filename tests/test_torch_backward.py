"""The port's gradient against gendr_tpu's on the CPU.

* ``torch_backend.backward`` against ``xla_backend.backward`` for every RGB
  mode and texture type and a distribution x t-conorm subset in which
  every alpha family but max appears;
* ``cuda_backend``'s backward (on the CPU its kernel wrapper runs the
  kernel's plain version) against ``xla`` across the backward kernel's
  envelope (the four alpha families, ``dist_squared`` both ways, alpha and
  hard RGB with one texel), and against the Pallas kernel in interpret
  mode;
* ``torch.autograd.grad`` of the port's ``render`` against ``jax.grad`` of
  ``gendr_tpu.render``, through both port backends.

Each backend's backward reads its own forward's image, as in training.
Tolerance: tests/test_pallas.py's budgeted comparison, atol 2e-4 and rtol
2e-3 on all but 2 % of the entries, and no outlier beyond 3 % of the
largest gradient.  The two libraries classify a pair within an ulp of a
triangle edge, of the 1e-6 probability cull, or of a compact-support PDF's
edge differently, which flips that pair's contribution.

The max t-conorm finds its winner by exact float equality between the
final alpha and the recomputed coverage (cu:574-575).  That holds within
the port's forward/backward pairs, which run the same eager float32 ops,
but not within the JAX package's on the CPU, whose separately jitted
forward and backward programs may fuse (and round) differently
(tests/test_pallas.py:89-96): 13-48 % of its max gradient entries then
differ from the port's.  So max is held against the port's other backend
and against finite differences instead.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster import xla_backend as X
from gendr_tpu.raster.render import render as jrender
from gendr_tpu_torch import config as C, interop, render
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_pallas import _assert_mostly_close
from tests.test_render import params_dict, random_scene
from tests.test_torch_raster import _inputs, sphere_scene
from torch_threads import one_torch_thread  # noqa: F401

J_XF = jax.jit(X.forward, static_argnums=3)
J_XB = jax.jit(X.backward, static_argnums=6)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


def _xla_grads(fv, tex, kw, jp, g):
    jcfg = JC.RenderConfig.create(**kw)
    fv, tex = jnp.asarray(fv), jnp.asarray(tex)
    soft, aggrs = J_XF(fv, tex, None, jcfg, jp)
    return J_XB(fv, tex, None, soft, aggrs, jnp.asarray(g), jcfg, jp)


def _port_grads(backend, fv, tex, kw, tp, g):
    cfg = C.RenderConfig.create(**kw)
    fv, tex = torch.from_numpy(fv), torch.from_numpy(tex)
    soft, aggrs, aux = backend.forward_with_aux(fv, tex, cfg, tp)
    return backend.backward_from_aux(fv, tex, aux, soft, aggrs,
                                     torch.from_numpy(g), cfg, tp)


def _assert_grads_match(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        if i == 1 and a.shape[2] > 1:
            # a pixel within an ulp of a texel boundary moves its whole
            # texture gradient to the neighbouring texel: the per-face sum
            # over texels is held to the bulk tolerance, the texels to the
            # flip budget alone
            _assert_mostly_close(a.sum(2), b.sum(2), **GRAD_TOL)
            _assert_mostly_close(a, b, flip_cap_frac=1.0, **GRAD_TOL)
        else:
            _assert_mostly_close(a, b, **GRAD_TOL)


def _image_grad(spec, fv):
    size = 24 if fv.shape[1] == 13 else 32
    rng = np.random.RandomState(spec.get('seed', 0) + 100)
    return rng.randn(fv.shape[0], 4, size, size).astype(np.float32)


# every RGB mode x texture type, then a distribution x t-conorm subset in
# which every alpha family appears
TORCH_SPECS = [
    dict(dist='uniform', tcn='probabilistic', rgb='hard'),
    dict(dist='logistic', tcn='probabilistic', rgb='hard', ts=4),
    dict(dist='logistic', tcn='einstein', rgb='hard', texture_type='vertex'),
    dict(dist='uniform', tcn='probabilistic', rgb='softmax'),
    dict(dist='cubic_hermite', tcn='hard', rgb='softmax', ts=4),
    dict(dist='logistic', tcn='einstein', rgb='softmax',
         texture_type='vertex', double_side=False),
    dict(dist='gumbel_min', tcn='probabilistic', rgb='softmax',
         channels='alpha'),
    dict(dist='wigner_semicircle', tcn='hamacher', p=0.5, rgb='softmax'),
    dict(dist='laplace', tcn='frank', p=2.0, rgb='hard'),
    dict(dist='gudermannian', tcn='yager', p=2.0, rgb='hard'),
    dict(dist='cauchy', tcn='aczel_alsina', p=1.0, rgb='hard',
         squared=True),
    dict(dist='reciprocal', tcn='dombi', p=2.0, rgb='softmax'),
    dict(dist='gumbel_max', tcn='schweizer_sklar', p=-1.0, rgb='hard',
         shift=0.05),
    dict(dist='gamma', tcn='probabilistic', rgb='softmax', shape=2.0),
    dict(dist='levy', tcn='probabilistic', rgb='hard', shift=0.1),
    dict(dist='exponential_rev', tcn='einstein', rgb='softmax',
         shift=0.05),
    dict(dist='hard', tcn='hard', rgb='hard'),
]


@pytest.mark.parametrize(
    'spec', TORCH_SPECS,
    ids=lambda s: f"{s['dist']}-{s['tcn']}-{s['rgb']}-"
                  f"{s.get('texture_type', 'surface')}{s.get('ts', 1)}")
def test_torch_backward_matches_xla(spec):
    fv, tex, kw, jp, tp = _inputs(spec, 'random')
    g = _image_grad(spec, fv)
    want = _xla_grads(fv, tex, kw, jp, g)
    got = _port_grads(TB, fv, tex, kw, tp, g)
    _assert_grads_match(got, want)
    if spec['dist'] != 'hard':
        assert float(got[0].abs().max()) > 0


# the backward kernel's envelope: each alpha family once in hard RGB
# (dist_squared off) and once in alpha-only (dist_squared on)
KERNEL_SPECS = [
    dict(dist=dist, tcn=tcn, rgb='hard', squared=squared,
         channels='alpha' if squared else 'rgba', scale=5e-2)
    for tcn, dist in (('hard', 'logistic'), ('max', 'gaussian'),
                      ('probabilistic', 'uniform'), ('einstein', 'cauchy'))
    for squared in (False, True)]


@pytest.mark.parametrize('scene', ['random', 'sphere'])
@pytest.mark.parametrize(
    'spec', KERNEL_SPECS,
    ids=lambda s: f"{s['dist']}-{s['tcn']}-{s['channels']}"
                  f"{'-squared' if s['squared'] else ''}")
def test_cuda_backward_plain_matches_xla(spec, scene):
    fv, tex, kw, jp, tp = _inputs(spec, scene)
    g = _image_grad(spec, fv)
    if spec['tcn'] == 'max':
        want = _port_grads(TB, fv, tex, kw, tp, g)  # see the module doc
    else:
        want = _xla_grads(fv, tex, kw, jp, g)
    launches = dict(CB.LAUNCHES)
    got = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    assert CB.LAUNCHES == launches  # CPU: the plain versions
    _assert_grads_match(got, want)
    assert float(got[0].abs().max()) > 0


def test_cuda_backward_plain_matches_pallas_interpret():
    """Against the TPU backward kernel itself, run in interpret mode as
    tests/test_pallas.py runs it (16x16, face_chunk 8, pixel_tile 64)."""
    rng = np.random.RandomState(1)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 1, 3).astype(np.float32)
    g = rng.randn(2, 4, 16, 16).astype(np.float32)
    kw = dict(image_size=16, dist_func='uniform',
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
              face_chunk=8)
    jp = params_dict(dist_scale=5e-2)
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64, **kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    soft, aggrs, aux = jax.jit(PB.forward_with_aux, static_argnums=2)(
        jfv, jtex, jcfg, jp)
    want = jax.jit(PB.backward_from_aux, static_argnums=6)(
        jfv, jtex, aux, soft, aggrs, jnp.asarray(g), jcfg, jp)
    got = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    _assert_grads_match(got, want)


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_autograd_matches_jax_grad(backend):
    """torch.autograd.grad(render) against jax.grad(gendr_tpu.render) of
    0.5 sum(alpha^2) + 0.1 sum(rgb) (tools/tpu_selfcheck.py:380-382)."""
    fv = sphere_scene()
    tex = np.random.RandomState(3).rand(2, fv.shape[1], 1, 3) \
        .astype(np.float32)
    kw = dict(image_size=32, dist_func='logistic', dist_scale=3e-2,
              aggr_alpha_func='probabilistic', aggr_rgb_func='hard',
              face_chunk=16)

    def jloss(v, t):
        img = jrender(v, t, backend='xla', **kw)
        return 0.5 * jnp.sum(img[:, 3] ** 2) + 0.1 * jnp.sum(img[:, :3])

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(fv),
                                                    jnp.asarray(tex))
    tfv = torch.from_numpy(fv).requires_grad_(True)
    ttex = torch.from_numpy(tex).requires_grad_(True)
    img = render(tfv, ttex, backend=backend, **kw)
    loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
    got = torch.autograd.grad(loss, (tfv, ttex))
    _assert_grads_match(got, want)
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_max_tconorm_gradient_matches_finite_differences(backend):
    """Directional derivatives of mean(alpha^2) with the max t-conorm
    against central differences (h 3e-3), on separate random triangles as
    tests/test_pallas.py:283 uses: a closed mesh has faces whose coverages
    tie exactly across a shared silhouette edge, where the reference's
    exact-equality rule (cu:574-575) sends the gradient to both."""
    rng = np.random.RandomState(7)
    fv = torch.from_numpy(random_scene(rng, B=1, F=5).reshape(1, 5, 9))
    tex = torch.ones(1, 5, 1, 3)
    kw = dict(image_size=16, dist_func='logistic', dist_scale=0.1,
              aggr_alpha_func='max', aggr_rgb_func='hard', face_chunk=8,
              backend=backend)

    def loss(v):
        return (render(v, tex, **kw)[:, 3] ** 2).mean()

    v = fv.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(v), v)[0]
    h = 3e-3
    for d in np.random.RandomState(0).randn(3, *fv.shape):
        d = torch.from_numpy((d / np.linalg.norm(d)).astype(np.float32))
        fd = float(loss(fv + h * d) - loss(fv - h * d)) / (2 * h)
        assert abs(float((g * d).sum()) - fd) <= 2e-3 * abs(fd), fd
    # and a step against the gradient descends
    assert float(loss(fv - 0.05 * g / g.abs().max())) < float(loss(fv))
