"""The port's two raster backends against gendr_tpu on the CPU.

* ``torch_backend.forward`` against ``xla_backend.forward`` for every RGB
  mode and texture type and a stratified distribution x t-conorm subset;
* the CUDA backend (on the CPU its kernel wrapper runs the kernel's plain
  version) against ``xla`` across the kernel's envelope, and against the
  Pallas kernel in interpret mode;
* the envelope, the eager checks and the missing backward raise.

Tolerances: image max-abs 1e-4, and winner face ids equal on >= 99.9 % of
covered pixels.  The two libraries round transcendentals differently
(gaussian's erfc is an A&S approximation in gendr_tpu), and the
probabilistic/einstein folds multiply in another order (per face in the
kernel's plain version, a butterfly per chunk in the JAX package); a pixel
within an ulp of a shared edge can change its winner.  The plain backend's
zoo sweep also gets a budget of 1 % of pixels beyond 1e-4: a pair whose
coverage sits within an ulp of the 1e-6 probability cull (cu:784), or a
pixel on a texel boundary, changes discontinuously, and softmax RGB
weights a front face's 1e-6 coverage by exp(depth gap / gamma).  The
kernel's envelope is held without that budget.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu import data
from gendr_tpu.geometry import core as JG, transforms as JT
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster import xla_backend as X
from gendr_tpu_torch import config as C, interop, render
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_render import random_scene, params_dict

IMG_ATOL = 1e-4
WINNER_AGREE = 0.999

J_XF = jax.jit(X.forward, static_argnums=3)
J_PF = jax.jit(PB.forward, static_argnums=3)


def sphere_scene(B=2, level=1):
    """icosphere(level) x0.8 seen from two eyes at 32x32: a closed mesh, so
    every silhouette pixel lies near shared edges."""
    v, f = data.icosphere(level)
    verts = jnp.asarray(v)[None] * 0.8
    eyes = jnp.stack([JT.get_points_from_angles(2.732, 30.0, 45.0 + 90 * i)
                      for i in range(B)])
    verts = JT.perspective(JT.look_at(jnp.tile(verts, (B, 1, 1)), eyes),
                           30.0)
    fv = JG.face_vertices(verts, jnp.tile(jnp.asarray(f)[None], (B, 1, 1)))
    return np.array(fv).reshape(B, -1, 9)


def _inputs(spec, scene):
    rng = np.random.RandomState(spec.get('seed', 0))
    if scene == 'random':
        fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
        size = 24
    else:
        fv = sphere_scene()
        size = 32
    B, F = fv.shape[:2]
    tt = spec.get('texture_type', 'surface')
    ts = 3 if tt == 'vertex' else spec.get('ts', 1)
    tex = rng.rand(B, F, ts, 3).astype(np.float32)
    kw = dict(image_size=size, dist_func=spec['dist'],
              dist_squared=spec.get('squared', False),
              aggr_alpha_func=spec['tcn'], aggr_rgb_func=spec['rgb'],
              texture_type=tt, double_side=spec.get('double_side', True),
              face_chunk=spec.get('face_chunk', 8),
              channels=spec.get('channels', 'rgba'))
    jp = params_dict(dist_scale=spec.get('scale', 3e-2),
                     dist_shape=spec.get('shape', 0.0),
                     dist_shift=spec.get('shift', 0.0),
                     aggr_alpha_t_conorm_p=spec.get('p', 0.0),
                     aggr_rgb_gamma=spec.get('gamma', 1e-3),
                     background_color=np.array([0.1, 0.2, 0.3]))
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return fv, tex, kw, jp, tp


def _assert_match(got, got_ag, want, want_ag, hard_ids, flip_budget=0.0):
    got, got_ag = got.numpy(), got_ag.numpy()
    want, want_ag = np.asarray(want), np.asarray(want_ag)
    assert got.shape == want.shape
    err = np.abs(got - want).max(axis=1)  # per pixel, over RGBA
    assert (err > IMG_ATOL).mean() <= flip_budget, \
        (err.max(), (err > IMG_ATOL).sum())
    if hard_ids:
        ids, ref = got_ag[:, 1], want_ag[:, 1]
        covered = (ids >= 0) | (ref >= 0)
        agree = (ids == ref)[covered].mean()
        assert covered.sum() > 50
        assert agree >= WINNER_AGREE, (agree, (ids != ref)[covered].sum())
        both = covered & (ids == ref)
        np.testing.assert_allclose(got_ag[:, 0][both], want_ag[:, 0][both],
                                   rtol=1e-5)


# every RGB mode x texture type, then a stratified distribution x
# t-conorm subset: all 18 CDFs and all 10 alpha families appear
TORCH_SPECS = [
    dict(dist='uniform', tcn='probabilistic', rgb='hard'),
    dict(dist='uniform', tcn='probabilistic', rgb='softmax'),
    dict(dist='logistic', tcn='einstein', rgb='hard', texture_type='vertex'),
    dict(dist='logistic', tcn='einstein', rgb='softmax',
         texture_type='vertex', double_side=False),
    dict(dist='gaussian', tcn='max', rgb='hard', ts=4),
    dict(dist='cubic_hermite', tcn='hard', rgb='softmax', ts=4),
    dict(dist='wigner_semicircle', tcn='hamacher', p=0.5, rgb='softmax'),
    dict(dist='laplace', tcn='frank', p=2.0, rgb='hard'),
    # gudermannian's tail, 0.5 + (2/pi) atan(tanh(u/2)), cancels to an
    # absolute precision of ~3e-8 in both libraries; softmax RGB at a small
    # gamma weights that tail on front faces, so it is compared in hard RGB
    dict(dist='gudermannian', tcn='yager', p=2.0, rgb='hard'),
    dict(dist='cauchy', tcn='aczel_alsina', p=1.0, rgb='hard',
         squared=True),
    dict(dist='reciprocal', tcn='dombi', p=2.0, rgb='softmax'),
    dict(dist='gumbel_max', tcn='schweizer_sklar', p=-1.0, rgb='hard',
         shift=0.05),
    dict(dist='gumbel_min', tcn='probabilistic', rgb='softmax',
         channels='alpha'),
    dict(dist='exponential', tcn='einstein', rgb='softmax', shift=0.05),
    dict(dist='exponential_rev', tcn='max', rgb='hard', shift=0.05),
    dict(dist='gamma', tcn='probabilistic', rgb='softmax', shape=2.0),
    dict(dist='gamma_rev', tcn='hard', rgb='hard', shape=2.0),
    dict(dist='levy', tcn='probabilistic', rgb='hard', shift=0.1),
    dict(dist='levy_rev', tcn='einstein', rgb='softmax', shift=0.1),
    dict(dist='hard', tcn='hard', rgb='hard'),
]


@pytest.mark.parametrize('spec', TORCH_SPECS,
                         ids=lambda s: f"{s['dist']}-{s['tcn']}-{s['rgb']}")
def test_torch_backend_matches_xla(spec):
    fv, tex, kw, jp, tp = _inputs(spec, 'random')
    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), None,
                         JC.RenderConfig.create(**kw), jp)
    got, got_ag = TB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                             C.RenderConfig.create(**kw), tp)
    hard_ids = spec['rgb'] == 'hard' and kw['channels'] == 'rgba'
    _assert_match(got, got_ag, want, want_ag, hard_ids, flip_budget=0.01)
    if not hard_ids and kw['channels'] == 'rgba':
        # (softmax sum, softmax max): the sum reaches exp(1/gamma) scales,
        # so its tolerance is relative
        np.testing.assert_allclose(got_ag.numpy(), np.asarray(want_ag),
                                   rtol=1e-4, atol=1e-6)


# the kernel's envelope: alpha families hard/max/probabilistic/einstein,
# channels 'alpha' or hard RGB over one-texel surface textures
KERNEL_SPECS = [
    dict(dist='uniform', tcn='probabilistic', rgb='hard', scale=1e-2),
    dict(dist='uniform', tcn='probabilistic', rgb='hard',
         channels='alpha'),
    dict(dist='logistic', tcn='max', rgb='hard', double_side=False),
    dict(dist='gaussian', tcn='einstein', rgb='hard', squared=True),
    dict(dist='hard', tcn='hard', rgb='hard'),
    dict(dist='gamma', tcn='einstein', rgb='hard', shape=2.0,
         channels='alpha'),
    dict(dist='cauchy', tcn='max', rgb='hard', face_chunk=16),
]


@pytest.mark.parametrize('scene', ['random', 'sphere'])
@pytest.mark.parametrize('spec', KERNEL_SPECS,
                         ids=lambda s: f"{s['dist']}-{s['tcn']}-"
                                       f"{s.get('channels', 'rgba')}")
def test_cuda_backend_plain_matches_xla(spec, scene):
    fv, tex, kw, jp, tp = _inputs(spec, scene)
    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), None,
                         JC.RenderConfig.create(**kw), jp)
    launches = CB.LAUNCHES['rasterize_fwd']
    got, got_ag = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                             C.RenderConfig.create(backend='cuda', **kw), tp)
    assert CB.LAUNCHES['rasterize_fwd'] == launches  # CPU: plain version
    _assert_match(got, got_ag, want, want_ag,
                  kw['channels'] == 'rgba')


@pytest.mark.parametrize('spec', [
    dict(dist='uniform', tcn='probabilistic', rgb='hard', scale=5e-2),
    dict(dist='logistic', tcn='max', rgb='hard', channels='alpha'),
])
def test_cuda_backend_plain_matches_pallas_interpret(spec):
    """Against the TPU kernel itself, run in interpret mode as
    tests/test_pallas.py runs it (16x16, face_chunk 8, pixel_tile 64)."""
    rng = np.random.RandomState(0)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 1, 3).astype(np.float32)
    kw = dict(image_size=16, dist_func=spec['dist'],
              aggr_alpha_func=spec['tcn'], aggr_rgb_func=spec['rgb'],
              face_chunk=8, channels=spec.get('channels', 'rgba'))
    jp = params_dict(dist_scale=spec['scale'] if 'scale' in spec else 3e-2,
                     background_color=np.array([0.1, 0.2, 0.3]))
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64, **kw)
    want, want_ag = J_PF(jnp.asarray(fv), jnp.asarray(tex), None, jcfg, jp)
    got, got_ag = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                             C.RenderConfig.create(backend='cuda', **kw), tp)
    want_ag = np.asarray(want_ag).copy()
    if kw['channels'] == 'rgba':
        # Pallas reports winners in its Morton-sorted order; the port in
        # input order
        perm = np.asarray(PB._prepass(jnp.asarray(fv), jnp.asarray(tex),
                                      jcfg, jp)['perm'])
        ids = want_ag[:, 1].astype(int)
        for b in range(ids.shape[0]):
            want_ag[b, 1] = np.where(ids[b] >= 0,
                                     perm[b][np.clip(ids[b], 0, None)], -1)
    _assert_match(got, got_ag, want, want_ag, kw['channels'] == 'rgba')


def _tiny(device='cpu'):
    rng = np.random.RandomState(1)
    fv = torch.from_numpy(random_scene(rng, B=1, F=5).reshape(1, 5, 9))
    return fv.to(device), torch.full((1, 5, 1, 3), 0.5, device=device)


@pytest.mark.parametrize('kw,sub', [
    (dict(aggr_rgb_func='softmax'), 'K1b'),
    (dict(aggr_rgb_func='hard', texture_type='vertex'), 'K1b'),
    (dict(aggr_rgb_func='hard', ts=4), 'K1b/K1d'),
    (dict(aggr_rgb_func='hard', aggr_alpha_func='yager',
          aggr_alpha_t_conorm_p=2.0), 'K1c'),
    (dict(channels='alpha', aggr_alpha_func='frank',
          aggr_alpha_t_conorm_p=2.0), 'K1c'),
])
def test_cuda_backend_envelope_raises(kw, sub):
    fv, tex = _tiny()
    kw = dict(kw)
    if kw.pop('ts', 1) == 4:
        tex = torch.full((1, 5, 4, 3), 0.5)
    if kw.get('texture_type') == 'vertex':
        tex = torch.full((1, 5, 3, 3), 0.5)
    with pytest.raises(ValueError, match=sub):
        render(fv, tex, image_size=16, backend='cuda', **kw)
    # the plain backend renders the same configuration
    img = render(fv, tex, image_size=16, backend='torch', **kw)
    assert img.shape == (1, 4, 16, 16)


def test_render_default_backend_on_cpu_is_torch():
    fv, tex = _tiny()
    launches = CB.LAUNCHES['rasterize_fwd']
    kw = dict(image_size=16, aggr_rgb_func='hard')
    img = render(fv, tex, **kw)
    np.testing.assert_array_equal(img.numpy(),
                                  render(fv, tex, backend='torch',
                                         **kw).numpy())
    assert CB.LAUNCHES['rasterize_fwd'] == launches
    # [B, F, 3, 3] input is accepted like [B, F, 9]
    np.testing.assert_array_equal(
        render(fv.reshape(1, 5, 3, 3), tex, **kw).numpy(), img.numpy())


def test_backward_raises_not_implemented():
    fv, tex = _tiny()
    fv.requires_grad_(True)
    for backend in ('torch', 'cuda'):
        out = render(fv, tex, image_size=16, aggr_rgb_func='hard',
                     backend=backend)
        assert out.requires_grad
        with pytest.raises(NotImplementedError, match='_bwd_kernel'):
            out.sum().backward()


@pytest.mark.parametrize('kw', [
    dict(dist_scale=-1.0), dict(dist_eps=0.5),
    dict(aggr_alpha_func='frank', aggr_alpha_t_conorm_p=1.0),
    dict(aggr_alpha_func='schweizer_sklar', aggr_alpha_t_conorm_p=1.0),
    dict(aggr_alpha_func='yager'),
    dict(backend='pallas'),
])
def test_render_eager_checks(kw):
    fv, tex = _tiny()
    with pytest.raises(ValueError):
        render(fv, tex, image_size=16, **kw)


def test_rasterize_fwd_checks_its_inputs():
    fv, tex = _tiny()
    cfg = C.RenderConfig.create(image_size=16, aggr_rgb_func='hard',
                                face_chunk=8, backend='cuda')
    aux = CB.prepass(fv, tex, cfg, C.RenderParams().as_dict())
    args = [aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm']]
    out = CB.rasterize_fwd(*args, cfg)
    assert out.shape == (1, 6, 256)
    bad = list(args)
    bad[4] = aux['perm'].long()
    with pytest.raises(ValueError, match='perm'):
        CB.rasterize_fwd(*bad, cfg)
    bad = list(args)
    bad[3] = aux['packed'][:, :48].contiguous()
    with pytest.raises(ValueError, match='rows'):
        CB.rasterize_fwd(*bad, cfg)
    with pytest.raises(ValueError, match='hit lists'):
        CB.rasterize_fwd(*args, C.RenderConfig.create(
            image_size=40, aggr_rgb_func='hard', face_chunk=8))
