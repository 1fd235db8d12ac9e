"""Softmax RGB and textures (sub-kernels K1b/K2b) against gendr_tpu on the
CPU.

On CPU tensors ``backend='cuda'`` runs the kernels' plain versions
(``cuda_backend.rasterize_fwd_plain`` / ``rasterize_bwd_plain``); these
tests hold them against ``gendr_tpu``'s ``xla`` backend and, for a softmax
surface-texture case, against the Pallas kernels in interpret mode, across
softmax RGB with one, 4, 25 and 36 texels per face and with vertex
textures, hard RGB with 4 texels and with vertex textures, and
single-sided faces; and a soft CDF with 25 texels under softmax, the
configuration of the panda_dist sweep and the default GenDR, off the texel
fold (below).  ``tests/test_torch_kernels.py`` holds the CUDA
kernels against the same plain versions on the card.

Tolerances (tools/tpu_selfcheck.py:404-409): image max-abs below 2e-3;
the softmax aggregates (sum, max) relatively, the sum reaching exp(1/gamma)
scales (tests/test_torch_raster.py); hard-RGB winners equal on >= 99.9 %
of covered pixels; gradients within np.isclose(atol 5e-4, rtol 5e-3) on
> 99 % of the entries, for the face vertices and the textures alike.  The
distributions stay away from the gudermannian softmax tail (ROADMAP.md
Queue 3) and the scenes' texel boundaries: a pixel within an ulp of a
texel edge samples the neighbouring texel.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import Mesh as JMesh
from gendr_tpu import config as JC
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu_torch import config as C, data, interop, render
from gendr_tpu_torch.raster import cuda_backend as CB
from tests.test_render import params_dict, random_scene
from tests.test_torch_backward import _image_grad, _port_grads, _xla_grads
from tests.test_torch_raster import J_XF, _inputs
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = 2e-3
WINNER_AGREE = 0.999
GRAD_ATOL, GRAD_RTOL, GRAD_AGREE = 5e-4, 5e-3, 0.99

# name, spec (tests/test_torch_raster.py:_inputs keys).  Softmax RGB at
# the panda_dist sweep's gamma 10^-2.5.  A soft CDF's tail beyond the edge
# opposite vertex 2 clips w2 to 0, so wcn0 + wcn1 = 1 there and every such
# pixel lies exactly on the fold of the R x R texel grid, where the two
# libraries' last-ulp rounding picks the texel: the surface textures of
# TS > 1 under softmax are compared with the step CDF, which has no tail
# (its xy gradient is 0; the z and texture chains are not), and the soft
# CDFs with one texel or vertex colours, which are continuous there;
# test_soft_cdf_surface_texture_matches_xla_off_the_fold takes a soft CDF
# with 25 texels.  The max t-conorm is left out: its JAX CPU gradient is
# not self-consistent (tests/test_torch_backward.py).
SOFT = dict(rgb='softmax', gamma=10 ** -2.5)
SPECS = [
    ('softmax-ts1', dict(dist='logistic', tcn='probabilistic', **SOFT)),
    ('softmax-ts4', dict(dist='hard', tcn='probabilistic', ts=4, **SOFT)),
    ('softmax-ts25', dict(dist='hard', tcn='einstein', ts=25, **SOFT)),
    ('softmax-ts36', dict(dist='hard', tcn='hard', ts=36, face_chunk=16,
                          **SOFT)),
    ('softmax-vertex', dict(dist='logistic', tcn='einstein',
                            texture_type='vertex', **SOFT)),
    ('hard-ts4', dict(dist='gaussian', tcn='probabilistic', rgb='hard',
                      ts=4)),
    ('hard-vertex', dict(dist='logistic', tcn='einstein', rgb='hard',
                         texture_type='vertex', squared=True)),
    ('softmax-single-sided', dict(dist='cubic_hermite', tcn='probabilistic',
                                  texture_type='vertex', double_side=False,
                                  **SOFT)),
]


def agreement(got, want):
    """Share of entries within np.isclose(GRAD_ATOL, GRAD_RTOL)."""
    return float(np.isclose(np.asarray(got), np.asarray(want),
                            atol=GRAD_ATOL, rtol=GRAD_RTOL).mean())


def _assert_images(got, got_ag, want, want_ag, rgb):
    got, got_ag = got.numpy(), got_ag.numpy()
    want, want_ag = np.asarray(want), np.asarray(want_ag)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < IMG_TOL
    if rgb == 'softmax':
        np.testing.assert_allclose(got_ag, want_ag, rtol=1e-4, atol=1e-6)
    else:
        ids, ref = got_ag[:, 1], want_ag[:, 1]
        covered = (ids >= 0) | (ref >= 0)
        assert covered.sum() > 50
        assert (ids == ref)[covered].mean() >= WINNER_AGREE


@pytest.mark.parametrize('scene', ['random', 'sphere'])
@pytest.mark.parametrize('name,spec', SPECS, ids=[n for n, _ in SPECS])
def test_cuda_backend_plain_matches_xla(name, spec, scene):
    fv, tex, kw, jp, tp = _inputs(spec, scene)
    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), None,
                         JC.RenderConfig.create(**kw), jp)
    launches = dict(CB.LAUNCHES)
    got, got_ag = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                             C.RenderConfig.create(backend='cuda', **kw), tp)
    assert CB.LAUNCHES == launches  # CPU: the plain versions
    _assert_images(got, got_ag, want, want_ag, spec['rgb'])


@pytest.mark.parametrize('scene', ['random', 'sphere'])
@pytest.mark.parametrize('name,spec', SPECS, ids=[n for n, _ in SPECS])
def test_cuda_backward_plain_matches_xla(name, spec, scene):
    fv, tex, kw, jp, tp = _inputs(spec, scene)
    g = _image_grad(spec, fv)
    want = _xla_grads(fv, tex, kw, jp, g)
    got = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert agreement(got[0], want[0]) > GRAD_AGREE
    assert agreement(got[1], want[1]) > GRAD_AGREE
    assert float(got[0].abs().max()) > 100 * GRAD_ATOL
    assert float(got[1].abs().max()) > 100 * GRAD_ATOL
    if spec['rgb'] == 'softmax':
        # the softmax depth chain reaches the vertex z columns
        gz = got[0].reshape(*got[0].shape[:2], 3, 3)[..., 2]
        assert float(gz.abs().max()) > 100 * GRAD_ATOL


# a pixel whose image differs from xla's by more than FOLD_TOL sampled
# another texel on the fold; at most FOLD_BUDGET of the pixels may
FOLD_TOL, FOLD_BUDGET = 1e-4, 0.03


@pytest.mark.parametrize('scene', ['random', 'sphere'])
def test_soft_cdf_surface_texture_matches_xla_off_the_fold(scene):
    """Softmax RGB, a soft CDF (logistic) and 25 texels per face, forward
    and backward, against xla.  On the texel fold each library's last ulp
    picks one of two texels, so those few pixels (FOLD_BUDGET) may differ
    in colour; alpha and the softmax aggregates may not, and neither may
    any other pixel.  The gradients are compared with the upstream
    gradient of the fold pixels set to 0: every pair on every other pixel
    must agree, in the geometry, z and texture gradients."""
    spec = dict(dist='logistic', tcn='probabilistic', ts=25, **SOFT)
    fv, tex, kw, jp, tp = _inputs(spec, scene)
    want, want_ag = J_XF(jnp.asarray(fv), jnp.asarray(tex), None,
                         JC.RenderConfig.create(**kw), jp)
    got, got_ag = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                             C.RenderConfig.create(backend='cuda', **kw), tp)
    got, want = got.numpy(), np.asarray(want)
    err = np.abs(got - want).max(axis=1)                    # [B, H, W]
    fold = err > FOLD_TOL
    assert fold.mean() <= FOLD_BUDGET, (fold.sum(), fold.size)
    assert err[~fold].max() < IMG_TOL
    assert np.abs(got[:, 3] - want[:, 3]).max() < IMG_TOL
    np.testing.assert_allclose(got_ag.numpy(), np.asarray(want_ag),
                               rtol=1e-4, atol=1e-6)

    g = _image_grad(spec, fv) * ~fold[:, None]
    want_g = _xla_grads(fv, tex, kw, jp, g)
    got_g = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    assert agreement(got_g[0], want_g[0]) > GRAD_AGREE
    assert agreement(got_g[1], want_g[1]) > GRAD_AGREE
    assert float(got_g[0].abs().max()) > 100 * GRAD_ATOL
    assert float(got_g[1].abs().max()) > 100 * GRAD_ATOL


def float_fold(w_clip, R):
    """gendr_tpu's surface_texel_index (gendr_tpu/raster/geometry.py): the
    fold's test on the float sum w0 + w1 everywhere, where the port reads
    exactly 1 beyond the edge opposite vertex 2 (w2 clipped to 0)."""
    w_x = torch.floor(w_clip[0] * R).to(torch.int32)
    w_y = torch.floor(w_clip[1] * R).to(torch.int32)
    lower = (w_clip[0] + w_clip[1]) * R - w_x.to(torch.float32) \
        - w_y.to(torch.float32) <= 1.0
    idx = torch.where(lower, w_y * R + w_x,
                      (R - 1 - w_y) * R + (R - 1 - w_x))
    return torch.clamp(idx, 0, R * R - 1)


def test_cuda_backend_plain_matches_pallas_interpret(monkeypatch):
    """A softmax surface-texture render and its gradient against the TPU
    kernels themselves, run in interpret mode as tests/test_pallas.py runs
    them (16x16, face_chunk 8, pixel_tile 64), the port's texel lookup
    under gendr_tpu's rule of the fold (float_fold), which picks the same
    texel in every pair; under the port's own rule the alpha and the
    softmax aggregates stay bitwise the same, and its RGB and gradients
    are held to the Pallas kernels off the pixels where the two rules
    pick different texels (at most FOLD_BUDGET of them), the upstream
    gradient of those pixels set to 0 on both sides."""
    from gendr_tpu_torch.raster import geometry as RG
    rng = np.random.RandomState(2)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 4, 3).astype(np.float32)
    g = rng.randn(2, 4, 16, 16).astype(np.float32)
    kw = dict(image_size=16, dist_func='logistic',
              aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
              face_chunk=8)
    jp = params_dict(dist_scale=5e-2, background_color=np.array(
        [0.1, 0.2, 0.3]))
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64, **kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    soft, aggrs, aux = jax.jit(PB.forward_with_aux, static_argnums=2)(
        jfv, jtex, jcfg, jp)
    want = jax.jit(PB.backward_from_aux, static_argnums=6)(
        jfv, jtex, aux, soft, aggrs, jnp.asarray(g), jcfg, jp)
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    own_soft, own_ag = CB.forward(torch.from_numpy(fv),
                                  torch.from_numpy(tex), cfg, tp)
    monkeypatch.setattr(RG, 'surface_texel_index', float_fold)
    got_soft, got_ag = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex),
                                  cfg, tp)
    assert torch.equal(own_soft[:, 3], got_soft[:, 3])
    assert torch.equal(own_ag, got_ag)
    _assert_images(got_soft, got_ag, soft, aggrs, 'softmax')
    got = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g)
    assert agreement(got[0], want[0]) > GRAD_AGREE
    assert agreement(got[1], want[1]) > GRAD_AGREE
    assert float(got[1].abs().max()) > 100 * GRAD_ATOL

    # the port's own rule: off its fold pixels, the Pallas kernels'
    monkeypatch.undo()
    fold = (own_soft != got_soft).any(1).numpy()           # [B, H, W]
    assert fold.mean() <= FOLD_BUDGET, (fold.sum(), fold.size)
    err = np.abs(own_soft.numpy() - np.asarray(soft)).max(axis=1)
    assert err[~fold].max() < IMG_TOL
    g_off = g * ~fold[:, None]
    want_off = jax.jit(PB.backward_from_aux, static_argnums=6)(
        jfv, jtex, aux, soft, aggrs, jnp.asarray(g_off), jcfg, jp)
    own = _port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'}, tp, g_off)
    assert agreement(own[0], want_off[0]) > GRAD_AGREE
    assert agreement(own[1], want_off[1]) > GRAD_AGREE
    assert float(own[1].abs().max()) > 100 * GRAD_ATOL


@pytest.mark.parametrize('texture_type', ['surface', 'vertex'])
def test_default_renderer_runs_on_the_cuda_backend(texture_type):
    """GenDR's defaults (softmax RGB, single-sided, 2x anti-aliasing) on
    backend='cuda': on the CPU its plain versions, which agree with
    backend='torch' in the image and both gradients."""
    import gendr_tpu_torch as G
    v, f = data.icosphere(1)
    rng = np.random.RandomState(0)
    tex = rng.rand(f.shape[0], 4, 3) if texture_type == 'surface' \
        else rng.rand(v.shape[0], 3)
    out = {}
    for backend in ('torch', 'cuda'):
        verts = torch.tensor(v * 0.8, requires_grad=True)
        t = torch.tensor(tex, dtype=torch.float32, requires_grad=True)
        mesh = G.Mesh.create(verts, f, t, 2 if texture_type == 'surface'
                             else 1, texture_type)
        look = G.LookAt()
        look.set_eyes_from_angles(2.732, 30.0, 45.0)
        renderer = G.GenDR(image_size=16, anti_aliasing=True,
                           texture_type=texture_type, backend=backend)
        img = renderer(look(G.Lighting()(mesh)))
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        out[backend] = (img.detach(), *torch.autograd.grad(loss,
                                                           (verts, t)))
    assert out['cuda'][0].shape == (1, 4, 16, 16)
    assert float((out['cuda'][0] - out['torch'][0]).abs().max()) < 1e-5
    for a, b in zip(out['cuda'][1:], out['torch'][1:]):
        assert agreement(a, b) > GRAD_AGREE
        assert float(b.abs().max()) > 0


def test_textured_scene_equals_the_jax_stand_in(monkeypatch):
    from animations import common as JA
    from gendr_tpu_torch.animations import common as TA
    monkeypatch.delenv('GENDR_PANDA_OBJ', raising=False)
    for res in (1, 5):
        want = JA.textured_scene(res)
        v, f, tex = data.textured_scene(res)
        np.testing.assert_array_equal(v, np.asarray(want.vertices)[0])
        np.testing.assert_array_equal(f, np.asarray(want.faces)[0])
        np.testing.assert_array_equal(tex, np.asarray(want.textures))
        mesh = TA.textured_scene(res, 'cpu')
        assert mesh.texture_res == res and mesh.texture_type == 'surface'
        np.testing.assert_array_equal(mesh.textures.numpy(), tex)
    monkeypatch.setenv('GENDR_PANDA_OBJ', '/nonexistent/panda.obj')
    with pytest.raises(FileNotFoundError, match='GENDR_PANDA_OBJ'):
        TA.textured_scene(5, 'cpu')


@pytest.mark.parametrize('texture_type,res', [('surface', 3),
                                              ('vertex', 1)])
def test_mesh_from_numpy_carries_textures(texture_type, res):
    """A gendr_tpu.Mesh's arrays (surface textures of TS > 1 texels, or
    vertex colours) make a port Mesh whose per-face textures are the JAX
    mesh's, and which renders on backend='cuda'."""
    v, f = data.icosphere(1)
    rng = np.random.RandomState(res)
    tex = rng.rand(f.shape[0], res * res, 3) if texture_type == 'surface' \
        else rng.rand(v.shape[0], 3)
    jm = JMesh.create(v, f, tex.astype(np.float32), res, texture_type)
    tm = interop.mesh_from_numpy(np.asarray(jm.vertices),
                                 np.asarray(jm.faces),
                                 np.asarray(jm.textures),
                                 texture_type=texture_type, device='cpu')
    assert tm.texture_type == texture_type and tm.texture_res == res
    np.testing.assert_array_equal(tm.face_textures.numpy(),
                                  np.asarray(jm.face_textures))
    img = render(tm.face_vertices * 0.5, tm.face_textures, image_size=16,
                 texture_type=texture_type, backend='cuda')
    assert img.shape == (1, 4, 16, 16) and bool(torch.isfinite(img).all())
