"""The whole forward slice, Mesh -> Lighting -> LookAt -> GenDR, against
the same gendr_tpu pipeline, with the mesh carried across by interop; and
the geometry layer it runs through.

Tolerances: the port's renderer on the JAX pipeline's transformed, lit
mesh (carried across by interop) holds image max-abs 1e-4 (the CDF and
the folds round differently in the two libraries by a few ulps).  The
whole port pipeline gets a budget of 1 % of pixels beyond 1e-4: its camera
transform and normals differ from the JAX package's by an ulp (6e-8 in
NDC), and a face seen edge-on at the silhouette, near-degenerate once
projected, amplifies that into coverage differences of up to ~1e-3; a
pixel on a shared edge can also change its hard-RGB winner, whose random
colour then differs by O(1).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import gendr_tpu
import gendr_tpu_torch
from gendr_tpu import data
from gendr_tpu.geometry import core as JG, transforms as JT
from gendr_tpu_torch import interop
from gendr_tpu_torch.geometry import core as G, transforms as T
from gendr_tpu_torch.raster import cuda_backend as CB
from torch_threads import one_torch_thread  # noqa: F401

IMG_ATOL = 1e-4
FLIP_BUDGET = 0.01


def _assert_close_images(got, want, flip_budget=FLIP_BUDGET):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max(axis=1)
    assert (err > IMG_ATOL).mean() <= flip_budget, \
        (float(err.max()), int((err > IMG_ATOL).sum()))


def _pipelines(texture_type, seed=0, level=2):
    v, f = data.icosphere(level)
    rng = np.random.RandomState(seed)
    n = f.shape[0] if texture_type == 'surface' else v.shape[0]
    tex = rng.rand(1, n, 1, 3) if texture_type == 'surface' \
        else rng.rand(1, n, 3)
    jmesh = gendr_tpu.Mesh.create(v * 0.8, f, tex.astype(np.float32),
                                  texture_type=texture_type)
    tmesh = interop.mesh_from_numpy(np.asarray(jmesh.vertices),
                                    np.asarray(jmesh.faces),
                                    np.asarray(jmesh.textures),
                                    texture_type=texture_type, device='cpu')
    jlook = gendr_tpu.LookAt(viewing_angle=30)
    jlook.set_eyes_from_angles(2.732, 30.0, 45.0)
    tlook = gendr_tpu_torch.LookAt(viewing_angle=30)
    tlook.set_eyes_from_angles(2.732, 30.0, 45.0)
    return (jlook(gendr_tpu.Lighting()(jmesh)),
            tlook(gendr_tpu_torch.Lighting()(tmesh)))


SLICE = [
    # the flagship configuration through both port backends
    (dict(aggr_rgb_func='hard'), 'surface', 'torch'),
    (dict(aggr_rgb_func='hard'), 'surface', 'cuda'),
    (dict(aggr_rgb_func='hard', channels='alpha', dist_func='logistic',
          aggr_alpha_func='max', double_side=True), 'surface', 'cuda'),
    (dict(aggr_rgb_func='hard', aggr_alpha_func='einstein',
          anti_aliasing=True, image_size=32), 'surface', None),
    (dict(aggr_rgb_func='softmax', dist_func='logistic',
          anti_aliasing=True, image_size=32), 'vertex', 'torch'),
]


@pytest.mark.parametrize('kw,texture_type,backend', SLICE)
def test_slice_matches_gendr_tpu(kw, texture_type, backend):
    jmesh, tmesh = _pipelines(texture_type)
    args = dict(image_size=64, dist_func='uniform', dist_scale=1e-2,
                aggr_alpha_func='probabilistic', texture_type=texture_type)
    args.update(kw)
    want = gendr_tpu.GenDR(backend='xla', **args)(jmesh)
    renderer = gendr_tpu_torch.GenDR(backend=backend, **args)
    launches = CB.LAUNCHES['rasterize_fwd']
    got = renderer(tmesh)
    carried = renderer(interop.mesh_from_numpy(
        np.asarray(jmesh.vertices), np.asarray(jmesh.faces),
        np.asarray(jmesh.textures), texture_type=texture_type,
        device='cpu'))
    assert CB.LAUNCHES['rasterize_fwd'] == launches  # CPU: never a launch
    _assert_close_images(got, want)
    _assert_close_images(carried, want, flip_budget=0.0)
    alpha = got[0, 3]
    assert 0.1 < float((alpha > 0.5).float().mean()) < 0.9


def test_slice_dist_scale_is_mutable():
    jmesh, tmesh = _pipelines('surface')
    args = dict(image_size=32, dist_func='logistic',
                aggr_alpha_func='probabilistic', aggr_rgb_func='hard')
    jr = gendr_tpu.GenDR(backend='xla', **args)
    tr = gendr_tpu_torch.GenDR(**args)
    first = tr(tmesh)
    for tau in (3e-2, 3e-3):
        jr.dist_scale = tau
        tr.dist_scale = tau
        _assert_close_images(tr(tmesh), jr(jmesh))
    assert float((tr(tmesh) - first).abs().max()) > 1e-2


def test_genDR_rejects_unknown_modes():
    with pytest.raises(ValueError):
        gendr_tpu_torch.GenDR(aggr_rgb_func='weird')
    with pytest.raises(ValueError):
        gendr_tpu_torch.GenDR(texture_type='uv')


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_geometry_layer_matches_gendr_tpu():
    v, f = data.icosphere(1)
    verts = _rand((2, v.shape[0], 3)) * 0.3 + v[None]
    faces = np.stack([f, f[:, ::-1]])
    tv, tf = torch.from_numpy(verts), torch.from_numpy(faces.copy())
    jv, jf = jnp.asarray(verts), jnp.asarray(faces)
    for name in ('face_vertices', 'surface_normals', 'vertex_normals'):
        np.testing.assert_allclose(getattr(G, name)(tv, tf).numpy(),
                                   np.asarray(getattr(JG, name)(jv, jf)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    eyes = np.array(JT.get_points_from_angles(
        np.array([2.0, 2.7]), np.array([30.0, -10.0]), np.array([45., 0.])))
    np.testing.assert_allclose(
        T.get_points_from_angles(torch.tensor([2.0, 2.7]),
                                 torch.tensor([30.0, -10.0]),
                                 torch.tensor([45., 0.])).numpy(),
        eyes, rtol=1e-6, atol=1e-6)
    want = JT.perspective(JT.look_at(jv, jnp.asarray(eyes)),
                          jnp.asarray([30.0, 20.0]))
    got = T.perspective(T.look_at(tv, torch.from_numpy(eyes)),
                        torch.tensor([30.0, 20.0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        T.orthogonal(tv, 0.5).numpy(), np.asarray(JT.orthogonal(jv, 0.5)))


def test_mesh_lighting_and_lookat_modules():
    v, f = data.icosphere(1)
    mesh = gendr_tpu_torch.Mesh.create(v, f, texture_res=2, device='cpu')
    assert mesh.textures.shape == (1, f.shape[0], 4, 3)
    assert mesh.repeat(3).vertices.shape == (3, v.shape[0], 3)
    vmesh = gendr_tpu_torch.Mesh.create(v, f, texture_type='vertex',
                                        device='cpu')
    assert vmesh.face_textures.shape == (1, f.shape[0], 3, 3)
    lit = gendr_tpu_torch.Lighting()(vmesh)
    assert lit is not vmesh and float(lit.textures.max()) <= 1.0 + 1e-6
    look = gendr_tpu_torch.LookAt(perspective=False)
    moved = look(mesh)
    assert moved.faces is mesh.faces
    assert not torch.equal(moved.vertices, mesh.vertices)
    eye = np.asarray(gendr_tpu.LookAt().eyes, np.float32)
    np.testing.assert_allclose(look.eyes.numpy(), eye, rtol=1e-6)
