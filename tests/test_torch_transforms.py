"""look, projection, Look and Projection of the port against gendr_tpu,
from the cases of tests/test_geometry_layers.py.

Tolerance: 1e-6 absolute on camera-space and NDC coordinates of order 1
(one float32 normalisation, cross product and 3-term einsum in each
library); the projection's distortion polynomial on pixel-scale inputs is
held relatively, rtol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gendr_tpu import data
from gendr_tpu.geometry import transforms as JT
from gendr_tpu.geometry.mesh import Mesh as JMesh
from gendr_tpu_torch import Look, Mesh, Projection, functional
from gendr_tpu_torch.geometry import transforms as T
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-6


def test_look_function_defaults():
    # the reference's look() crashes when up is omitted (look.py:38 quirk);
    # both packages default up=(0,1,0)
    v = np.random.RandomState(3).randn(1, 6, 3).astype(np.float32)
    out = T.look(torch.from_numpy(v), eye=[0, 0, -2], direction=[0, 0, 1])
    assert bool(torch.isfinite(out).all())
    # looking along +z from z=-2: z coords shift by +2
    np.testing.assert_allclose(out[..., 2].numpy(), v[..., 2] + 2, atol=1e-5)
    want = JT.look(jnp.asarray(v), eye=[0, 0, -2], direction=[0, 0, 1])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('seed', range(4))
def test_look_matches_jax_on_batched_cameras(seed):
    rng = np.random.RandomState(seed)
    v = rng.randn(3, 17, 3).astype(np.float32)
    eye = rng.randn(3, 3).astype(np.float32) * 2
    direction = rng.randn(3, 3).astype(np.float32)
    up = np.array([0.1, 1.0, 0.2], np.float32)
    got = T.look(torch.from_numpy(v), torch.from_numpy(eye),
                 torch.from_numpy(direction), up)
    want = JT.look(jnp.asarray(v), jnp.asarray(eye), jnp.asarray(direction),
                   up)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match='3 dimensions'):
        T.look(torch.from_numpy(v[0]), eye[0])
    assert functional.look is T.look


def test_look_is_differentiable_in_eye_and_direction():
    v = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    eye = torch.tensor([[0.0, 0.0, -2.0], [1.0, 0.5, -2.0]],
                       requires_grad=True)
    direction = torch.tensor([[0.0, 0.0, 1.0], [0.1, 0.0, 1.0]],
                             requires_grad=True)
    T.look(v, eye, direction).square().sum().backward()
    assert bool(torch.isfinite(eye.grad).all()) \
        and float(eye.grad.abs().max()) > 0
    assert float(direction.grad.abs().max()) > 0


def test_look_class():
    v, f = data.icosphere(1)
    t = Look(camera_direction=[0, 0, 1], eye=[0, 0, -3])
    out = t(Mesh.create(v, f, device='cpu'))
    assert bool(torch.isfinite(out.vertices).all())
    want = JT.Look(camera_direction=[0, 0, 1], eye=[0, 0, -3])(
        JMesh.create(v, f))
    np.testing.assert_allclose(out.vertices.numpy(),
                               np.asarray(want.vertices), atol=ATOL)
    # orthogonal, other eyes, defaults
    t = Look(perspective=False, viewing_scale=0.5)
    jt = JT.Look(perspective=False, viewing_scale=0.5)
    eyes = np.array([[0.5, 0.2, -3.0]], np.float32)
    t.set_eyes(eyes)
    jt.set_eyes(eyes)
    np.testing.assert_allclose(
        t(Mesh.create(v, f, device='cpu')).vertices.numpy(),
        np.asarray(jt(JMesh.create(v, f)).vertices), atol=ATOL)
    assert '_eye' in dict(t.named_buffers())  # moves with .to(device)


def test_projection_matrix():
    P = np.zeros((1, 3, 4), np.float32)
    P[0, 0, 0] = P[0, 1, 1] = P[0, 2, 2] = 1.0
    v = torch.tensor([[[100.0, 200.0, 1.0]]])
    out = T.projection(v, P, orig_size=512).numpy()
    # x' = 100, y' = 200 -> NDC
    np.testing.assert_allclose(
        out[0, 0, :2], [2 * (100 - 256) / 512, 2 * (200 - 256) / 512],
        atol=1e-3)
    assert functional.projection is T.projection


@pytest.mark.parametrize('distorted', [False, True])
def test_projection_matches_jax(distorted):
    rng = np.random.RandomState(7)
    B = 2
    P = np.zeros((B, 3, 4), np.float32)
    P[:, 0, 0] = P[:, 1, 1] = 400.0
    P[:, 0, 2] = P[:, 1, 2] = 256.0
    P[:, 2, 2] = 1.0
    P += rng.randn(B, 3, 4).astype(np.float32) * 0.01
    v = rng.randn(B, 11, 3).astype(np.float32) * 0.3
    v[..., 2] += 3.0
    k = (rng.randn(B, 5) * 1e-7).astype(np.float32) if distorted else None
    got = T.projection(torch.from_numpy(v), P, k, orig_size=512)
    want = JT.projection(jnp.asarray(v), P, k, orig_size=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)


def test_projection_class():
    P = np.zeros((1, 3, 4), np.float32)
    P[0, 0, 0] = P[0, 1, 1] = P[0, 2, 2] = 1.0
    v, f = data.icosphere(1)
    verts = (v * 100 + np.array([256, 256, 3])).astype(np.float32)
    t = Projection(P, orig_size=512)
    o = t(Mesh.create(verts, f, device='cpu')).vertices.numpy()
    assert np.isfinite(o).all()
    assert np.abs(o[..., :2]).max() < 2.0  # roughly NDC
    want = JT.Projection(P, orig_size=512)(JMesh.create(verts, f))
    np.testing.assert_allclose(o, np.asarray(want.vertices), rtol=1e-6,
                               atol=ATOL)
    assert 'P' in dict(t.named_buffers())


def test_projection_invalid_matrix():
    with pytest.raises(ValueError, match='3x4'):
        Projection(np.zeros((3, 4), np.float32))
