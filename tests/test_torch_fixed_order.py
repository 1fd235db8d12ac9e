"""The training path's sums over index tables in a fixed order, with no
atomics (``gendr_tpu_torch/ops/segments.py``): the vertex normals, the
uniform Laplacian, the dihedral loss's gathers and the gradient of
``core.face_vertices``, against the ``index_add_`` and gather expressions
they replace (bitwise on the CPU: the same order) and against
``gendr_tpu`` (today's tolerances).  The card's side, two runs of the
experiments bitwise equal, is ``tests/test_torch_kernels.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gendr_tpu
from gendr_tpu.geometry import core as JG
from gendr_tpu_torch import data
from gendr_tpu_torch.geometry import core
from gendr_tpu_torch.geometry.losses import FlattenLoss, LaplacianLoss
from gendr_tpu_torch.geometry.mesh import Mesh
from gendr_tpu_torch.ops import segments as SG
from torch_threads import one_torch_thread  # noqa: F401


def _mesh(nv=162, B=2, seed=1):
    v, f = data.sphere(nv)
    x = (v[None] * (1 + 0.1 * np.random.RandomState(seed).randn(B, nv, 1))) \
        .astype(np.float32)
    return x, f


def _index_add_normals(vertices, faces):
    """core.vertex_normals as it was: one index_add_ over the corners in
    corner-major order."""
    B, nv = vertices.shape[:2]
    n0, n1, n2 = core._face_cross_products(vertices, faces)
    idx = torch.cat([faces[:, :, 0], faces[:, :, 1], faces[:, :, 2]], dim=1)
    val = torch.cat([n0, n1, n2], dim=1)
    flat = idx.long() + nv * torch.arange(B)[:, None]
    normals = vertices.new_zeros((B * nv, 3)).index_add_(
        0, flat.reshape(-1), val.reshape(-1, 3)).reshape(B, nv, 3)
    norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp(norm, min=1e-6)


def _serial_grad(fn, x, g):
    """The gradient of (fn(x) * g).sum() with deterministic algorithms, so
    the CPU's gather backward sums serially, in index order."""
    x = x.clone().requires_grad_()
    torch.use_deterministic_algorithms(True)
    try:
        (fn(x) * g).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    return x.grad


def _grad(fn, x, g):
    x = x.clone().requires_grad_()
    (fn(x) * g).sum().backward()
    return x.grad


@pytest.mark.parametrize('shared', [True, False])
def test_vertex_normals_bitwise_index_add(shared):
    x, f = _mesh()
    faces = torch.from_numpy(f)[None].expand(2, -1, -1)
    vertices = torch.from_numpy(x)
    inc = core.incidence(torch.from_numpy(f), x.shape[1]) if shared else None
    got = core.vertex_normals(vertices, faces, inc)
    assert torch.equal(got, _index_add_normals(vertices, faces))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JG.vertex_normals(jnp.asarray(x),
                                                  jnp.asarray(faces.numpy()))),
        rtol=1e-5, atol=1e-5)
    # its gradient: the corners' cross products summed back per vertex
    g = torch.from_numpy(np.random.RandomState(2).randn(*x.shape)
                         .astype(np.float32))
    want = _serial_grad(lambda v: _index_add_normals(v, faces), vertices, g)
    assert torch.equal(_grad(lambda v: core.vertex_normals(v, faces, inc),
                             vertices, g), want)


@pytest.mark.parametrize('shared', [True, False])
def test_face_vertices_gradient_bitwise_gather(shared):
    x, f = _mesh()
    faces = torch.from_numpy(np.stack([f, f[:, ::-1]]).copy())
    vertices = torch.from_numpy(x)
    inc = core.incidence(torch.from_numpy(f), x.shape[1]) if shared else None
    if shared:
        faces = faces[:1].expand(2, -1, -1)
    g = torch.from_numpy(np.random.RandomState(3).randn(
        2, f.shape[0], 3, 3).astype(np.float32))
    bidx = torch.arange(2)[:, None, None]
    assert torch.equal(core.face_vertices(vertices, faces, inc),
                       vertices[bidx, faces.long()])
    got = _grad(lambda v: core.face_vertices(v, faces, inc), vertices, g)
    want = _serial_grad(lambda v: v[bidx, faces.long()], vertices, g)
    assert torch.equal(got, want)
    # against jax's vjp of gendr_tpu's gather
    _, vjp = jax.vjp(lambda v: JG.face_vertices(v, jnp.asarray(
        faces.numpy())), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                               rtol=1e-5, atol=1e-5)


def test_laplacian_bitwise_index_add():
    x, f = _mesh(642)
    loss = LaplacianLoss(x[0], f)
    X = torch.from_numpy(x)

    def old(v):
        ns = torch.zeros_like(v).index_add_(1, loss.rows, v[:, loss.cols])
        lap = v - ns / loss.deg[None, :, None]
        return (lap ** 2).sum(dim=(1, 2))
    assert torch.equal(loss(X), old(X))
    g = torch.tensor([0.7, -1.3])
    assert torch.equal(_grad(loss, X, g), _serial_grad(old, X, g))
    ref = gendr_tpu.LaplacianLoss(x[0], f)
    np.testing.assert_allclose(loss(X).numpy(),
                               np.asarray(ref(jnp.asarray(x))), rtol=1e-5)
    jg = jax.grad(lambda v: jnp.sum(ref(v) * jnp.asarray(g.numpy())))(
        jnp.asarray(x))
    np.testing.assert_allclose(_grad(loss, X, g).numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-6)


def test_flatten_gradient_bitwise_gathers():
    x, f = _mesh(642)
    loss = FlattenLoss(f)
    X = torch.from_numpy(x)

    def old(v, eps=1e-6):
        def at(name):
            return v[:, getattr(loss, name)]
        edge_a = at('v1s') - at('v0s')
        edge_sq = (edge_a ** 2).sum(-1)
        edge_len = torch.sqrt(edge_sq + eps)

        def rejection(name):
            wing = at(name) - at('v0s')
            wing_len = torch.sqrt((wing ** 2).sum(-1) + eps)
            proj = (edge_a * wing).sum(-1)
            cos_w = proj / (edge_len * wing_len + eps)
            sin_w = torch.sqrt(1 - cos_w ** 2 + eps)
            rej = wing - edge_a * (proj / (edge_sq + eps))[:, :, None]
            return rej, wing_len * sin_w
        rej2, len2 = rejection('v2s')
        rej3, len3 = rejection('v3s')
        cos_d = (rej2 * rej3).sum(-1) / (len2 * len3 + eps)
        return ((cos_d + 1) ** 2).sum(1)
    assert torch.equal(loss(X), old(X))
    g = torch.tensor([1.1, 0.4])
    assert torch.equal(_grad(loss, X, g), _serial_grad(old, X, g))
    ref = gendr_tpu.FlattenLoss(f)
    jg = jax.grad(lambda v: jnp.sum(ref(v) * jnp.asarray(g.numpy())))(
        jnp.asarray(x))
    np.testing.assert_allclose(_grad(loss, X, g).numpy(), np.asarray(jg),
                               rtol=1e-3, atol=1e-5)


def test_segments_and_gather_rows():
    """segment_sum: each index's rows from 0 in row order, 0 for an index no
    row names, per batch element or shared; gather_rows pads the gradient of
    rows past the table's."""
    rng = np.random.RandomState(4)
    index = torch.from_numpy(rng.randint(0, 6, (2, 40)))
    vals = torch.from_numpy(rng.randn(2, 40, 3).astype(np.float32))
    seg = SG.segments(index, 7)
    assert seg.counts.dtype == torch.int64
    assert torch.equal(seg.counts.sum(1), torch.tensor([40, 40]))
    got = SG.segment_sum(vals, seg)
    for b in range(2):
        want = torch.zeros(7, 3).index_add_(0, index[b], vals[b])
        assert torch.equal(got[b], want)
    assert torch.equal(got[:, 6], torch.zeros(2, 3))
    shared = SG.segment_sum(vals, SG.segments(index[0], 7))
    assert torch.equal(shared[0], got[0])
    x = torch.from_numpy(rng.randn(2, 9, 3).astype(np.float32))
    idx = index[0]
    g = _grad(lambda v: SG.gather_rows(v, idx, SG.segments(idx, 6)), x,
              torch.ones(2, 40, 3))
    assert g.shape == x.shape and torch.equal(g[:, 6:], torch.zeros(2, 3, 3))
    assert torch.equal(g, _serial_grad(lambda v: v[:, idx], x,
                                       torch.ones(2, 40, 3)))


def test_mesh_keeps_its_incidence():
    x, f = _mesh()
    mesh = Mesh.create(x[:1], f, device='cpu').with_incidence()
    inc = mesh.incidence
    assert inc is not None and inc.gather.order.ndim == 1
    for m in (mesh.repeat(3), mesh.with_vertices(mesh.vertices * 2),
              mesh.with_textures(mesh.textures * 2)):
        assert all(a is b for a, b in zip(
            (*m.incidence.gather, *m.incidence.normals),
            (*inc.gather, *inc.normals)))
    assert torch.equal(mesh.repeat(2).vertex_normals,
                       _index_add_normals(mesh.vertices.repeat(2, 1, 1),
                                          mesh.faces.repeat(2, 1, 1)))


def test_mesh_moves_its_incidence_as_buffers():
    """The table moves with Mesh.to() (buffers) and stays out of the
    state_dict, as ShapeModel's and the losses' tables do."""
    x, f = _mesh()
    plain = Mesh.create(x[:1], f, device='cpu')
    mesh = plain.with_incidence()
    assert plain.incidence is None
    assert set(mesh.state_dict()) == set(plain.state_dict())
    moved = mesh.to('meta')
    assert all(t.device.type == 'meta' for t in
               (*moved.incidence.gather, *moved.incidence.normals))
