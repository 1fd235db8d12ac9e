"""The port's solid voxelizer: the cases of tests/test_voxelize.py, and
voxel-for-voxel equality with gendr_tpu.geometry.voxelize.voxelization."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gendr_tpu import data
from gendr_tpu.geometry import core as JG, voxelize as JV
from gendr_tpu_torch.geometry import core, voxelize
from gendr_tpu_torch.geometry.mesh import Mesh
from torch_threads import one_torch_thread  # noqa: F401


def test_sphere_is_solid():
    v, f = data.icosphere(3)
    mesh = Mesh.create(v * 0.4, f, device='cpu')  # reference convention: verts in [-0.5, 0.5]
    vox = mesh.voxelize(32)
    assert tuple(vox.shape) == (1, 32, 32, 32) and vox.dtype == torch.int32
    vox = vox.numpy()
    vol = vox.sum()
    expect = 4 / 3 * np.pi * (0.4 * 32) ** 3
    assert 0.7 * expect < vol < 1.3 * expect, (vol, expect)
    # center is filled (only a solid fill can do that)
    assert vox[0, 16, 16, 16] == 1
    # corners are empty
    assert vox[0, 0, 0, 0] == 0 and vox[0, -1, -1, -1] == 0


def test_cube_is_solid_box():
    v, f = data.test_meshes('cube')
    v = v * (0.45 / 0.6)  # keep inside the [-0.5, 0.5] convention
    fv = core.face_vertices(torch.from_numpy(v)[None],
                            torch.from_numpy(f)[None])
    vs = 32
    fv_n = fv * vs / (vs - 1) + 0.5
    vox = voxelize.voxelization(fv_n, vs, False).numpy()
    vol = vox.sum()
    side = 0.9 * vs * vs / (vs - 1)
    expect = side ** 3
    assert 0.75 * expect < vol < 1.35 * expect, (vol, expect)
    assert vox[0, 16, 16, 16] == 1


def test_open_surface_stays_hollow_free():
    # a single large triangle: no interior, only surface cells
    tri = np.array([[[0.2, 0.2, 0.5], [0.8, 0.2, 0.5],
                     [0.2, 0.8, 0.5]]], np.float32)[None]
    vox = voxelize.voxelization(torch.from_numpy(tri), 16, False).numpy()
    assert vox.sum() > 0
    # thin sheet: much less than any solid
    assert vox.sum() < 16 ** 3 * 0.2


def _faces(name, vs):
    if name == 'cube':
        v, f = data.test_meshes('cube')
        v = v * 0.5  # half side 0.3: clear of the grid's boundary cells
    elif name == 'tilted cube':
        v, f = data.test_meshes('cube')
        a, b = 0.4, 0.7
        rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]]) @ np.array(
            [[1, 0, 0], [0, np.cos(b), -np.sin(b)],
             [0, np.sin(b), np.cos(b)]])
        v = (v @ rot.T * 0.5).astype(np.float32)
    else:
        v, f = data.icosphere(2)
        v = v * 0.4
    fv = np.asarray(JG.face_vertices(jnp.asarray(v)[None],
                                     jnp.asarray(f)[None]))
    return (fv * vs / (vs - 1) + 0.5).astype(np.float32)


@pytest.mark.parametrize('name', ['cube', 'tilted cube', 'icosphere'])
def test_voxelization_equals_jax(name):
    """Exact: the same float32 operations in the same order decide every
    cell, and the flood fill is integer logic."""
    vs = 16
    fv = _faces(name, vs)
    want = np.asarray(JV.voxelization(jnp.asarray(fv), vs, False))
    got = voxelize.voxelization(torch.from_numpy(fv), vs, False)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < vs ** 3
    # and the stages on their own
    surface = voxelize.voxelize_surface(torch.from_numpy(fv) * 1.0, vs)
    np.testing.assert_array_equal(
        surface.numpy(), np.asarray(JV.voxelize_surface(jnp.asarray(fv),
                                                        vs)))
    np.testing.assert_array_equal(
        voxelize.fill_interior(surface).numpy(),
        np.asarray(JV.fill_interior(jnp.asarray(surface.numpy()))))


def test_voxelization_batches_and_scales():
    """A batch of two meshes voxelizes each on its own; normalize=True
    takes coordinates already in grid cells."""
    vs = 16
    a, b = _faces('cube', vs), _faces('tilted cube', vs)
    both = torch.from_numpy(np.concatenate([a, b]))
    got = voxelize.voxelization(both, vs, False)
    for i, fv in enumerate((a, b)):
        np.testing.assert_array_equal(
            got[i].numpy(),
            voxelize.voxelization(torch.from_numpy(fv), vs, False)[0].numpy())
    assert not np.array_equal(got[0].numpy(), got[1].numpy())
    np.testing.assert_array_equal(
        voxelize.voxelization(torch.from_numpy(a) * vs, vs, True).numpy(),
        got[:1].numpy())


def test_flood_fill_needs_more_than_one_batch_of_steps():
    """A spiral corridor longer than FILL_BATCH cells: the fixpoint is
    reached only after several batches, and equals the JAX loop's."""
    vs = 24
    walls = np.zeros((1, vs, vs, vs), np.int32)
    walls[:, 1:-1, 1:-1, 1:-1] = 1
    path = [(1, j, 12) for j in range(1, 20)] + [(i, 19, 12)
                                                  for i in range(1, 20)]
    for i, j, k in path:
        walls[0, i, j, k] = 0
    walls[0, 0, 1, 12] = 0          # the corridor's mouth on the boundary
    assert len(path) > 3 * voxelize.FILL_BATCH
    got = voxelize.fill_interior(torch.from_numpy(walls)).numpy()
    want = np.asarray(JV.fill_interior(jnp.asarray(walls)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 19, 19, 12] == 0   # the corridor's far end was reached
