"""The port's API surface: the counterpart of tests/test_api_surface.py
(defaults, the functional mirror, utils), and that no module of the port
imports jax or the JAX package."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

import gendr_tpu
import gendr_tpu.functional as JF
import gendr_tpu_torch as G
from gendr_tpu_torch import functional as F
from gendr_tpu_torch import utils
from tests.test_render import random_scene
from torch_threads import one_torch_thread  # noqa: F401

PORT = pathlib.Path(G.__file__).resolve().parent
FUNCTIONAL_NAMES = [
    'get_points_from_angles', 'look', 'look_at', 'perspective', 'orthogonal',
    'projection', 'ambient_lighting', 'directional_lighting',
    'face_vertices', 'vertex_normals', 'surface_normals', 'load_obj',
    'save_obj', 'save_voxel', 'load_mtl', 'load_textures',
    'create_texture_image', 'render', 'voxelization']


@pytest.mark.parametrize('name', FUNCTIONAL_NAMES)
def test_functional_mirrors_the_jax_package(name):
    assert callable(getattr(F, name)) and callable(getattr(JF, name))
    # the shared parameters come in the same order with the same defaults
    got = inspect.signature(getattr(F, name)).parameters
    want = inspect.signature(getattr(JF, name)).parameters
    shared = [p for p in want if p in got]
    assert shared == [p for p in got if p in want]
    assert len(shared) >= min(len(want), 1)
    for p in shared:
        if p in ('backend', 'on_fallback'):
            continue  # 'cuda'/'torch' here, 'pallas'/'xla' there
        assert got[p].default == want[p].default, (name, p)


def test_functional_names_are_all_of_the_jax_packages():
    public = {n for n in dir(JF) if not n.startswith('_')
              and callable(getattr(JF, n))}
    assert public == set(FUNCTIONAL_NAMES)
    assert public <= set(dir(F))


def test_package_exports():
    for name in ('RenderConfig', 'RenderParams', 'Mesh', 'LookAt', 'Look',
                 'Projection', 'AmbientLighting', 'DirectionalLighting',
                 'Lighting', 'LaplacianLoss', 'FlattenLoss', 'GenDR',
                 'functional'):
        assert hasattr(G, name) and hasattr(gendr_tpu, name), name
    assert G.functional is F
    # float32 matmuls stay float32 on the card
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_gendr_defaults_match_reference():
    """Constructor defaults mirror gendr/renderer.py:13-36."""
    r, j = G.GenDR(), gendr_tpu.GenDR()
    for name in ('image_size', 'anti_aliasing', 'dist_func', 'dist_scale',
                 'dist_squared', 'dist_eps', 'aggr_alpha_func',
                 'aggr_rgb_func', 'aggr_rgb_eps', 'aggr_rgb_gamma', 'near',
                 'far', 'double_side', 'texture_type'):
        assert getattr(r, name) == getattr(j, name), name
    assert list(r.background_color) == [0, 0, 0]
    assert r.image_size == 256 and r.aggr_rgb_func == 'softmax'


def test_functional_render_default_double_side():
    """functional.render defaults double_side=True while GenDR defaults
    False: the reference's quirk, kept by both packages."""
    assert inspect.signature(F.render).parameters['double_side'].default \
        is True


def test_enum_int_duality():
    rng = np.random.RandomState(0)
    fv = torch.from_numpy(random_scene(rng, B=1, F=5))
    tex = torch.ones((1, 5, 1, 3))
    a = F.render(fv, tex, image_size=16, dist_func='logistic',
                 aggr_alpha_func='probabilistic', aggr_rgb_func='softmax')
    b = F.render(fv, tex, image_size=16, dist_func=6, aggr_alpha_func=2,
                 aggr_rgb_func=1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_forward_tensors_matches_mesh_call():
    from gendr_tpu_torch import data
    v, f = data.icosphere(1)
    mesh = G.Mesh.create(v * 0.5, f, device='cpu')
    t = G.LookAt()
    t.set_eyes_from_angles(2.732, 30.0, 0.0)
    mesh = t(mesh)
    r = G.GenDR(image_size=16)
    np.testing.assert_array_equal(
        r(mesh).numpy(),
        r.forward_tensors(mesh.face_vertices, mesh.face_textures).numpy())


def test_average_meter():
    from gendr_tpu import utils as jutils
    m, j = utils.AverageMeter(), jutils.AverageMeter()
    for val, n in ((1.0, 1), (3.0, 2), (0.5, 5)):
        m.update(val, n)
        j.update(val, n)
    assert (m.val, m.avg, m.sum, m.count) == (j.val, j.avg, j.sum, j.count)
    m.reset()
    assert m.count == 0 and m.avg == 0.0


def test_timer_and_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {'out': [x * 2, (x + 1,)]}

    x = torch.ones(4)
    best = utils.Timer.timeit(fn, x, iters=3, repeats=2)
    assert best >= 0.0 and len(calls) == 1 + 3 * 2
    assert utils.Timer.sync(fn(x))['out'][0].tolist() == [2.0] * 4
    assert utils.Timer.sync(None) is None
    with utils.trace(str(tmp_path / 'off'), enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / 'off').exists()
    with utils.trace(str(tmp_path / 'on')) as prof:
        fn(x)
    assert (tmp_path / 'on' / 'trace.json').stat().st_size > 0
    assert len(prof.key_averages()) > 0


NEW_MODULES = [
    'geometry/obj_io.py', 'geometry/voxelize.py', 'geometry/transforms.py',
    'native/__init__.py', 'native/objparse.py', 'functional/__init__.py',
    'utils/__init__.py', 'utils/metrics.py', 'utils/profiling.py',
    'utils/png.py', 'experiments/opt_camera.py', 'experiments/common.py',
    'animations/common.py', 'interop.py', '_build.py', 'device.py',
    'parallel/__init__.py', 'parallel/sharding.py']


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('module', NEW_MODULES)
def test_module_imports_neither_jax_nor_the_jax_package(module):
    """Static on purpose (tests/test_torch_config.py): sys.modules cannot
    show it where jax is preloaded."""
    path = PORT / module
    roots = {m.split('.')[0] for m in _imports(path)}
    assert not roots & {'jax', 'jaxlib', 'flax', 'optax', 'orbax',
                        'gendr_tpu', 'experiments', 'animations', 'tools',
                        'imageio', 'skimage'} - _optional(module)


def _optional(module):
    # imageio stays an optional dependency of the GIF writer alone
    return {'imageio'} if module == 'experiments/common.py' else set()


def test_native_source_is_the_ports_own_copy():
    from gendr_tpu_torch import _build
    src = _build.NATIVE / 'objparse.cpp'
    assert src.exists() and PORT in src.parents
    assert _build.native_library_path('objparse').parent == _build.CACHE
    jax_copy = PORT.parent / 'gendr_tpu' / 'native' / 'objparse.cpp'
    strip = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if not ln.startswith('//')]
    assert strip(src.read_text()) == strip(jax_copy.read_text())


def _tiny_obj(tmp_path):
    path = tmp_path / 'tri.obj'
    path.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    return str(path)


# each entry point that makes tensors, called without a device
NO_DEVICE_CALLS = {
    'Mesh.create': lambda p: G.Mesh.create(np.eye(3), [[0, 1, 2]]),
    'Mesh.from_obj': lambda p: G.Mesh.from_obj(_tiny_obj(p)),
    'load_obj': lambda p: F.load_obj(_tiny_obj(p)),
    'sample_textures_from_image': lambda p: __import__(
        'gendr_tpu_torch.geometry.obj_io', fromlist=['x'])
    .sample_textures_from_image(np.ones((2, 2, 3)), np.zeros((1, 3, 2)), 1),
    'mesh_from_numpy': lambda p: __import__(
        'gendr_tpu_torch.interop', fromlist=['x'])
    .mesh_from_numpy(np.eye(3), [[0, 1, 2]]),
    'camera_poses_from_numpy': lambda p: __import__(
        'gendr_tpu_torch.interop', fromlist=['x'])
    .camera_poses_from_numpy(np.ones((1, 4))),
    'triangle_scene': lambda p: __import__(
        'gendr_tpu_torch.animations.common', fromlist=['x']).triangle_scene(),
    'textured_scene': lambda p: __import__(
        'gendr_tpu_torch.animations.common', fromlist=['x'])
    .textured_scene(2),
}


@pytest.mark.parametrize('name', sorted(NO_DEVICE_CALLS))
def test_entry_point_without_a_device_wants_the_card(name, tmp_path,
                                                     monkeypatch):
    """device=None means the card: without one the entry point raises and
    names device='cpu'; it never carries on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NO_DEVICE_CALLS[name](tmp_path)


def test_resolve_device_rule(monkeypatch):
    from gendr_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert resolve_device() == torch.device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')
    # a tensor argument names the device: a CPU mesh stays on the CPU
    assert resolve_device(None, np.ones(3), torch.ones(3)) \
        == torch.device('cpu')
    mesh = G.Mesh.create(torch.eye(3), [[0, 1, 2]])
    assert mesh.vertices.device.type == 'cpu'
    assert mesh.faces.device.type == 'cpu'
