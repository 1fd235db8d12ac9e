"""The camera experiment of the port (experiments/opt_camera.py) against
the JAX experiment: ``transform_cameras`` on the same poses, the pose
batches, a few optimisation steps on the CPU, and the command line.

Tolerance: camera-space coordinates within 2e-6 absolute and 1e-5 relative
(two look_at rotations and a perspective divide in float32 in each
library; NDC x and y reach a few units where z is small).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import gendr_tpu
from experiments import opt_camera as JOC
from gendr_tpu_torch import data, interop
from gendr_tpu_torch.experiments import opt_camera as OC
from gendr_tpu_torch.raster import pairmath as PM
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-6, rtol=1e-5)


def _args(*extra):
    return OC.parse_args(['--device', 'cpu', '-is', '16', '-bs', '4',
                          '--model_obj', 'proc_cube.obj', *extra])


@pytest.mark.parametrize('with_goal', [False, True])
def test_transform_cameras_matches_jax(with_goal):
    v, _ = data.icosphere(1)
    B = 6
    verts = np.tile(v[None] * 0.5, (B, 1, 1)).astype(np.float32)
    poses = OC.initial_poses(B, 15, 35)
    goal = OC.goal_poses(B) if with_goal else None
    got = OC.transform_cameras(
        torch.from_numpy(verts), interop.camera_poses_from_numpy(poses, 'cpu'),
        None if goal is None else interop.camera_poses_from_numpy(goal, 'cpu'))
    want = JOC.transform_cameras(
        jnp.asarray(verts), jnp.asarray(poses),
        None if goal is None else jnp.asarray(goal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pose_batches_follow_the_jax_experiment():
    """The goal and the initial poses are the JAX script's, drawn from the
    same numpy streams (opt_camera.py:113-117, 136-146 there)."""
    B = 8
    rng = np.random.RandomState(1)
    want = np.zeros((B, 4), np.float32)
    want[:, 0] = 2.5 + rng.rand(B) * 1.5
    want[:, 1] = rng.randn(B) * 60
    want[:, 2] = rng.randn(B) * 60
    want[:, 3] = 20.0
    np.testing.assert_array_equal(OC.goal_poses(B), want)
    init = OC.initial_poses(B, 35, 55)
    ang = np.sqrt(init[:, 1] ** 2 + init[:, 2] ** 2)
    assert ((ang > 35 - 1e-3) & (ang < 55 + 1e-3)).all()
    assert ((init[:, 0] >= 2) & (init[:, 0] <= 10)).all()
    assert ((init[:, 3] >= 10) & (init[:, 3] <= 30)).all()
    p = interop.camera_poses_from_numpy(init, 'cpu', requires_grad=True)
    assert p.requires_grad and p.is_leaf and tuple(p.shape) == (B, 4)
    with pytest.raises(ValueError, match=r'\[B, 4\]'):
        interop.camera_poses_from_numpy(init[:, :3], 'cpu')


def test_goal_render_matches_jax():
    """The hard-rendered goal silhouettes of the same poses, both
    packages: equal but for pixels whose centre lies within float32
    rounding of an edge (at most 1 %)."""
    args = _args()
    exp = OC.CameraExperiment(args, 'cpu')
    mv, mf = data.test_meshes('cube')
    mesh = gendr_tpu.Mesh.create(mv, mf).repeat(4)
    verts = JOC.transform_cameras(mesh.vertices, jnp.asarray(OC.goal_poses(4)))
    hard = gendr_tpu.GenDR(
        image_size=16, dist_func=0, dist_scale=1e-4, dist_squared=True,
        dist_shape=0., dist_shift=0., dist_eps=10, aggr_alpha_func=0,
        aggr_alpha_t_conorm_p=0., aggr_rgb_func='hard', backend='xla',
        channels='alpha')
    want = np.asarray(hard(gendr_tpu.Mesh.create(verts, mesh.faces)))[:, 3]
    got = exp.goal[:, 3].numpy()
    assert got.shape == want.shape == (4, 16, 16)
    assert set(np.unique(got)) <= {0.0, 1.0} and 0 < got.mean() < 1
    assert (got != want).mean() <= 0.01


def test_a_few_steps_on_the_cpu():
    """40 annealed steps at 16x16 with 4 poses: the losses stay finite and
    fall, the poses move and stay finite, and the soft renderer's
    parameter vector follows the anneal without a rebuild."""
    args = _args('-ni', '40', '-lr', '0.1')
    exp = OC.CameraExperiment(args, 'cpu')
    init = OC.initial_poses(4, 15, 35)
    rec = exp.run(init)
    losses = np.array(rec['losses'])
    assert rec['iterations'] == 40 and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert np.isfinite(rec['poses']).all()
    assert np.abs(rec['poses'] - init).max() > 1e-2
    assert float(exp.par[PM.P_SCALE]) == pytest.approx(1e-7)
    # the first step's loss is the JAX experiment's IoU loss of the same
    # render: sum over the batch of 1 - IoU
    loss0, pred = exp.loss_fn(interop.camera_poses_from_numpy(init, 'cpu'), 0.1)
    assert float(loss0) == pytest.approx(losses[0], rel=1e-6)
    assert tuple(pred.shape) == (4, 4, 16, 16)


def test_adam_matches_optax():
    """torch.optim.Adam(lr, betas=(0.5, 0.99)) is the JAX experiment's
    optax.adam(1.0, b1=0.5, b2=0.99) with its updates scaled by lr."""
    import optax
    rng = np.random.RandomState(0)
    p0 = rng.randn(4, 4).astype(np.float32)
    grads = rng.randn(5, 4, 4).astype(np.float32)
    exp = OC.CameraExperiment(_args(), 'cpu')
    p = torch.tensor(p0, requires_grad=True)
    opt = exp.make_optimizer(p, 0.3)
    jopt = optax.adam(1.0, b1=0.5, b2=0.99)
    jp, state = jnp.asarray(p0), None
    state = jopt.init(jp)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        updates, state = jopt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, updates * 0.3)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-6)


def test_command_line_defaults_and_quick(tmp_path):
    a = OC.parse_args([])
    assert (a.dist_func, a.aggr_func, a.model_obj) == (
        'logistic', 'probabilistic', 'teapot.obj')
    assert (a.learning_rate, a.num_iterations, a.image_size, a.batch_size,
            a.dist_eps, a.losses) == (0.3, 1000, 64, 200, 100, ['iou'])
    assert a.device == 'cuda' and a.backend is None and not a.squared
    assert a.chain == 20  # the JAX script's default
    q = OC.parse_args(['--quick'])
    assert (q.num_iterations, q.batch_size) == (50, 16)
    q = OC.parse_args(['--quick', '-ni', '3', '-bs', '2'])
    assert (q.num_iterations, q.batch_size) == (3, 2)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match='--device cpu'):
            OC.main(['--quick'])
    res = OC.main(['--quick', '-ni', '3', '-bs', '4', '-is', '16', '--device',
                   'cpu', '-lo', 'iou', 'mse', '--out-dir', str(tmp_path)])
    assert set(res) == {(15, 35, 'iou'), (15, 35, 'mse')}
    assert all(0.0 <= r <= 1.0 for r in res.values())


def test_gif_without_imageio_stops_before_any_step(monkeypatch, tmp_path):
    """--gif needs imageio, an optional dependency: where it is missing the
    run stops at once with an error naming it (opt_shape likewise)."""
    import builtins
    import sys
    from gendr_tpu_torch.experiments import common, opt_shape as OS
    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name.split('.')[0] == 'imageio':
            raise ImportError('No module named imageio')
        return real_import(name, *a, **k)

    for mod in [m for m in sys.modules if m.split('.')[0] == 'imageio']:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, '__import__', no_imageio)
    built = []
    monkeypatch.setattr(OC, 'CameraExperiment',
                        lambda *a, **k: built.append(1))
    monkeypatch.setattr(OS, 'ShapeExperiment',
                        lambda *a, **k: built.append(1))
    with pytest.raises(SystemExit, match='imageio'):
        OC.main(['--quick', '--gif', '--device', 'cpu', '--out-dir',
                 str(tmp_path)])
    with pytest.raises(SystemExit, match='imageio'):
        OS.main(['--quick', '--gif', '--device', 'cpu', '--out-dir',
                 str(tmp_path)])
    assert built == []
    monkeypatch.setattr(builtins, '__import__', real_import)
    common.require_gif_support('x')  # installed here: no error
