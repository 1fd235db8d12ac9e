"""The shape experiment of the port against the JAX experiment on the CPU,
the slice as a whole: ShapeModel -> Lighting -> LookAt -> GenDR (alpha) ->
IoU + Laplacian + flatten -> gradient -> Adam.

Both sides start from the same parameters (carried across by
``interop.shape_params_from_jax``) and see the same target silhouettes and
cameras, made once with numpy and the JAX package.  Tolerances: vertices
and regularizers to float32 rounding (rtol 1e-5); the loss to rtol 1e-4;
the gradients with tests/test_pallas.py's budgeted comparison (atol 2e-4
relative to the largest entry, rtol 2e-3), since a pair within an ulp of a
triangle edge can flip between the two libraries; Adam's first step moves
each parameter by lr * g / (|g| + eps), so the parameters after it agree
to atol 1e-5 wherever the gradients do.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import gendr_tpu
from gendr_tpu.geometry import transforms as JT
from gendr_tpu_torch import interop
from gendr_tpu_torch.experiments import opt_shape as OS
from gendr_tpu_torch.experiments.common import iou_loss
from gendr_tpu_torch.geometry.losses import FlattenLoss, LaplacianLoss
from experiments import opt_shape as JOS
from experiments.common import iou_loss as jiou_loss
from tests.test_pallas import _assert_mostly_close
from torch_threads import one_torch_thread  # noqa: F401

NV = 162
SIZE = 24
LR = 10 ** -1.5
SIGMA = 3e-2


def _jax_params(seed=0):
    rng = np.random.RandomState(seed)
    return dict(displace=jnp.asarray(0.3 * rng.randn(1, NV, 3), jnp.float32),
                center=jnp.asarray(0.1 * rng.randn(1, 1, 3), jnp.float32))


def _port_model(params):
    model = OS.ShapeModel(NV)
    model.load_state_dict(interop.shape_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}), strict=False)
    return model


def test_shape_model_matches_jax():
    params = _jax_params()
    jmodel = JOS.ShapeModel(NV)
    want = jmodel(params, 2)
    got = _port_model(params)(2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
    # zero parameters give back the template
    model = OS.ShapeModel(NV)
    np.testing.assert_allclose(model(1)[0][0].detach().numpy(),
                               np.asarray(jmodel.base_vertices), atol=1e-5)


@pytest.mark.parametrize('average', [False, True])
def test_regularizers_match_jax(average):
    v, f = gendr_tpu.data.sphere(NV)
    x = (v[None] * (1 + 0.1 * np.random.RandomState(1).randn(2, NV, 1))) \
        .astype(np.float32)
    for port, ref in ((LaplacianLoss(v, f, average), gendr_tpu.LaplacianLoss(
            v, f, average)), (FlattenLoss(f, average),
                              gendr_tpu.FlattenLoss(f, average))):
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))),
                                   rtol=1e-5)
    # sparse: the Laplacian keeps one entry per directed edge
    assert LaplacianLoss(v, f).rows.numel() == 2 * (3 * f.shape[0] // 2)


def _jax_step(extra=()):
    """The JAX experiment's train step (experiments/opt_shape.py:157-183)
    on two views of its cube target at 24x24, with the xla backend; extra:
    further opt_shape arguments, which both experiments' renderers read."""
    args = OS.parse_args(['-is', str(SIZE), '--device', 'cpu', *extra])
    jmodel = JOS.ShapeModel(NV)
    lighting = gendr_tpu.Lighting()
    transform = gendr_tpu.LookAt(viewing_angle=15)
    diff, hard = JOS.build_renderers(args, 'xla')
    eyes = np.asarray(JT.get_points_from_angles(
        np.float32([2.732, 2.732]), np.float32([30.0, 30.0]),
        np.float32([0.0, -120.0])))
    tv, tf = gendr_tpu.data.test_meshes('cube')
    tmesh = gendr_tpu.Mesh.create(tv, tf).repeat(2)
    transform.set_eyes(jnp.asarray(eyes))
    targets = hard(transform(lighting(tmesh)))[:, 3]

    def loss_fn(params):
        verts, faces, lap, flat = jmodel(params, 2)
        mesh = lighting(gendr_tpu.Mesh.create(verts, faces))
        transform.set_eyes(jnp.asarray(eyes))
        diff.dist_scale = SIGMA
        images = diff(transform(mesh))[:, 3]
        return jiou_loss(images, targets) + 0.03 * lap + 0.0003 * flat

    params = _jax_params()
    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(1.0, b1=0.5, b2=0.95)
    updates, _ = opt.update(grads, opt.init(params))
    updates = jax.tree_util.tree_map(lambda u: u * LR, updates)
    new = optax.apply_updates(params, updates)
    as_np = {k: np.asarray(v) for k, v in new.items()}
    return dict(args=args, eyes=eyes, targets=np.asarray(targets),
                params=params, loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()},
                new=as_np)


@pytest.fixture(scope='module')
def jax_step():
    return _jax_step()


@pytest.fixture(scope='module')
def jax_step_yager():
    return _jax_step(['--aggr-func', 'yager', '--t_conorm_p', '2'])


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_train_step_matches_jax(jax_step, backend):
    _check_train_step(jax_step, backend)


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_train_step_with_a_parametric_fold_matches_jax(jax_step_yager,
                                                       backend):
    """opt_shape --aggr-func yager --t_conorm_p 2: through backend='cuda'
    the plain versions of K1c's serial fold and K2c's aggregate-inverse
    rule, against the JAX experiment's butterfly fold."""
    args = jax_step_yager['args']
    assert (args.aggr_func, args.t_conorm_p) == ('yager', 2.0)
    _check_train_step(jax_step_yager, backend)


def _check_train_step(jax_step, backend):
    exp = OS.ShapeExperiment(jax_step['args'], 'cpu', backend)
    exp.model = _port_model(jax_step['params'])
    eyes = torch.from_numpy(jax_step['eyes'])
    targets = torch.from_numpy(jax_step['targets'])
    assert 0.05 < float(targets.mean()) < 0.99

    opt = exp.make_optimizer(LR)
    loss, images, finite = exp.train_step(opt, eyes, targets, SIGMA)
    assert bool(finite) and images.shape == (2, SIZE, SIZE)
    np.testing.assert_allclose(float(loss), jax_step['loss'], rtol=1e-4)
    for name, p in exp.model.named_parameters():
        want = jax_step['grads'][name]
        assert float(np.abs(want).max()) > 0
        # the gradient Adam stepped with is still in .grad
        _assert_mostly_close(p.grad.numpy(), want,
                             atol=2e-4 * np.abs(want).max(), rtol=2e-3)
        close = np.isclose(p.grad.numpy(), want,
                           atol=2e-4 * np.abs(want).max(), rtol=2e-3)
        np.testing.assert_allclose(p.detach().numpy()[close],
                                   jax_step['new'][name][close], atol=1e-5)
    # the soft silhouette overlaps the targets
    assert float(iou_loss(images, targets)) < 1.0


def test_opt_shape_cli_quick(tmp_path):
    """python -m gendr_tpu_torch.experiments.opt_shape --quick at a tiny
    size: goals, the lr x sigma grid and the report run end to end."""
    results = OS.main(['--quick', '-ni', '2', '-is', '16', '--views', '24@0',
                       '--model_obj', 'proc_cube.obj', '--device', 'cpu',
                       '--out-dir', str(tmp_path)])
    lr, sigma, hard_loss = results['24@0']
    assert lr == pytest.approx(LR) and 0.0 <= hard_loss < 1.0


def test_load_or_make_mesh(tmp_path):
    from gendr_tpu_torch.experiments.common import load_or_make_mesh
    v, f = load_or_make_mesh('sphere_642.obj')
    assert v.shape == (642, 3) and f.shape == (1280, 3)
    v, f = load_or_make_mesh('missing_airplane.obj', str(tmp_path))
    np.testing.assert_array_equal(f, gendr_tpu.data.test_meshes('cube')[1])
    obj = tmp_path / 'plane.obj'
    obj.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    v, f = load_or_make_mesh(str(obj))
    np.testing.assert_array_equal(v, [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    np.testing.assert_array_equal(f, [[0, 1, 2]])
    assert v.dtype == np.float32 and f.dtype == np.int32
    # the file of that name in the data directory is found as well
    v2, _ = load_or_make_mesh('elsewhere/plane.obj', str(tmp_path))
    np.testing.assert_array_equal(v2, v)
