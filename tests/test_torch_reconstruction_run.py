"""The reconstruction experiment's training run against the JAX script's
on the CPU: the initial weights at the published width, and 12 steps of
the port's own loop (``train``: Adam, the x0.3 decay of lr and tau, an
evaluation, BatchNorm's running statistics) against the JAX script's step
(experiments/train_reconstruction.py:582-603 and 647-663, rebuilt here as
tests/test_torch_reconstruction.py's jax_step fixture rebuilds it) from
the same weights on the same batches, at that file's small widths.

Tolerances, each stated where it is used and derived from the one-step
tests of tests/test_torch_reconstruction.py: after one step both sides
agree to float32 rounding (loss rtol 1e-4, parameters 1e-5); after that
they start each step from parameters that rounding has already moved
apart, and a pair at the edge of the uniform CDF's box or the 1e-6 cull
adds or drops coverage (ROADMAP Queue 3, "Tail coverage near the 1e-6
cull"), so the bounds of later steps are wider, each far inside what a
wrong decay, a lost Adam state or an evaluation that moves the state
would do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gendr_tpu
from gendr_tpu import data as jdata
from gendr_tpu.geometry import core as jcore, voxelize as jvoxelize
from gendr_tpu_torch import data, interop
from gendr_tpu_torch.experiments import train_reconstruction as TR
from experiments import train_reconstruction as JTR
from experiments.common import iou_loss as jiou_loss
from test_torch_reconstruction import (BATCH, LR, SIZE, _flax_models,
                                       _flax_weights, _port_models,
                                       _prefixed, _rel)
from torch_threads import one_torch_thread  # noqa: F401

STEPS, DECAY_AT, EVAL_AT = 12, 6, 4


# ---------------------------------------------------------------------------
# the initial weights at the published width
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def initial_weights():
    """(the port's state dicts, flax's converted by interop) of the
    published model at seed 0: the port's build_experiment, flax's
    encoder.init / decoder.init as the JAX script calls them
    (experiments/train_reconstruction.py:547-552)."""
    args = TR.parse_args(['--device', 'cpu', '--seed', '0'])
    exp = TR.build_experiment(args, 'cpu')
    rng = jax.random.PRNGKey(args.seed)
    v = jnp.asarray(jdata.sphere(642)[0])
    enc = JTR.Encoder().init(rng, jnp.zeros((1, 4, args.image_size,
                                             args.image_size)), train=False)
    dec = JTR.Decoder(nv=v.shape[0]).init(rng, jnp.zeros((1, 512)), v)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want = interop.reconstruction_params_from_jax(
        dict(enc=as_np(enc['params']), dec=as_np(dec['params'])),
        as_np(enc['batch_stats']))
    got = (exp.encoder.state_dict(), exp.decoder.state_dict())
    return {f'{part}.{k}': (g[k], w[k]) for part, g, w in
            zip(('encoder', 'decoder'), got, want) for k in w}


# every tensor of the model (the names do not depend on the widths)
TENSORS = [f'{part}.{k}' for part, module in (
    ('encoder', TR.Encoder(dim1=1, dim2=1, dim_out=1, image_size=8)),
    ('decoder', TR.Decoder(data.icosphere(0)[0], dim_in=1, width=1)))
    for k in module.state_dict()]


@pytest.mark.parametrize('name', TENSORS)
def test_initial_weights_match_flax(initial_weights, name):
    """The same shape; a bias, BatchNorm's offset and running mean 0, and
    its scale and running variance 1, where flax's are; a kernel's
    standard deviation within 3 % of flax's (lecun-normal: the estimate
    of a tensor of 6 144 entries or more errs by about 1 %) and its mean
    within 3 % of that deviation."""
    got, want = (x.numpy() for x in initial_weights[name])
    assert got.shape == want.shape and got.dtype == want.dtype
    if name.endswith('.weight') and '.bns.' not in name:
        assert want.size >= 6144
        np.testing.assert_allclose(got.std(), want.std(), rtol=3e-2)
        assert abs(got.mean()) < 3e-2 * want.std()
        assert abs(want.mean()) < 3e-2 * want.std()
    else:
        assert np.unique(want).size == 1
        assert float(want.flat[0]) in (0.0, 1.0)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 12 steps of the run, across the decay and an evaluation
# ---------------------------------------------------------------------------

def _jax_run(params, stats, dataset, seed, tau):
    """The JAX script's run: its train_step_body jitted (lr and dist_scale
    x0.3 from DECAY_AT on, given to the step as numbers; tau the
    renderer's), the batches drawn from RandomState(seed), and its
    evaluation's predict_voxels after step EVAL_AT.  Returns (the losses, the mean IoU of that
    evaluation in percent, the BatchNorm statistics after it, the
    parameters after the last step), as numpy."""
    encoder, decoder = _flax_models()
    v, f = jdata.icosphere(2)
    vertices_base, faces_t = jnp.asarray(v), jnp.asarray(f)
    laplacian = gendr_tpu.LaplacianLoss(v, f)
    flatten = gendr_tpu.FlattenLoss(f)
    lighting = gendr_tpu.Lighting()
    transform = gendr_tpu.LookAt(viewing_angle=15)
    renderer = gendr_tpu.GenDR(
        image_size=SIZE, dist_func='uniform', dist_scale=1.0,
        dist_squared=False, dist_shape=0, dist_shift=0, dist_eps=300.,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0,
        aggr_rgb_func='hard', backend='xla', channels='alpha')

    def reconstruct(p, bs, images, train):
        variables = {'params': p['enc'], 'batch_stats': bs}
        if train:
            feats, mut = encoder.apply(variables, images, train=True,
                                       mutable=['batch_stats'])
            bs = mut['batch_stats']
        else:
            feats = encoder.apply(variables, images, train=False)
        return decoder.apply({'params': p['dec']}, feats,
                             vertices_base), bs

    def loss_fn(p, bs, images_a, images_b, eyes_a, eyes_b, dist_scale):
        vertices, bs = reconstruct(
            p, bs, jnp.concatenate([images_a, images_b], 0), True)
        lap = jnp.mean(laplacian(vertices))
        flat = jnp.mean(flatten(vertices))
        vertices2 = jnp.concatenate([vertices, vertices], 0)
        eyes = jnp.concatenate([eyes_a, eyes_a, eyes_b, eyes_b], 0)
        mesh = gendr_tpu.Mesh.create(
            vertices2, jnp.tile(faces_t[None], (vertices2.shape[0], 1, 1)))
        transform.set_eyes(eyes)
        renderer.dist_scale = dist_scale
        sils = renderer(transform(lighting(mesh)))[:, 3]
        raa, rba, rab, rbb = jnp.split(sils, 4)
        ta, tb = images_a[:, 3], images_b[:, 3]
        sil = (jiou_loss(raa, ta) + jiou_loss(rba, ta) + jiou_loss(rab, tb)
               + jiou_loss(rbb, tb)) / 4
        return sil + 5e-3 * lap + 5e-4 * flat, bs

    opt = optax.adam(LR)

    @jax.jit
    def train_step(p, bs, opt_state, ia, ib, ea, eb, dist_scale,
                   lr_scale):
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, bs, ia, ib, ea, eb, dist_scale)
        updates, opt_state = opt.update(grads, opt_state)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        return optax.apply_updates(p, updates), bs, opt_state, loss

    @jax.jit
    def predict_voxels(p, bs, images):
        vertices, _ = reconstruct(p, bs, images, False)
        fv = jcore.face_vertices(vertices, jnp.tile(
            faces_t[None], (vertices.shape[0], 1, 1)))
        vox = jvoxelize.voxelization(fv * 1.0 * (32. - 1) / 32. + 0.5, 32,
                                     False)
        return jnp.transpose(vox, (0, 2, 1, 3))[:, :, :, ::-1]

    rng = np.random.RandomState(seed)
    p, bs, opt_state = params, stats, opt.init(params)
    losses = []
    for i in range(1, STEPS + 1):
        scale = 0.3 if i >= DECAY_AT else 1.0
        batch = dataset.get_random_batch(rng, BATCH)
        p, bs, opt_state, loss = train_step(
            p, bs, opt_state, *map(jnp.asarray, batch),
            jnp.float32(tau * scale), jnp.float32(scale))
        losses.append(float(loss))
        if i == EVAL_AT:
            # the script's evaluate, cut to its first batch
            im, vx = next(dataset.get_all_batches_for_evaluation(
                BATCH, 'syn_box'))
            pred = np.asarray(predict_voxels(p, bs, jnp.asarray(im)))
            iou = float(((vx * pred).sum((1, 2, 3)) / np.maximum(
                ((vx + pred) > 0).sum((1, 2, 3)), 1)).mean() * 100)
            eval_stats = jax.tree_util.tree_map(np.asarray, bs)
    return (np.asarray(losses), iou, eval_stats,
            jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope='module')
def datasets():
    """The JAX synthetic dataset (one syn_box object, 24 views at 16x16),
    and the port's holding the same silhouettes and voxels (each
    package's renders differ on edge ties, tests/test_torch_reconstruction
    .py), so both runs see the same batches."""
    want = JTR.SyntheticShapeNet(1, SIZE, 0, class_ids=('syn_box',))
    got = TR.SyntheticShapeNet(1, SIZE, 0, class_ids=('syn_box',),
                               device='cpu')
    got.images, got.voxels = want.images.copy(), want.voxels.copy()
    return got, want


def test_twelve_steps_match_jax(datasets, monkeypatch):
    """The port's train() (--decay-at 6, an evaluation every 4 steps, on
    the CPU) against the JAX script's step from the same weights on the
    same batches:

    - each step's loss within rtol 1e-4 at the first step (the one-step
      test's) and 1e-3 after it (measured at most 2.3e-4 over the weight
      seeds 0-2; the decay of tau alone moves it by 10 %);
    - the evaluation after step 4 leaves every BatchNorm statistic as it
      was, bitwise; those statistics against the JAX run's: the running
      variance rtol 1e-4, the running mean within 1e-4 of its scale plus
      2 lr per step (a convolution's bias, whose exact gradient is 0,
      shifts its channel's mean, and Adam moves it on rounding noise by up
      to lr a step on each side); its mean IoU within 1 point;
    - the parameters after step 12: a convolution's bias within lr a step
      on both sides (as _assert_params_close); every other tensor's change
      over the 12 steps norm-relative within 3e-2 of the JAX run's
      (measured at most 1.2e-2: Adam's step is lr times m / sqrt(v), whose
      entries move by their gradient's relative difference, large where
      the gradient is small; lr decayed one step late moves it by more
      than 1e-1)."""
    params, stats = _flax_weights()
    got_data, want_data = datasets
    seed = 0
    args = TR.parse_args([
        '--synthetic', '--class_ids', 'syn_box', '--image_size', str(SIZE),
        '--batch_size', str(BATCH), '-lr', str(LR), '-ni', str(STEPS),
        '--print_freq', str(EVAL_AT), '--eval_freq', str(EVAL_AT),
        '--decay-at', str(DECAY_AT), '--max-eval-batches', '1',
        '--seed', str(seed), '--device', 'cpu'])
    # the script's default tau, 10^-1.5 from its float32 table
    tau = JTR.default_dist_scale('uniform', False, 'probabilistic', 0.0)
    assert args.dist_scale == tau
    want_losses, want_iou, want_stats, want_params = _jax_run(
        params, stats, want_data, seed, tau)

    runs = []

    def build_experiment(args, device, mesh=None):
        encoder, decoder = _port_models(params, stats)
        exp = TR.Reconstruction(args, encoder, decoder,
                                data.icosphere(2)[1], device, mesh)
        evaluate = exp.evaluate

        def evaluate_and_keep(dataset, label, log=print):
            before = _stats(exp)
            iou = evaluate(dataset, label, log)
            runs.append((before, _stats(exp), iou))
            return iou
        exp.evaluate = evaluate_and_keep
        runs.append(exp)
        return exp
    monkeypatch.setattr(TR, 'build_experiment', build_experiment)
    monkeypatch.setattr(TR, 'make_datasets',
                        lambda args, device: (got_data, got_data))
    result = TR.train(args, 'cpu')
    exp, (before, after, iou), *_ = runs

    losses = np.asarray(result['losses'])
    assert losses.shape == (STEPS,)
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=1e-4)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)

    for k in before:
        assert torch.equal(before[k], after[k]), k
    wenc, _ = interop.reconstruction_params_from_jax(want_params,
                                                     want_stats)
    for k, v in after.items():
        w = wenc[k].numpy()
        if k.endswith('running_var'):
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(
                v.numpy(), w, rtol=0,
                atol=1e-4 * np.abs(w).max() + 2 * LR * EVAL_AT, err_msg=k)
    assert abs(iou - want_iou) < 1.0

    got = {**_prefixed('encoder', exp.encoder.state_dict()),
           **_prefixed('decoder', exp.decoder.state_dict())}
    start = dict(zip(('encoder', 'decoder'), _port_models(params, stats)))
    wenc, wdec = interop.reconstruction_params_from_jax(want_params, stats)
    want = {**_prefixed('encoder', wenc), **_prefixed('decoder', wdec)}
    for name, w in want.items():
        if 'running' in name:
            continue
        part, k = name.split('.', 1)
        g, w = got[name].numpy(), w.numpy()
        if part == 'encoder' and k.startswith('convs.') \
                and k.endswith('.bias'):
            assert max(np.abs(g).max(), np.abs(w).max()) \
                <= LR * STEPS * 1.001, name
            continue
        p0 = start[part].state_dict()[k].numpy()
        assert _rel(g - p0, w - p0) < 3e-2, name


def _stats(exp):
    return {k: v.clone() for k, v in exp.encoder.state_dict().items()
            if 'running' in k}


def test_recon_steps_finds_a_jump():
    """gendr_tpu_torch/tools/recon_steps.py's rule: a step's loss over the
    median of the 200 before it, after the first 1 000 steps (1-based
    steps); on the CPU the tool itself stops, it needs the card."""
    from gendr_tpu_torch.tools import recon_steps as RS
    losses = list(np.linspace(0.1, 0.05, 1500))
    losses[1300] = 0.5
    losses[10] = 5.0  # inside the first 1 000 steps: not looked at
    (ratio, step), *_ = sorted(RS.jumps(losses), reverse=True)
    assert step == 1301 and ratio > 8
    if not torch.cuda.is_available():
        assert RS.main(['--steps', '1500']) == 1
