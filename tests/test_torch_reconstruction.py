"""The reconstruction experiment of the port against the JAX experiment on
the CPU: tables, synthetic shapes and dataset, the batch stream, Encoder
and Decoder on converted weights, the 2-view loss and its gradient, Adam,
and the voxel evaluation (checkpoint resume, --data-parallel and the CLI:
tests/test_torch_reconstruction_cli.py).

Both sides start from the same weights (flax's, carried across by
``interop.reconstruction_params_from_jax``) at small widths (Encoder 8 /
32 / 16, Decoder 16 wide on the 162-vertex icosphere, 16x16 images, a
batch of 2).  Tolerances, each stated where it is used: numpy code equal
exactly; network outputs to float32 rounding (rtol 1e-4); BatchNorm's
running statistics rtol 1e-5, while torch's unbiased rule would miss them
by n / (n - 1); the loss rtol 1e-4; gradients norm-relative (ROADMAP
Queue 3, "Summed vertex gradients"), 1e-3 per parameter; silhouettes on
99 % of pixels and voxels on 99.9 % of cells (edge ties between the
libraries, Queue 3).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import gendr_tpu
from gendr_tpu import data as jdata
from gendr_tpu.geometry import core as jcore, voxelize as jvoxelize
from gendr_tpu_torch import data, interop
from gendr_tpu_torch.experiments import train_reconstruction as TR
from experiments import train_reconstruction as JTR
from experiments.common import iou_loss as jiou_loss
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 16
NV = 162
DIMS = dict(dim1=8, dim2=32, dim_out=16)
WIDTH = 16
BATCH = 2
TAU = 10 ** -1.5
LR = 1e-4


def _flax_models():
    return (JTR.Encoder(dim_out=DIMS['dim_out'], dim1=DIMS['dim1'],
                        dim2=DIMS['dim2']),
            JTR.Decoder(nv=NV, width=WIDTH))


def _flax_weights(size=SIZE, seed=0):
    """(params, batch_stats) of the small flax models, BatchNorm scale,
    bias and statistics moved off their initial values."""
    encoder, decoder = _flax_models()
    key = jax.random.PRNGKey(seed)
    enc = encoder.init(key, jnp.zeros((1, 4, size, size)), train=False)
    dec = decoder.init(key, jnp.zeros((1, DIMS['dim_out'])),
                       jnp.asarray(jdata.icosphere(2)[0]))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, dict(enc=enc['params'],
                                                     dec=dec['params']))
    stats = jax.tree_util.tree_map(np.asarray, enc['batch_stats'])
    for i in range(3):
        bn = params['enc'][f'BatchNorm_{i}']
        n = bn['scale'].shape[0]
        bn['scale'] = (1 + 0.2 * rng.randn(n)).astype(np.float32)
        bn['bias'] = (0.1 * rng.randn(n)).astype(np.float32)
        stats[f'BatchNorm_{i}'] = dict(
            mean=(0.1 * rng.randn(n)).astype(np.float32),
            var=(0.5 + rng.rand(n)).astype(np.float32))
    return params, stats


def _port_models(params, stats, size=SIZE):
    enc_state, dec_state = interop.reconstruction_params_from_jax(params,
                                                                  stats)
    encoder = TR.Encoder(**DIMS, image_size=size)
    decoder = TR.Decoder(data.icosphere(2)[0], dim_in=DIMS['dim_out'],
                         width=WIDTH)
    encoder.load_state_dict(enc_state)
    decoder.load_state_dict(dec_state)
    return encoder, decoder


def _images(n, size=SIZE, seed=1):
    return np.random.RandomState(seed).rand(n, 4, size, size) \
        .astype(np.float32)


def _rel(got, want):
    """Norm-relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# tables and numpy code: equal exactly
# ---------------------------------------------------------------------------

def test_tables_equal():
    assert TR.CLASS_IDS_MAP == JTR.CLASS_IDS_MAP
    assert TR.SYNTHETIC_CLASSES == JTR.SYNTHETIC_CLASSES
    assert TR.SYNTHETIC_CLASSES_13 == JTR.SYNTHETIC_CLASSES_13
    assert TR.DISTS_WITH_DEFAULT_SCALE == JTR.DISTS_WITH_DEFAULT_SCALE
    assert TR.TCONORMS_WITH_DEFAULT_SCALE == JTR.TCONORMS_WITH_DEFAULT_SCALE
    np.testing.assert_array_equal(TR.DEFAULT_LOG_SCALES,
                                  JTR.DEFAULT_LOG_SCALES)
    assert TR.DEFAULT_LOG_SCALES.dtype == JTR.DEFAULT_LOG_SCALES.dtype


@pytest.mark.parametrize('dist', JTR.DISTS_WITH_DEFAULT_SCALE)
@pytest.mark.parametrize('tcn', JTR.TCONORMS_WITH_DEFAULT_SCALE)
def test_default_dist_scale_equal(dist, tcn):
    squared = dist.endswith('_squares')
    name = dist[:-len('_squares')] if squared else dist
    t_conorm, p = tcn.rsplit('_', 1)
    assert TR.default_dist_scale(name, squared, t_conorm, float(p)) \
        == JTR.default_dist_scale(name, squared, t_conorm, float(p))


def test_default_dist_scale_outside_the_table_raises():
    with pytest.raises(ValueError):
        TR.default_dist_scale('laplace', False, 'probabilistic', 0.0)
    with pytest.raises(ValueError):
        TR.default_dist_scale('uniform', False, 'frank', 2.0)


@pytest.mark.parametrize('family', ('synthetic',) + JTR.SYNTHETIC_CLASSES_13)
def test_synthetic_shape_equal(family):
    v = data.icosphere(2)[0]
    np.testing.assert_array_equal(v, jdata.icosphere(2)[0])
    rng_p, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        got = TR._synthetic_shape(rng_p, family, v)
        want = JTR._synthetic_shape(rng_j, family, v)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # the same draws, in the same order
    assert rng_p.randint(1 << 30) == rng_j.randint(1 << 30)


def _npz_tree(root):
    d = root / 'mesh_reconstruction'
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    class_ids = ['02691156', '03001627']
    for i, cid in enumerate(class_ids):
        n = 3 + i
        images = (rng.rand(n, 24, 4, 64, 64) * 255).astype(np.uint8)
        voxels = (rng.rand(n, 32, 32, 32) > 0.5).astype(np.uint8)
        np.savez(str(d / f'{cid}_train_images.npz'), images)
        np.savez(str(d / f'{cid}_train_voxels.npz'), voxels)
    return class_ids


def test_shapenet_npz_loader_matches_jax(tmp_path):
    """The npz loader (never run by --synthetic) on a tree the test writes:
    the same arrays, batches, ids, eyes and evaluation batches as the JAX
    script's for one seed."""
    class_ids = _npz_tree(tmp_path)
    got = TR.ShapeNet(str(tmp_path), class_ids, 'train')
    want = JTR.ShapeNet(str(tmp_path), class_ids, 'train')
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.voxels, want.voxels)
    assert (got.num_data, got.pos) == (want.num_data, want.pos)
    assert list(got.class_ids_pair) == list(want.class_ids_pair)
    rng_p, rng_j = np.random.RandomState(1), np.random.RandomState(1)
    for get in ('get_random_batch', 'get_random_batch_ids'):
        for g, w in zip(getattr(got, get)(rng_p, 8),
                        getattr(want, get)(rng_j, 8)):
            assert g.dtype == w.dtype and g.shape == w.shape
            # eyes through each package's get_points_from_angles
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(getattr(got, get)(rng_p, 8)[0],
                                      getattr(want, get)(rng_j, 8)[0])
    batches = zip(got.get_all_batches_for_evaluation(16, class_ids[1]),
                  want.get_all_batches_for_evaluation(16, class_ids[1]))
    n = 0
    for (gi, gv), (wi, wv) in batches:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
        n += gi.shape[0]
    assert n == 4 * 24


# ---------------------------------------------------------------------------
# the synthetic dataset, rendered by each package
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_dataset():
    return JTR.SyntheticShapeNet(1, SIZE, 0, class_ids=('syn_box',))


@pytest.fixture(scope='module')
def port_dataset():
    return TR.SyntheticShapeNet(1, SIZE, 0, class_ids=('syn_box',),
                                device='cpu')


def test_synthetic_dataset_matches_jax(jax_dataset, port_dataset):
    """Voxels equal; silhouettes (hard CDF x hard alpha, 24 views) equal on
    at least 99 % of pixels: a pixel centre on a face edge is a tie the
    two libraries' camera transforms may break apart (ROADMAP Queue 3)."""
    got, want = port_dataset, jax_dataset
    assert got.images.shape == want.images.shape == (24, 4, SIZE, SIZE)
    assert got.images.dtype == np.uint8
    np.testing.assert_array_equal(got.voxels, want.voxels)
    assert 0.05 < float(got.voxels.mean()) < 0.95
    assert float((got.images == want.images).mean()) >= 0.99
    alpha = got.images[:, 3] / 255.
    assert 0.05 < float(alpha.mean()) < 0.95
    np.testing.assert_array_equal(got.images[:, 0], got.images[:, 3])


def test_synthetic_batch_stream_matches_jax(jax_dataset, port_dataset):
    """The batch stream of a seed: the JAX run's ids and eyes."""
    rng_p, rng_j = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        got = port_dataset.get_random_batch_ids(rng_p, 16)
        want = jax_dataset.get_random_batch_ids(rng_j, 16)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-6)
        np.testing.assert_allclose(got[3], want[3], atol=1e-6)


# ---------------------------------------------------------------------------
# Encoder and Decoder on converted weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('size', [16, 32])
@pytest.mark.parametrize('train', [True, False])
def test_encoder_matches_flax(size, train):
    """Features to rtol 1e-4 (atol 1e-5); after a train-mode call the
    running statistics follow flax's rule, the biased batch variance, to
    rtol 1e-5, where torch.nn.BatchNorm2d's unbiased one misses it."""
    params, stats = _flax_weights(size)
    encoder_j, _ = _flax_models()
    encoder, _ = _port_models(params, stats, size)
    x = _images(BATCH, size)
    variables = {'params': params['enc'], 'batch_stats': stats}
    if train:
        want, mut = encoder_j.apply(variables, jnp.asarray(x), train=True,
                                    mutable=['batch_stats'])
    else:
        want = encoder_j.apply(variables, jnp.asarray(x), train=False)
    encoder.train(train)
    with torch.no_grad():
        got = encoder(torch.from_numpy(x))
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    if not train:
        return
    for i, bn in enumerate(encoder.bns):
        new = mut['batch_stats'][f'BatchNorm_{i}']
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new['mean']), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new['var']), rtol=1e-5)
    # the last BatchNorm normalises n = B * (size / 8)^2 values a channel;
    # the unbiased rule moves its running variance by 0.1 * var * n / (n-1)
    # instead, which the tolerance above tells apart
    n = BATCH * (size // 8) ** 2
    old = stats['BatchNorm_2']['var']
    batch_var = (np.asarray(mut['batch_stats']['BatchNorm_2']['var'])
                 - 0.9 * old) / 0.1
    unbiased = 0.9 * old + 0.1 * batch_var * n / (n - 1)
    assert not np.allclose(encoder.bns[2].running_var.numpy(), unbiased,
                           rtol=1e-5)


def test_decoder_matches_flax():
    """Vertices to atol 1e-6; gradients of a loss on them to every decoder
    parameter norm-relative within 1e-5."""
    params, stats = _flax_weights()
    _, decoder_j = _flax_models()
    _, decoder = _port_models(params, stats)
    feats = np.random.RandomState(2).randn(BATCH, DIMS['dim_out']) \
        .astype(np.float32)
    base = jnp.asarray(jdata.icosphere(2)[0])

    def loss_j(p):
        verts = decoder_j.apply({'params': p}, jnp.asarray(feats), base)
        return (verts ** 2).sum(), verts

    (_, want), grads = jax.value_and_grad(loss_j, has_aux=True)(
        params['dec'])
    got = decoder(torch.from_numpy(feats))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    _, gstate = interop.reconstruction_params_from_jax(
        dict(enc=params['enc'], dec=jax.tree_util.tree_map(np.asarray,
                                                           grads)), stats)
    for name, p in decoder.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        assert _rel(p.grad.numpy(), gstate[name].numpy()) < 1e-5, name


def test_decoder_template_zero_coordinates():
    """The icosphere's coordinates that are exactly 0 have the logit -inf:
    their vertex coordinate is the centroid's alone, finite, and their
    displacement rows get a zero gradient, with no NaN anywhere."""
    v = data.icosphere(2)[0]
    zero = v == 0
    assert zero.any()
    decoder = TR.Decoder(v, dim_in=DIMS['dim_out'], width=WIDTH)
    assert bool(torch.isinf(decoder.logits[torch.from_numpy(zero)]).all())
    feats = torch.randn(BATCH, DIMS['dim_out'], generator=torch.Generator()
                        .manual_seed(0), requires_grad=True)
    verts = decoder(feats)
    assert bool(torch.isfinite(verts).all())
    centroid = torch.tanh(decoder.fc_centroid(torch.relu(decoder.fc2(
        torch.relu(decoder.fc1(feats))))) * 0.1)
    for b in range(BATCH):
        rows, axes = np.nonzero(zero)
        np.testing.assert_allclose(
            verts[b].detach().numpy()[rows, axes],
            0.5 * centroid[b].detach().numpy()[axes], atol=1e-7)
    verts.sum().backward()
    for name, p in decoder.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
    assert bool(torch.isfinite(feats.grad).all())
    rows = torch.from_numpy(zero.reshape(-1))
    assert float(decoder.fc_displace.weight.grad[rows].abs().max()) == 0.0
    assert float(decoder.fc_displace.weight.grad[~rows].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# the step: 2-view loss, gradient, Adam; the voxel evaluation
# ---------------------------------------------------------------------------

def _args(*extra):
    return TR.parse_args(['--image_size', str(SIZE), '--batch_size',
                          str(BATCH), '--device', 'cpu', *extra])


def _port_experiment(params, stats):
    encoder, decoder = _port_models(params, stats)
    return TR.Reconstruction(_args(), encoder, decoder,
                             data.icosphere(2)[1], 'cpu')


@pytest.fixture(scope='module')
def jax_step(jax_dataset):
    """The JAX script's loss (experiments/train_reconstruction.py:582-603,
    a closure of its main(), rebuilt here from its Encoder, Decoder,
    gendr_tpu.GenDR and iou_loss) on a batch of the JAX synthetic
    dataset, its value and gradient, and Adam's first two steps."""
    params, stats = _flax_weights()
    encoder, decoder = _flax_models()
    v, f = jdata.icosphere(2)
    vertices_base = jnp.asarray(v)
    faces_t = jnp.asarray(f)
    laplacian = gendr_tpu.LaplacianLoss(v, f)
    flatten = gendr_tpu.FlattenLoss(f)
    lighting = gendr_tpu.Lighting()
    transform = gendr_tpu.LookAt(viewing_angle=15)
    renderer = gendr_tpu.GenDR(
        image_size=SIZE, dist_func='uniform', dist_scale=1.0,
        dist_squared=False, dist_shape=0, dist_shift=0, dist_eps=300.,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0,
        aggr_rgb_func='hard', backend='xla', channels='alpha')

    def loss_fn(params, images_a, images_b, eyes_a, eyes_b):
        images = jnp.concatenate([images_a, images_b], 0)
        feats, mut = encoder.apply(
            {'params': params['enc'], 'batch_stats': stats}, images,
            train=True, mutable=['batch_stats'])
        vertices = decoder.apply({'params': params['dec']}, feats,
                                 vertices_base)
        lap = jnp.mean(laplacian(vertices))
        flat = jnp.mean(flatten(vertices))
        vertices2 = jnp.concatenate([vertices, vertices], 0)
        eyes = jnp.concatenate([eyes_a, eyes_a, eyes_b, eyes_b], 0)
        B2 = vertices2.shape[0]
        mesh = gendr_tpu.Mesh.create(vertices2,
                                     jnp.tile(faces_t[None], (B2, 1, 1)))
        transform.set_eyes(eyes)
        renderer.dist_scale = TAU
        sils = renderer(transform(lighting(mesh)))[:, 3]
        raa, rba, rab, rbb = jnp.split(sils, 4)
        ta, tb = images_a[:, 3], images_b[:, 3]
        sil = (jiou_loss(raa, ta) + jiou_loss(rba, ta) + jiou_loss(rab, tb)
               + jiou_loss(rbb, tb)) / 4
        return sil + 5e-3 * lap + 5e-4 * flat, mut['batch_stats']

    batch = jax_dataset.get_random_batch(np.random.RandomState(5), BATCH)
    (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, *map(jnp.asarray, batch))
    opt = optax.adam(LR)
    state = opt.init(params)
    steps = []
    p = params
    for lr_scale in (1.0, 0.3):
        updates, state = opt.update(grads, state)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        p = optax.apply_updates(p, updates)
        steps.append(jax.tree_util.tree_map(np.asarray, p))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(params=params, stats=stats, batch=batch, loss=float(loss),
                new_stats=as_np(new_stats), grads=as_np(grads), steps=steps)


def test_loss_and_gradient_match_jax(jax_step):
    """The 2-view loss to rtol 1e-4; its gradient to each parameter
    norm-relative within 1e-3 and to all of them within 3e-4; BatchNorm's
    running statistics after the step to rtol 1e-5."""
    exp = _port_experiment(jax_step['params'], jax_step['stats'])
    ia, ib, ea, eb = (torch.tensor(x) for x in jax_step['batch'])
    loss = exp.loss_fn(ia, ib, ea, eb, TAU)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jax_step['loss'],
                               rtol=1e-4)
    genc, gdec = interop.reconstruction_params_from_jax(
        jax_step['grads'], jax_step['stats'])
    got, want = [], []
    scale = max(float(g.abs().max()) for g in [*genc.values(),
                                                 *gdec.values()])
    for module, gstate in ((exp.encoder, genc), (exp.decoder, gdec)):
        for name, p in module.named_parameters():
            g, w = p.grad.numpy(), gstate[name].numpy()
            if name.startswith('convs.') and name.endswith('.bias'):
                # a BatchNorm follows: the exact gradient is 0, and both
                # sides hold rounding noise far below the gradient's scale
                assert max(np.abs(g).max(), np.abs(w).max()) < 1e-5 * scale
                continue
            assert float(np.abs(w).max()) > 0, name
            assert _rel(g, w) < 1e-3, name
            got.append(g.reshape(-1))
            want.append(w.reshape(-1))
    assert _rel(np.concatenate(got), np.concatenate(want)) < 3e-4
    for i, bn in enumerate(exp.encoder.bns):
        new = jax_step['new_stats'][f'BatchNorm_{i}']
        np.testing.assert_allclose(bn.running_mean.numpy(), new['mean'],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(), new['var'],
                                   rtol=1e-5)


def test_adam_steps_match_optax(jax_step):
    """torch.optim.Adam at lr x lr_scale is optax.adam(lr) with its updates
    times lr_scale: two steps on the JAX gradient (lr_scale 1, then 0.3,
    the decay) give the JAX parameters to atol 1e-7."""
    exp = _port_experiment(jax_step['params'], jax_step['stats'])
    opt = torch.optim.Adam(exp.parameters(), lr=LR)
    genc, gdec = interop.reconstruction_params_from_jax(
        jax_step['grads'], jax_step['stats'])
    for lr_scale, want in zip((1.0, 0.3), jax_step['steps']):
        for group in opt.param_groups:
            group['lr'] = LR * lr_scale
        for module, gstate in ((exp.encoder, genc), (exp.decoder, gdec)):
            for name, p in module.named_parameters():
                p.grad = gstate[name].clone()
        opt.step()
        wenc, wdec = interop.reconstruction_params_from_jax(
            want, jax_step['stats'])
        for module, wstate in ((exp.encoder, wenc), (exp.decoder, wdec)):
            for name, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           wstate[name].numpy(), atol=1e-7,
                                           rtol=1e-6, err_msg=name)


def test_train_step_matches_jax(jax_step):
    """The port's train_step (loss, backward, Adam at lr) on the JAX batch:
    the loss to rtol 1e-4, every gradient finite, and the parameters after
    it norm-relative within 1e-5 of the JAX step's (Adam's first step
    moves each entry by about lr; entries whose gradient is near 0 may
    move apart)."""
    exp = _port_experiment(jax_step['params'], jax_step['stats'])
    opt = torch.optim.Adam(exp.parameters(), lr=LR)
    loss, finite = exp.train_step(opt, *(torch.tensor(x) for x in
                                         jax_step['batch']), TAU)
    assert bool(finite)
    np.testing.assert_allclose(float(loss), jax_step['loss'], rtol=1e-4)
    wenc, wdec = interop.reconstruction_params_from_jax(
        jax_step['steps'][0], jax_step['stats'])
    _assert_params_close({**_prefixed('encoder', exp.encoder.state_dict()),
                          **_prefixed('decoder', exp.decoder.state_dict())},
                         {**_prefixed('encoder', wenc),
                          **_prefixed('decoder', wdec)}, steps=1)


def _prefixed(prefix, state):
    return {f'{prefix}.{k}': v for k, v in state.items()}


def _assert_params_close(got, want, steps):
    """Parameters norm-relative within 1e-5, each tensor; a convolution's
    bias feeds a BatchNorm, so its exact gradient is 0 and Adam steps on
    rounding noise: there only |entry| <= lr per step on both sides."""
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if 'running' in name:
            continue
        if name.startswith('encoder.convs.') and name.endswith('.bias'):
            assert max(np.abs(g).max(), np.abs(w).max()) \
                <= LR * steps * 1.001, name
        else:
            assert _rel(g, w) < 1e-5, name


def test_predict_voxels_matches_jax(jax_step, jax_dataset):
    """The evaluation's voxels (eval-mode encoder, decoder, face vertices,
    voxelization at 32^3, transposed and flipped; the JAX script's
    predict_voxels, rebuilt here) equal on 99.9 % of cells, and each
    sample's IoU against the ground truth within 1e-2."""
    params, stats = jax_step['params'], jax_step['stats']
    encoder, decoder = _flax_models()
    v, f = jdata.icosphere(2)
    im, vx = next(jax_dataset.get_all_batches_for_evaluation(4, 'syn_box'))
    feats = encoder.apply({'params': params['enc'], 'batch_stats': stats},
                          jnp.asarray(im), train=False)
    verts = decoder.apply({'params': params['dec']}, feats, jnp.asarray(v))
    fv = jcore.face_vertices(verts, jnp.tile(jnp.asarray(f)[None],
                                             (im.shape[0], 1, 1)))
    want = np.asarray(jnp.transpose(jvoxelize.voxelization(
        fv * 1.0 * (32. - 1) / 32. + 0.5, 32, False),
        (0, 2, 1, 3))[:, :, :, ::-1])
    exp = _port_experiment(params, stats)
    got = exp.predict_voxels(torch.from_numpy(im)).numpy()
    assert got.shape == want.shape == (4, 32, 32, 32)
    assert 0.001 < float(want.mean()) < 0.5
    assert float((got == want).mean()) >= 0.999

    def iou(pred):
        return (vx * pred).sum((1, 2, 3)) / np.maximum(
            ((vx + pred) > 0).sum((1, 2, 3)), 1)
    np.testing.assert_allclose(iou(got), iou(want), atol=1e-2)
