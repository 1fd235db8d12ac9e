"""The reconstruction loss of ``experiments/train_reconstruction.py``
through both of ``gendr_tpu``'s render backends, on the CPU.

The JAX script renders with ``backend='pallas'`` where
``jax.devices()[0].platform == 'tpu'`` and with ``'xla'`` elsewhere
(``experiments/train_reconstruction.py:505-506``); the port's parity
tests hold it against the ``xla`` backend alone.  Here the script's
``loss_fn`` (``:582-603``) at its published width, rebuilt from its
Encoder, Decoder, ``gendr_tpu.GenDR`` and ``iou_loss``, goes through both
backends on the same batch (``pallas`` in interpret mode, as
``tests/test_pallas.py`` runs it): the loss, and its gradient to the
decoder's vertices, norm-relative.  Uniform CDF at tau 10^-1.5,
probabilistic alpha, alpha only, the 642-vertex template, the synthetic
dataset of the 13 classes at 64x64 (one object a class: the dataset's
size sets no shape of the step).

Tolerances, tests/test_torch_reconstruction.py's for the port against
``xla``: the loss within 1e-4 relative, the vertex gradient within 3e-4
norm-relative.  The tier-1 test runs a batch of 1 (4 silhouettes); the
published batch of 64 (256 silhouettes) runs as a script:

    JAX_PLATFORMS=cpu python tests/test_torch_recon_backends.py --batch 64
"""

import argparse
import os
import sys
import time

import numpy as np

if __name__ == '__main__':
    os.environ['JAX_PLATFORMS'] = 'cpu'
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')

import gendr_tpu  # noqa: E402
from experiments import train_reconstruction as JTR  # noqa: E402
from experiments.common import iou_loss  # noqa: E402
from gendr_tpu import data  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

IMAGE_SIZE = 64
TAU = 10 ** -1.5
LOSS_RTOL, GRAD_REL = 1e-4, 3e-4


def step_inputs(batch, seed=0, objects=1):
    """(vertices [2 batch, 642, 3], images_a, images_b, eyes_a, eyes_b):
    the script's model at its published width, initialised as main()
    does from PRNGKey(seed), run in training mode on a batch drawn from
    the 13-class synthetic dataset with RandomState(seed)."""
    dataset = JTR.SyntheticShapeNet(objects, IMAGE_SIZE, seed,
                                    class_ids=JTR.SYNTHETIC_CLASSES_13)
    ia, ib, ea, eb = dataset.get_random_batch(np.random.RandomState(seed),
                                              batch)
    v, _ = data.sphere(642)
    encoder, decoder = JTR.Encoder(), JTR.Decoder(nv=v.shape[0])
    rng = jax.random.PRNGKey(seed)
    enc = encoder.init(rng, jnp.zeros((1, 4, IMAGE_SIZE, IMAGE_SIZE)),
                       train=False)
    dec = decoder.init(rng, jnp.zeros((1, 512)), jnp.asarray(v))
    feats, _ = encoder.apply(enc, jnp.asarray(np.concatenate([ia, ib])),
                             train=True, mutable=['batch_stats'])
    vertices = decoder.apply(dec, feats, jnp.asarray(v))
    return np.asarray(vertices), ia, ib, ea, eb


def loss_and_grad(backend):
    """The script's loss_fn from the decoder's vertices on: Laplacian and
    flatten terms, the four silhouettes [Raa, Rba, Rab, Rbb] rendered by
    backend, their IoU losses; jitted value and vertex gradient."""
    v, f = data.sphere(642)
    faces = jnp.asarray(f)
    laplacian = gendr_tpu.LaplacianLoss(v, f)
    flatten = gendr_tpu.FlattenLoss(f)
    lighting = gendr_tpu.Lighting()
    transform = gendr_tpu.LookAt(viewing_angle=15)
    renderer = gendr_tpu.GenDR(
        image_size=IMAGE_SIZE, dist_func='uniform', dist_scale=TAU,
        dist_squared=False, dist_shape=0, dist_shift=0, dist_eps=300.,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0,
        aggr_rgb_func='hard', backend=backend, channels='alpha')

    def loss(vertices, images_a, images_b, eyes_a, eyes_b):
        lap = jnp.mean(laplacian(vertices))
        flat = jnp.mean(flatten(vertices))
        vertices2 = jnp.concatenate([vertices, vertices], 0)
        eyes = jnp.concatenate([eyes_a, eyes_a, eyes_b, eyes_b], 0)
        mesh = gendr_tpu.Mesh.create(
            vertices2, jnp.tile(faces[None], (vertices2.shape[0], 1, 1)))
        transform.set_eyes(eyes)
        sils = renderer(transform(lighting(mesh)))[:, 3]
        raa, rba, rab, rbb = jnp.split(sils, 4)
        ta, tb = images_a[:, 3], images_b[:, 3]
        sil = (iou_loss(raa, ta) + iou_loss(rba, ta) + iou_loss(rab, tb)
               + iou_loss(rbb, tb)) / 4
        return sil + 0.005 * lap + 0.0005 * flat
    return jax.jit(jax.value_and_grad(loss))


def compare(batch, seed=0):
    """{backend: (loss, vertex gradient, seconds)} and the two
    differences: the loss relative, the gradient norm-relative."""
    inputs = [jnp.asarray(x) for x in step_inputs(batch, seed)]
    out = {}
    for backend in ('xla', 'pallas'):
        t0 = time.perf_counter()
        loss, grad = loss_and_grad(backend)(*inputs)
        out[backend] = (float(loss), np.asarray(grad, np.float64),
                        time.perf_counter() - t0)
    (lx, gx, _), (lp, gp, _) = out['xla'], out['pallas']
    return out, abs(lp - lx) / abs(lx), \
        float(np.linalg.norm(gp - gx) / np.linalg.norm(gx))


def test_reconstruction_loss_pallas_matches_xla():
    out, loss_rel, grad_rel = compare(batch=1)
    assert np.isfinite(out['pallas'][1]).all()
    assert float(np.abs(out['xla'][1]).max()) > 0
    assert loss_rel < LOSS_RTOL, loss_rel
    assert grad_rel < GRAD_REL, grad_rel


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--batch', type=int, default=64)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    out, loss_rel, grad_rel = compare(args.batch, args.seed)
    for backend, (loss, grad, seconds) in out.items():
        print(f'{backend}: loss {loss!r}, vertex gradient norm '
              f'{np.linalg.norm(grad)!r}, {seconds:.1f} s (compile and run, '
              f'{jax.devices()[0].platform})')
    print(f'batch {args.batch} ({4 * args.batch} silhouettes at '
          f'{IMAGE_SIZE}x{IMAGE_SIZE}), seed {args.seed}: pallas against '
          f'xla, loss {loss_rel:.3g} relative (tolerance {LOSS_RTOL:g}), '
          f'vertex gradient {grad_rel:.3g} norm-relative (tolerance '
          f'{GRAD_REL:g})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
