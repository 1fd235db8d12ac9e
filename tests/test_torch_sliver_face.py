"""A sliver face of the reconstruction run on the card, held against
gendr_tpu on the CPU.

``tests/data/recon_step2278_sliver.npz`` is one silhouette of step 2 278 of
``results/recon50k_torch.log``'s run (`recon50k.log`'s arguments, seed 0),
the step after which that run's loss jumped from 0.027 to 0.17 while the
same steps through ``backend='torch'`` did not: the batch element whose
faces' gradients differed most between the two backends, saved on an
NVIDIA H100 by ``python -m gendr_tpu_torch.tools.recon_steps --at 2278
--save ...`` (its face vertices after the camera, the silhouette its loss
compares with, tau, the face, and that face's gradient through the
kernels and through ``backend='torch'`` on the card).  Two of the face's
vertices lie 3.5e-4 apart (in x, y after the camera: a hundredth of a
pixel at 64x64), and its gradient is five orders of magnitude above every
other face's.

The kernels' plain versions and the card's kernels give gendr_tpu's xla
gradient there to float32 rounding, so the jump is the reference's own
arithmetic.  ``backend='torch'`` folds a pixel's coverage in another
order (ROADMAP Queue 3, "Fold order"): at the pixel that carries the
face's gradient, 1 - alpha is 1.07e-6, one ulp of alpha is 5.6 % of it,
and the aggregate-inverse rule divides by it, so that backend's gradient
there is held only to 10 %.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gendr_tpu.raster.render import render as jrender
from gendr_tpu_torch.raster.render import render
from torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), 'data',
                    'recon_step2278_sliver.npz')


def _kwargs(tau):
    # the reconstruction's renderer (uniform x probabilistic, alpha only)
    return dict(image_size=64, dist_func='uniform', dist_scale=tau,
                dist_eps=300., aggr_alpha_func='probabilistic',
                aggr_rgb_func='hard', double_side=False, face_chunk=128,
                channels='alpha')


def _loss(sil, target, weight):
    # the element's share of the loss: iou_loss, a mean over 4B elements
    inter = (sil * target).sum()
    return weight * (1 - inter / ((sil + target - sil * target).sum()
                                  + 1e-6))


def _port_grad(fv, tex, target, d, backend):
    x = torch.tensor(fv, requires_grad=True)
    img = render(x, torch.tensor(tex), backend=backend,
                 **_kwargs(float(d['tau'])))
    _loss(img[0, 3], torch.tensor(target), float(d['weight'])).backward()
    return x.grad[0].reshape(-1, 9).numpy()


def test_sliver_face_gradient_matches_gendr_tpu():
    d = np.load(DATA)
    f = int(d['face'])
    fv = d['face_vertices'].reshape(1, -1, 3, 3)
    tex = np.ones((1, fv.shape[1], 1, 3), np.float32)
    target = d['target']

    def loss(v):
        img = jrender(v, jnp.asarray(tex), backend='xla',
                      **_kwargs(float(d['tau'])))
        return _loss(img[0, 3], jnp.asarray(target), float(d['weight']))
    want = np.asarray(jax.grad(loss)(jnp.asarray(fv)))[0].reshape(-1, 9)
    kernels = _port_grad(fv, tex, target, d, 'cuda')  # the plain versions
    plain = _port_grad(fv, tex, target, d, 'torch')

    # the face dominates the element's gradient in gendr_tpu itself
    others = np.delete(np.abs(want).max(1), f)
    assert np.abs(want[f]).max() > 1e5 * others.max()
    # the kernels, on the card and through their plain versions here,
    # give gendr_tpu's gradient to float32 rounding
    np.testing.assert_allclose(kernels[f], want[f], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d['kernels'], want[f], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(kernels, want, rtol=1e-3, atol=1e-6)
    # backend='torch' on the card and here agree; against gendr_tpu it is
    # within an ulp of alpha at 1 - 1.07e-6
    np.testing.assert_allclose(d['plain'], plain[f], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(plain[f], want[f], rtol=0.1)
