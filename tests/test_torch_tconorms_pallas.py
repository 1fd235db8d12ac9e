"""The parametric t-conorm folds of the CUDA backend's plain versions
against gendr_tpu's Pallas kernels in interpret mode, as
tests/test_pallas.py runs them: a case per family, the three modes spread
over them.  The same folds against gendr_tpu's xla backend, the port's
torch backend and finite differences: tests/test_torch_tconorms.py, whose
tolerances hold here (image max-abs 1e-4; gradients through
tests/test_torch_backward.py's budgeted comparison).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu_torch import config as C, interop
from gendr_tpu_torch.raster import cuda_backend as CB
from tests.test_render import params_dict, random_scene
from tests.test_torch_backward import _assert_grads_match, _port_grads
from tests.test_torch_tconorms import MODES
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize('tcn,p,dist,mode', [
    ('hamacher', 0.5, 'uniform', 'alpha'), ('frank', 2.0, 'uniform', 'hard'),
    ('yager', 2.0, 'logistic', 'softmax'),
    ('aczel_alsina', 2.0, 'uniform', 'hard'),
    ('dombi', 2.0, 'logistic', 'alpha'),
    ('schweizer_sklar', -2.0, 'uniform', 'softmax')])
def test_parametric_fold_plain_matches_pallas_interpret(tcn, p, dist, mode):
    """Against the TPU kernels themselves (their 128-lane butterfly fold
    and aggregate-inverse backward), run in interpret mode as
    tests/test_pallas.py runs them (16x16, face_chunk 8, pixel_tile 64)."""
    rng = np.random.RandomState(2)
    fv = random_scene(rng, B=2, F=13).reshape(2, 13, 9)
    tex = rng.rand(2, 13, 1, 3).astype(np.float32)
    g = rng.randn(2, 4, 16, 16).astype(np.float32)
    kw = dict(image_size=16, dist_func=dist, aggr_alpha_func=tcn,
              aggr_rgb_func=MODES[mode]['rgb'], face_chunk=8,
              channels=MODES[mode].get('channels', 'rgba'))
    jp = params_dict(dist_scale=5e-2, aggr_alpha_t_conorm_p=p)
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64, **kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    soft, aggrs, aux = jax.jit(PB.forward_with_aux, static_argnums=2)(
        jfv, jtex, jcfg, jp)
    want = jax.jit(PB.backward_from_aux, static_argnums=6)(
        jfv, jtex, aux, soft, aggrs, jnp.asarray(g), jcfg, jp)
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    got, _ = CB.forward(torch.from_numpy(fv), torch.from_numpy(tex), cfg, tp)
    # winner ids are reported in different orders (Morton rank there, input
    # order here): the image is compared
    assert float(np.abs(got.numpy() - np.asarray(soft)).max()) <= 1e-4
    _assert_grads_match(_port_grads(CB, fv, tex, {**kw, 'backend': 'cuda'},
                                    tp, g), want)
