"""The port's sharded render (``gendr_tpu_torch.parallel.sharding``) against
its unsharded render and against ``gendr_tpu.parallel.sharding`` on the JAX
8-device CPU mesh (tests/conftest.py), at tests/test_sharding.py's shapes.

The port's side runs in gloo ranks on the CPU, spawned once per world size
(8, then 4) with every case of that size in one spawn
(tests/torch_ranks.py); each rank passes its dp shard and saves what it
got.  Both port backends run: 'torch' and 'cuda' (on CPU tensors the
kernels' plain versions, K1e and K2e).  The JAX side uses its 'xla'
backend.

Tolerances: against the port's own unsharded render, tests/
test_sharding.py's (images atol 2e-5, rtol 1e-4; gradients atol 2e-5,
rtol 1e-3).  Against gendr_tpu, the cross-library ones of
tests/test_torch_raster.py (image 1e-4 with 1 % of the pixels beyond it:
gaussian's erfc is an A&S approximation in gendr_tpu, and a pair within an
ulp of an edge or of the 1e-6 cull flips) and tests/test_torch_backward.py
(gradients atol 2e-4, rtol 2e-3 with a 2 % budget).  Every rank of a dp
shard must return the bitwise same image and gradient.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from gendr_tpu import config as JC
from gendr_tpu import data as jdata
from gendr_tpu.geometry import core as JG, transforms as JT
from gendr_tpu.parallel import sharding as JS
from gendr_tpu_torch import config as C, interop
from gendr_tpu_torch.raster.render import _Render
from tests import torch_ranks
from tests.test_pallas import _assert_mostly_close
from tests.test_render import params_dict, random_scene
from tests.test_torch_backward import GRAD_TOL as JAX_GRAD_TOL
from tests.test_torch_raster import IMG_ATOL
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


def _scene(B, F, seed, size, rgb, dist, tcn='probabilistic', p=0.0,
           scale=3e-2, bg=(0.2, 0.1, 0.4)):
    rng = np.random.RandomState(seed)
    fv = random_scene(rng, B=B, F=F).reshape(B, F, 9)
    tex = rng.rand(B, F, 1, 3).astype(np.float32)
    kw = dict(image_size=size, dist_func=dist, aggr_alpha_func=tcn,
              aggr_rgb_func=rgb, face_chunk=4)
    jp = params_dict(dist_scale=scale, aggr_alpha_t_conorm_p=p,
                     background_color=np.array(bg, np.float32))
    return dict(fv=fv, tex=tex, cfg=kw, jp=jp)


# tests/test_sharding.py's scenes
FWD = functools.partial(_scene, 4, 37, 0, 16, dist='uniform')
REPL = functools.partial(_scene, 4, 37, 3, 16, 'hard', 'logistic')
GRAD = functools.partial(_scene, 4, 21, 1, 12, dist='logistic', scale=5e-2,
                         bg=(0.0, 0.0, 0.0))
EXOTIC = functools.partial(_scene, 2, 19, 7, 16, 'softmax', 'gaussian',
                           scale=4e-2, bg=(0.0, 0.0, 0.0))
PIXEL = functools.partial(_scene, 2, 17, 3, 16, dist='uniform')

# name -> (kind, axes, scene, backend, sp_axis)
WORLD8 = {
    'fwd dp2xfp4 hard torch': ('forward', {'dp': 2, 'fp': 4},
                               FWD('hard'), 'torch', None),
    'fwd dp2xfp4 hard cuda': ('forward', {'dp': 2, 'fp': 4}, FWD('hard'),
                              'cuda', None),
    'fwd dp2xfp4 softmax torch': ('forward', {'dp': 2, 'fp': 4},
                                  FWD('softmax'), 'torch', None),
    'repl dp2xfp4 logistic torch': ('forward', {'dp': 2, 'fp': 4}, REPL(),
                                    'torch', None),
    'pix dp2xfp2xsp2 hard torch': ('grad', {'dp': 2, 'fp': 2, 'sp': 2},
                                   PIXEL('hard'), 'torch', 'sp'),
    'pix dp2xfp2xsp2 hard cuda': ('grad', {'dp': 2, 'fp': 2, 'sp': 2},
                                  PIXEL('hard'), 'cuda', 'sp'),
    'pix dp2xfp2xsp2 softmax cuda': ('grad', {'dp': 2, 'fp': 2, 'sp': 2},
                                     PIXEL('softmax'), 'cuda', 'sp'),
}
WORLD4 = {
    'fwd dp2xfp2 hard torch': ('forward', {'dp': 2, 'fp': 2}, FWD('hard'),
                               'torch', None),
    'fwd dp2xfp2 softmax cuda': ('forward', {'dp': 2, 'fp': 2},
                                 FWD('softmax'), 'cuda', None),
    'grad dp2xfp2 hard torch': ('grad', {'dp': 2, 'fp': 2}, GRAD('hard'),
                                'torch', None),
    'grad dp2xfp2 softmax torch': ('grad', {'dp': 2, 'fp': 2},
                                   GRAD('softmax'), 'torch', None),
    'grad dp2xfp2 hard cuda': ('grad', {'dp': 2, 'fp': 2}, GRAD('hard'),
                               'cuda', None),
    'grad dp2xfp2 softmax cuda': ('grad', {'dp': 2, 'fp': 2},
                                  GRAD('softmax'), 'cuda', None),
    'max dp2xfp2 torch': ('forward', {'dp': 2, 'fp': 2}, EXOTIC(tcn='max'),
                          'torch', None),
    'max dp2xfp2 cuda': ('forward', {'dp': 2, 'fp': 2}, EXOTIC(tcn='max'),
                         'cuda', None),
    'yager dp2xfp2 torch': ('forward', {'dp': 2, 'fp': 2},
                            EXOTIC(tcn='yager', p=2.0), 'torch', None),
    'yager dp2xfp2 cuda': ('forward', {'dp': 2, 'fp': 2},
                           EXOTIC(tcn='yager', p=2.0), 'cuda', None),
    # winner ids across four face shards, and shards that are all padding
    'ids fp4 torch': ('aggrs', {'dp': 1, 'fp': 4},
                      _scene(2, 21, 5, 16, 'hard', 'uniform'), 'torch', None),
    'ids fp4 cuda': ('aggrs', {'dp': 1, 'fp': 4},
                     _scene(2, 21, 5, 16, 'hard', 'uniform'), 'cuda', None),
    'empty fp4 torch': ('grad', {'dp': 1, 'fp': 4},
                        _scene(2, 3, 6, 16, 'hard', 'uniform'), 'torch',
                        None),
    'empty fp4 cuda': ('grad', {'dp': 1, 'fp': 4},
                       _scene(2, 3, 6, 16, 'hard', 'uniform'), 'cuda', None),
}
CASES = {**WORLD8, **WORLD4}


def _rank_case(kind, axes, scene, backend, sp_axis):
    params = interop.params_from_jax({k: np.asarray(v)
                                      for k, v in scene['jp'].items()})
    return dict(kind=kind, axes=axes, cfg=scene['cfg'], params=params,
                fv=scene['fv'], tex=scene['tex'], backend=backend,
                sp_axis=sp_axis)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """{case or 'dryrun n': [rank] -> result} from one spawn per world."""
    out = {}
    for world, cases in ((8, WORLD8), (4, WORLD4)):
        todo = [(name, _rank_case(*c)) for name, c in cases.items()]
        todo.append((f'dryrun {world}', dict(kind='dryrun', n=world)))
        res = torch_ranks.spawn(
            world, todo, str(tmp_path_factory.mktemp(f'world{world}')))
        for name, _ in todo:
            out[name] = [r[name] for r in res]
    return out


def _by_dp(results, key):
    """The full batch of ``key`` from the ranks of fp = sp = 0, in dp
    order, after checking that every rank of a dp shard holds it bitwise."""
    shards = {}
    for r in results:
        d = r['coord'].get('dp', 0)
        if d in shards:
            np.testing.assert_array_equal(r[key], shards[d], err_msg=key)
        else:
            shards[d] = r[key]
    return np.concatenate([shards[d] for d in sorted(shards)])


def _loss(img):
    return (img[:, 3] ** 2).sum() + (img[:, :3] * 0.3).sum()


def _port_unsharded(name):
    """(image, grad_fv, grad_tex) of the port's unsharded render, the
    case's backend, loss as tests/test_sharding.py's."""
    _, _, scene, backend, _ = CASES[name]
    cfg = C.RenderConfig.create(backend=backend, **scene['cfg'])
    params = interop.params_from_jax({k: np.asarray(v)
                                      for k, v in scene['jp'].items()})
    fv = torch.tensor(scene['fv'], requires_grad=True)
    tex = torch.tensor(scene['tex'], requires_grad=True)
    img = _Render.apply(fv, tex, cfg, params)
    _loss(img).backward()
    return img.detach().numpy(), fv.grad.numpy(), tex.grad.numpy()


J_RS = jax.jit(JS.render_sharded, static_argnums=(2, 4),
               static_argnames=('dp_axis', 'fp_axis', 'sp_axis', 'backend'))


@functools.lru_cache(maxsize=None)
def _jax_mesh(axes):
    return JS.make_mesh(dict(axes))


def _jax_sharded(name, grads):
    """gendr_tpu.parallel.sharding's image (and gradients) on the same
    mesh, 'xla' backend."""
    _, axes, scene, _, sp_axis = CASES[name]
    mesh = _jax_mesh(tuple(axes.items()))
    cfg = JC.RenderConfig.create(backend='xla', **scene['cfg'])
    fv, tex, jp = jnp.asarray(scene['fv']), jnp.asarray(scene['tex']), \
        scene['jp']
    if not grads:
        return np.asarray(J_RS(fv, tex, cfg, jp, mesh, sp_axis=sp_axis))
    render_fn = JS.make_sharded_render(cfg, mesh, sp_axis=sp_axis)

    def loss(a, b):
        return _loss(render_fn(a, b, jp))
    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss, argnums=(0, 1)))(fv, tex)]


FORWARD_CASES = [n for n, c in CASES.items() if c[0] in ('forward', 'grad')]
GRAD_CASES = [n for n, c in CASES.items() if c[0] == 'grad']


@pytest.mark.parametrize('name', FORWARD_CASES)
def test_sharded_forward_matches(ranks, name):
    """The image on every rank of a dp shard is bitwise the same (the fp
    carry merge and the sp band gather replicate it), and equals the port's
    unsharded render and gendr_tpu's sharded render."""
    got = _by_dp(ranks[name], 'image')
    want, _, _ = _port_unsharded(name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **IMG_TOL)
    err = np.abs(got - _jax_sharded(name, False)).max(axis=1)  # per pixel
    assert (err > IMG_ATOL).mean() <= 0.01, (err.max(),
                                             (err > IMG_ATOL).sum())


@pytest.mark.parametrize('name', GRAD_CASES)
def test_sharded_gradients_match(ranks, name):
    """The gradients to face_vertices and textures, summed over sp and
    gathered over fp, against the unsharded render's and gendr_tpu's
    make_sharded_render's."""
    got = [_by_dp(ranks[name], k) for k in ('grad_fv', 'grad_tex')]
    _, *want = _port_unsharded(name)
    assert np.abs(want[0]).max() > 100 * GRAD_TOL['atol']
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    for a, b in zip(got, _jax_sharded(name, True)):
        _assert_mostly_close(a, b, **JAX_GRAD_TOL)


@pytest.mark.parametrize('name', GRAD_CASES)
def test_collective_seconds_count_each_rank(ranks, name):
    """sharding.collective_seconds grows on every rank of a sharded
    forward + backward by the time its collectives took (the host clock on
    CPU tensors), and by no more than the rank's whole run."""
    for r in ranks[name]:
        assert 0.0 < r['collective_seconds'] < 300.0


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_sharded_winner_ids_equal_the_unsharded(ranks, backend):
    """Hard-RGB winner ids of four face shards are global input ids, equal
    to the unsharded render's (a tie keeps the earlier shard's face, as
    the unsharded fold keeps the earlier face)."""
    name = f'ids fp4 {backend}'
    got = _by_dp(ranks[name], 'aggrs')
    _, _, scene, _, _ = CASES[name]
    cfg = C.RenderConfig.create(backend=backend, **scene['cfg'])
    params = interop.params_from_jax({k: np.asarray(v)
                                      for k, v in scene['jp'].items()})
    from gendr_tpu_torch.raster import cuda_backend as CB, torch_backend as TB
    _, want = (CB if backend == 'cuda' else TB).forward(
        torch.tensor(scene['fv']), torch.tensor(scene['tex']), cfg, params)
    ids = got[:, 1]
    assert (ids >= 0).sum() > 50 and ids.max() >= 8  # several shards win
    np.testing.assert_array_equal(ids, want[:, 1].numpy())
    np.testing.assert_allclose(got[:, 0], want[:, 0].numpy(), rtol=1e-6)


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_all_padded_shards_are_harmless(ranks, backend):
    """Three faces over four face shards: shards 1-3 hold padding alone and
    fold the identity carry, no NaN; image and gradients equal the
    unsharded render's."""
    name = f'empty fp4 {backend}'
    img = _by_dp(ranks[name], 'image')
    assert np.isfinite(img).all()
    want, *grads = _port_unsharded(name)
    np.testing.assert_allclose(img, want, **IMG_TOL)
    for key, g in zip(('grad_fv', 'grad_tex'), grads):
        got = _by_dp(ranks[name], key)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, g, **GRAD_TOL)


def _jax_dryrun_loss(n):
    """__graft_entry__.dryrun_multichip's first-step loss, rebuilt from
    gendr_tpu.parallel.sharding and optax (the entry point returns
    nothing)."""
    sp = 2 if n % 8 == 0 else 1
    fp = 2 if n % 2 == 0 else 1
    dp = n // (fp * sp)
    mesh = JS.make_mesh({'dp': dp, 'fp': fp, 'sp': sp})
    v, f = jdata.icosphere(1)
    B = 2 * dp
    cfg = JC.RenderConfig.create(
        image_size=16, dist_func='uniform', aggr_alpha_func='probabilistic',
        aggr_rgb_func='hard', face_chunk=32, backend='xla')
    params_r = params_dict(dist_scale=3e-2, dist_eps=1e2)
    render_fn = JS.make_sharded_render(cfg, mesh, 'dp', 'fp',
                                       sp_axis='sp' if sp > 1 else None)
    base_v = jnp.asarray(v)[None] * 0.5
    faces = jnp.asarray(f)[None]
    eyes = jnp.asarray(np.stack([np.asarray(
        [2.0 * np.cos(a), 0.7, 2.0 * np.sin(a)]) for a in
        np.linspace(0, 2 * np.pi, B, endpoint=False)]).astype(np.float32))
    target = jnp.ones((B, 16, 16), jnp.float32) * 0.3

    def loss_fn(displace):
        verts = JT.perspective(JT.look_at(
            jnp.tile(base_v + displace, (B, 1, 1)), eyes), 30.0)
        fv = JG.face_vertices(verts, jnp.tile(faces, (B, 1, 1)))
        pred = render_fn(fv.reshape(B, -1, 9),
                         jnp.ones((B, f.shape[0], 1, 3), jnp.float32),
                         params_r)[:, 3]
        inter = jnp.sum(pred * target, axis=(1, 2))
        union = jnp.sum(pred + target - pred * target, axis=(1, 2)) + 1e-6
        return jnp.mean(1.0 - inter / union)

    opt = optax.adam(1e-2)
    displace = jnp.zeros((1, v.shape[0], 3), jnp.float32)
    loss, grad = jax.jit(jax.value_and_grad(loss_fn))(displace)
    updates, _ = opt.update(grad, opt.init(displace))
    assert np.isfinite(np.asarray(optax.apply_updates(displace,
                                                      updates))).all()
    return float(loss)


@pytest.mark.parametrize('n', [4, 8])
def test_dryrun_multichip(ranks, n):
    results = ranks[f'dryrun {n}']
    losses = {r['loss'] for r in results}
    assert len(losses) == 1  # every rank took the same step
    loss = losses.pop()
    assert np.isfinite(loss)
    assert abs(loss - _jax_dryrun_loss(n)) < 1e-4
    dp, fp, sp = results[0]['mesh']
    assert (dp * fp * sp, sp, fp) == (n, 2 if n == 8 else 1, 2)
    renders = results[0]['renders']
    assert len(renders) == 4 and all(np.isfinite(v)
                                     for v in renders.values())
    assert all(r['renders'] == renders for r in results)
