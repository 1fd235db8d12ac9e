"""Big surface textures (sub-kernels K1d/K2d: more than 36 texels per
face) against gendr_tpu on the CPU.

On CPU tensors ``backend='cuda'`` runs the kernels' plain versions; these
tests hold them and ``backend='torch'`` against ``gendr_tpu``'s ``xla``
backend at 49 and 256 texels per face, and against the Pallas kernels in
interpret mode at 49 (as tests/test_pallas.py runs them: 9 faces, 16x16,
face_chunk 8, pixel_tile 64), for softmax and hard RGB.

Tolerances, those of the JAX package's own big-texture tests: image
``atol 1e-4, rtol 1e-3``; geometry gradients ``atol 2e-4, rtol 2e-3``;
texture gradients ``atol 1e-5, rtol 1e-4``.  The softmax scenes use the
step CDF: a soft CDF's clipped tails sit exactly on the fold of the R x R
texel grid, where the last ulp of each library picks one of two texels
(ROADMAP.md Queue 3), and at R = 7 or 16 there are many fold lines; with
the step CDF the xy gradient is 0 and the z and texture chains are not.
Hard RGB samples only inside a face, off the tails, and takes a soft CDF.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gendr_tpu import config as JC
from gendr_tpu.raster import pallas_backend as PB
from gendr_tpu.raster import xla_backend as X
from gendr_tpu_torch import config as C, interop, render
from gendr_tpu_torch.raster import cuda_backend as CB
from gendr_tpu_torch.raster import pack
from gendr_tpu_torch.raster import torch_backend as TB
from tests.test_render import params_dict, random_scene
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = dict(atol=1e-4, rtol=1e-3)
GEOM_TOL = dict(atol=2e-4, rtol=2e-3)
TEX_TOL = dict(atol=1e-5, rtol=1e-4)

J_XF = jax.jit(X.forward, static_argnums=3)
J_XB = jax.jit(X.backward, static_argnums=6)
J_PFA = jax.jit(PB.forward_with_aux, static_argnums=2)
J_PBA = jax.jit(PB.backward_from_aux, static_argnums=6)

BACKENDS = {'torch': TB, 'cuda': CB}


def _scene(rgb, ts, seed=8):
    """(fv, tex, g, RenderConfig keywords, JAX params, port params): 9
    random faces at 16x16, face_chunk 8 (two chunks)."""
    rng = np.random.RandomState(seed)
    fv = random_scene(rng, B=1, F=9).reshape(1, 9, 9)
    tex = rng.rand(1, 9, ts, 3).astype(np.float32)
    g = rng.randn(1, 4, 16, 16).astype(np.float32)
    kw = dict(image_size=16,
              dist_func='hard' if rgb == 'softmax' else 'logistic',
              aggr_alpha_func='probabilistic', aggr_rgb_func=rgb,
              double_side=True, face_chunk=8)
    jp = params_dict(dist_scale=3e-2)
    tp = interop.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    return fv, tex, g, kw, jp, tp


def _port(backend, fv, tex, g, kw, tp):
    cfg = C.RenderConfig.create(backend=backend, **kw)
    mod = BACKENDS[backend]
    fvt, text = torch.from_numpy(fv), torch.from_numpy(tex)
    launches = dict(CB.LAUNCHES)
    soft, aggrs, aux = mod.forward_with_aux(fvt, text, cfg, tp)
    grads = mod.backward_from_aux(fvt, text, aux, soft, aggrs,
                                  torch.from_numpy(g), cfg, tp)
    assert CB.LAUNCHES == launches  # CPU tensors: never a kernel launch
    return soft.numpy(), [x.numpy() for x in grads]


def _assert_close(got_img, got_grads, want_img, want_grads):
    np.testing.assert_allclose(got_img, np.asarray(want_img), **IMG_TOL)
    np.testing.assert_allclose(got_grads[0], np.asarray(want_grads[0]),
                               **GEOM_TOL)
    np.testing.assert_allclose(got_grads[1], np.asarray(want_grads[1]),
                               **TEX_TOL)
    assert np.abs(got_grads[1]).max() > 100 * TEX_TOL['atol']


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
@pytest.mark.parametrize('ts', [49, 256])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_big_texture_matches_xla(rgb, ts, backend):
    fv, tex, g, kw, jp, tp = _scene(rgb, ts)
    jcfg = JC.RenderConfig.create(**kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    want, want_ag = J_XF(jfv, jtex, None, jcfg, jp)
    want_g = J_XB(jfv, jtex, None, want, want_ag, jnp.asarray(g), jcfg, jp)
    got, got_g = _port(backend, fv, tex, g, kw, tp)
    _assert_close(got, got_g, want, want_g)
    if rgb == 'hard':
        # a texel's gradient is the upstream colour gradient summed over
        # the pixels that won it: most texels of 49 or 256 get none
        assert (got_g[1] == 0).mean() > 0.5


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
def test_big_texture_matches_pallas_interpret(rgb, backend):
    """TS = 49 against the TPU kernels themselves in interpret mode: the
    blocked texel streaming (softmax) and the deferred winner sampling and
    segment-sum (hard RGB above 25 texels)."""
    fv, tex, g, kw, jp, tp = _scene(rgb, 49)
    jcfg = JC.RenderConfig.create(backend='pallas', pixel_tile=64,
                                  on_fallback='error', **kw)
    assert PB._tex_blocked(jcfg, 49) and not PB._hard_inkernel(jcfg, 49)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    want, want_ag, aux = J_PFA(jfv, jtex, jcfg, jp)
    want_g = J_PBA(jfv, jtex, aux, want, want_ag, jnp.asarray(g), jcfg, jp)
    got, got_g = _port(backend, fv, tex, g, kw, tp)
    _assert_close(got, got_g, want, want_g)


@pytest.mark.parametrize('backend', ['torch', 'cuda'])
def test_hard_rgb_has_no_texture_cap(backend):
    """Hard RGB at 33 x 33 = 1089 texels per face renders and
    differentiates on both backends (the kernels sample only a pixel's
    winner), and equals xla."""
    fv, tex, g, kw, jp, tp = _scene('hard', 1089)
    jcfg = JC.RenderConfig.create(**kw)
    want, _ = J_XF(jnp.asarray(fv), jnp.asarray(tex), None, jcfg, jp)
    got, got_g = _port(backend, fv, tex, g, kw, tp)
    np.testing.assert_allclose(got, np.asarray(want), **IMG_TOL)
    assert got_g[1].shape == (1, 9, 1089, 3)
    assert np.isfinite(got_g[1]).all() and np.abs(got_g[1]).max() > 0


def test_softmax_above_the_cap_raises_and_torch_renders():
    fv, tex, g, kw, jp, tp = _scene('softmax', 1089)
    with pytest.raises(ValueError, match='backend="torch"'):
        render(torch.from_numpy(fv), torch.from_numpy(tex), backend='cuda',
               **kw)
    img = render(torch.from_numpy(fv), torch.from_numpy(tex),
                 backend='torch', **kw)
    assert img.shape == (1, 4, 16, 16) and bool(torch.isfinite(img).all())
    # 1024 texels, the cap itself, is inside
    cfg = C.RenderConfig.create(backend='cuda', **kw)
    CB.check_envelope(cfg, CB.SOFTMAX_TS_CAP)
    assert CB.SOFTMAX_TS_CAP == PB.SOFTMAX_TS_CAP


@pytest.mark.parametrize('rgb', ['softmax', 'hard'])
@pytest.mark.parametrize('ts', [50, 250])
def test_non_square_big_textures_are_refused(rgb, ts):
    fv, tex, g, kw, jp, tp = _scene(rgb, ts)
    with pytest.raises(ValueError, match='square'):
        render(torch.from_numpy(fv), torch.from_numpy(tex), backend='cuda',
               **kw)


@pytest.mark.parametrize('ts,rows', [(36, 160), (49, 48 + 3 * 56),
                                     (256, 48 + 768), (1024, 48 + 3072),
                                     (1089, 48 + 3 * 1096)])
def test_packed_rows_pad_texels_to_a_block(ts, rows):
    """The row count is a multiple of 8; above 36 texels the texel rows are
    padded to a multiple of 8 texels
    (the JAX package's layout); the kernels never read the padding."""
    from gendr_tpu.raster import pack as JP
    assert pack.num_rows(C.TEXTURE_SURFACE, ts) == rows \
        == JP.num_rows(JC.TEXTURE_SURFACE, ts)


@pytest.mark.parametrize('rgb,ts,fc,store,smem', [
    # registers: vertex colours and one texel are not in this table's path;
    # a block's pixel columns are a ring of two tiles
    ('softmax', 25, 128, 'shared', (2 * 10 * 256 + 75 * 128) * 4),
    ('softmax', 36, 128, 'shared', (2 * 10 * 256 + 108 * 128) * 4),
    ('softmax', 49, 128, 'shared', (2 * 10 * 256 + 147 * 128) * 4),
    ('softmax', 121, 128, 'shared', 206336),
    ('softmax', 144, 128, 'global', 2 * 10 * 256 * 4),
    ('hard', 144, 128, 'global', 2 * 6 * 256 * 4),
    ('softmax', 169, 128, 'global', 2 * 10 * 256 * 4),
    ('softmax', 256, 128, 'global', 2 * 10 * 256 * 4),
    ('hard', 256, 128, 'global', 2 * 6 * 256 * 4),
    ('softmax', 1024, 128, 'global', 2 * 10 * 256 * 4),
    ('hard', 1089, 128, 'global', 2 * 6 * 256 * 4),
    ('softmax', 256, 64, 'shared', (2 * 10 * 256 + 768 * 64) * 4),
    ('softmax', 256, 256, 'global', 2 * 10 * 256 * 4),
])
def test_backward_texel_sum_store(rgb, ts, fc, store, smem):
    """Where the backward kernel keeps a surface texture's 3 TS sums per
    face: in the shared [3 TS, FC] block while it fits the 232448 bytes a
    Hopper block may opt in to, beside the ring of two tiles' pixel
    columns; in global memory above, where a block holds the ring alone."""
    cfg = C.RenderConfig.create(image_size=16, aggr_rgb_func=rgb,
                                face_chunk=fc, backend='cuda')
    npix, _ = CB._bwd_layout(cfg, ts)
    need = CB._bwd_smem(cfg, ts)
    assert need == (2 * npix * 256 + 3 * ts * fc) * 4
    assert (need <= CB.SMEM_LIMIT) == (store == 'shared')
    assert (need if store == 'shared' else CB._bwd_smem(cfg, 1)) == smem


def test_backward_texel_sums_in_registers_need_no_block():
    cfg = C.RenderConfig.create(image_size=16, aggr_rgb_func='softmax',
                                face_chunk=8, backend='cuda')
    vtx = C.RenderConfig.create(image_size=16, aggr_rgb_func='softmax',
                                texture_type='vertex', backend='cuda')
    alpha = C.RenderConfig.create(image_size=16, channels='alpha',
                                  backend='cuda')
    assert CB._bwd_smem(cfg, 1) == 2 * 10 * 256 * 4
    assert CB._bwd_smem(vtx, 3) == 2 * 10 * 256 * 4
    assert CB._bwd_smem(alpha, 256) == 2 * 2 * 256 * 4
    # the wrapper takes a surface texture whose block fits and one whose
    # block does not, with the same layout of the result
    fv, tex, g, kw, jp, tp = _scene('softmax', 49)
    aux = CB.prepass(torch.from_numpy(fv), torch.from_numpy(tex), cfg, tp)
    pix = torch.zeros((1, 10, 256))
    out = CB.rasterize_bwd(aux['chunk_counts'], aux['chunk_ids'], aux['par'],
                           aux['packed'], aux['perm'], pix, cfg, 49)
    assert out.shape == (1, 9 + 147, 16)
    big = C.RenderConfig.create(image_size=16, aggr_rgb_func='softmax',
                                face_chunk=128, backend='cuda')
    assert CB._bwd_smem(big, 256) > CB.SMEM_LIMIT


def _scatter_torch(coef, ti, TS):
    """backend='torch''s texel sum as it was: one scatter_add_ over face *
    TS + texel, which sums in atomic order on a CUDA tensor."""
    B, _, cf = ti.shape
    idx = (torch.arange(cf) * TS + ti).reshape(B, -1, 1).expand(-1, -1, 3)
    return torch.zeros((B, cf * TS, 3)).scatter_add_(
        1, idx, coef.reshape(B, -1, 3)).reshape(B, cf, TS, 3)


def _scatter_plain(coef, ti, TS):
    """rasterize_bwd_plain's texel rows as they were ([B, 3 TS, FC], row
    3 texel + channel), put back into texel_sums' layout."""
    B, _, fc = ti.shape
    gt = torch.zeros((B, 3 * TS, fc))
    for ch in range(3):
        gt.scatter_add_(1, 3 * ti.long() + ch, coef[..., ch])
    return gt.reshape(B, TS, 3, fc).permute(0, 3, 1, 2)


@pytest.mark.parametrize('backend,rgb,ts', [
    ('torch', 'softmax', 49), ('torch', 'softmax', 1089),
    ('torch', 'hard', 49), ('cuda', 'softmax', 49), ('cuda', 'hard', 49)])
def test_texel_sums_are_the_scatter_bitwise(backend, rgb, ts, monkeypatch):
    """The texel gradient summed in a fixed order (TB.texel_sums, a
    segment sum) is bitwise the scatter_add_ it replaces on the CPU, where
    scatter_add_ adds each texel's pairs from 0 in ascending pixel order:
    every call of the backward (backend='torch', and 'cuda''s plain
    version, rasterize_bwd_plain) held against the old expression on its
    own inputs; and the whole gradient against xla (TEX_TOL)."""
    calls = []
    texel_sums = TB.texel_sums

    def spy(coef, ti, TS):
        out = texel_sums(coef, ti, TS)
        calls.append((coef, ti, TS, out))
        return out
    monkeypatch.setattr(TB, 'texel_sums', spy)
    fv, tex, g, kw, jp, tp = _scene(rgb, ts)
    got, got_g = _port(backend, fv, tex, g, kw, tp)
    old = _scatter_torch if backend == 'torch' else _scatter_plain
    assert calls and all(TS == ts for _, _, TS, _ in calls)
    for coef, ti, TS, out in calls:
        want = old(coef, ti, TS)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert any(bool((out != 0).any()) for *_, out in calls)
    jcfg = JC.RenderConfig.create(**kw)
    jfv, jtex = jnp.asarray(fv), jnp.asarray(tex)
    want, want_ag = J_XF(jfv, jtex, None, jcfg, jp)
    want_g = J_XB(jfv, jtex, None, want, want_ag, jnp.asarray(g), jcfg, jp)
    _assert_close(got, got_g, want, want_g)
