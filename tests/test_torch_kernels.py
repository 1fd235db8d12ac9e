"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without one.  The
file imports no jax, so it also runs where the JAX package is not
installed; from the repo root on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: image max-abs 1e-4 and winner ids equal on >= 99.9 % of covered
pixels.  The kernels are built without multiply-add contraction
(``_build.NVCC_FLAGS``) and run the probabilistic product and the einstein
fold in the plain versions' order, but the CUDA and torch transcendentals
may differ by an ulp, which can move a pixel on a shared edge to the
other face.  Gradients: entries within
np.isclose(atol 5e-4, rtol 5e-3) on > 99 % of them
(tools/tpu_selfcheck.py:407-409), each side through its own forward; the
backward kernel has no atomics, so two runs are bitwise equal.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BAND_CASES, BANDS, BIG_TEXTURE_CASES,
                        CAMERA_DEFAULT_TAUS, CASES, GRAD_AGREE, GRAD_ATOL,
                        T_CONORM_CASES, TEXTURE_CASES, agreement,
                        backward_args, band_parts, camera_experiment,
                        camera_inputs,
                        check_kernels, check_slab, face_halves,
                        flagship_cfg, flagship_scene, gendr_inputs,
                        grads_through, panda_inputs, render_launches,
                        t_conorm_inputs, training_inputs)
from gendr_tpu_torch import config as C, render
from gendr_tpu_torch.raster import cuda_backend as CB
from torch_threads import one_torch_thread  # noqa: F401

IMG_ATOL = 1e-4
WINNER_AGREE = 0.999

# (shape, shift, scale) of the CDF zoo's scenes (64x64, the icosphere):
# scale 3e-2 where not named; chosen so that alpha is not saturated, where
# the probabilistic gradient would be 0 on both sides (levy_rev at scale
# 3e-2, cauchy and reciprocal with their heavy tails)
DIST_PARAMS = {8: (0.0, 0.0, 3e-3), 9: (0.0, 0.0, 3e-3),
               12: (0.0, 0.05, 3e-2), 13: (0.0, 0.05, 3e-2),
               14: (2.0, 1.0, 3e-2), 15: (2.0, 0.1, 3e-2),
               16: (0.0, 1.0, 3e-2), 17: (0.0, 0.1, 1e-4)}


def _zoo_cfg_params(fid, squared):
    shape, shift, scale = DIST_PARAMS.get(fid, (0.0, 0.0, 3e-2))
    cfg = flagship_cfg(64, dist_func=fid, dist_squared=squared,
                       double_side=False)
    params = C.RenderParams(dist_scale=scale, dist_shape=shape,
                            dist_shift=shift, dist_eps=1e3).as_dict()
    return cfg, params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'False)')
    return 'cuda'


def _kernel_vs_plain(cfg, params, B, device, seed=0):
    fv, tex = flagship_scene(device, B, seed)
    aux = CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg)
    launches = CB.LAUNCHES['rasterize_fwd']
    got = CB.rasterize_fwd(*args)
    assert CB.LAUNCHES['rasterize_fwd'] == launches + 1
    want = CB.rasterize_fwd_plain(*args)
    torch.cuda.synchronize()
    soft_k, ag_k = CB._finalize_soa(got, cfg, params)
    soft_p, ag_p = CB._finalize_soa(want, cfg, params)
    assert float((soft_k - soft_p).abs().max()) <= IMG_ATOL
    if cfg.channels == 'rgba':
        covered = (ag_k[:, 1] >= 0) | (ag_p[:, 1] >= 0)
        assert int(covered.sum()) > 0
        agree = float((ag_k[:, 1] == ag_p[:, 1])[covered].float().mean())
        assert agree >= WINNER_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,B,size', CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, kw, B, size):
    _kernel_vs_plain(flagship_cfg(size, **kw),
                     C.RenderParams(dist_scale=1e-2).as_dict(), B, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize('fid', range(18))
def test_kernel_cdf_zoo_matches_plain(cuda, fid):
    for squared in (False, True):
        cfg, params = _zoo_cfg_params(fid, squared)
        _kernel_vs_plain(cfg, params, 1, cuda, seed=fid)


@pytest.mark.cuda
@pytest.mark.parametrize('size,face_chunk', [(17, 32), (40, 64), (64, 16)])
def test_kernel_small_and_ragged_sizes(cuda, size, face_chunk):
    cfg = flagship_cfg(size, face_chunk=face_chunk)
    _kernel_vs_plain(cfg, C.RenderParams(dist_scale=1e-2).as_dict(), 2,
                     cuda)


# the three modes of the forward kernel, as RenderConfig keywords
MODES = {'alpha': dict(channels='alpha'), 'hard': {},
         'softmax': dict(aggr_rgb_func='softmax')}


@pytest.mark.cuda
@pytest.mark.parametrize('mode', MODES)
def test_kernel_where_the_cull_drops_most_of_each_list(cuda, mode):
    """The flagship at tau 1e-3, uncompacted: each tile's listed chunks
    hold mostly faces that meet no pixel of it, which the block's cull
    drops (cuda_backend.tile_face_survivors keeps under a tenth of
    them)."""
    from gendr_tpu_torch.raster import pairmath as PM
    cfg = flagship_cfg(256, compact='off', **MODES[mode])
    params = C.RenderParams(dist_scale=1e-3).as_dict()
    fv, tex = flagship_scene(cuda)
    aux = CB.prepass(fv, tex, cfg, params)
    counts, _ = CB.tile_face_survivors(aux['packed'], cfg,
                                       aux['par'][PM.P_MARGIN])
    assert int(aux['tile_counts'].max()) > 4
    assert int(counts.sum()) < 0.1 * int(aux['tile_counts'].sum()) \
        * cfg.face_chunk
    _kernel_vs_plain(cfg, params, 1, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', MODES)
def test_kernel_on_a_dense_frame(cuda, mode):
    """Gaussian tau 1 at 64x64: every listed face meets every tile, and
    nearly every pair is admitted."""
    cfg = flagship_cfg(64, dist_func='gaussian', **MODES[mode])
    _kernel_vs_plain(cfg, C.RenderParams(dist_scale=1.0).as_dict(), 2, cuda)


@pytest.mark.cuda
def test_render_on_cuda_launches_the_kernel_or_raises(cuda):
    fv, tex = flagship_scene(cuda)
    launches = CB.LAUNCHES['rasterize_fwd']
    for rgb in ('hard', 'softmax'):
        img = render(fv, tex, image_size=64, aggr_rgb_func=rgb)
        assert img.is_cuda and CB.LAUNCHES['rasterize_fwd'] == launches + 1
        ref = render(fv, tex, image_size=64, aggr_rgb_func=rgb,
                     backend='torch')
        assert CB.LAUNCHES['rasterize_fwd'] == launches + 1
        assert float((img - ref).abs().max()) <= IMG_ATOL
        launches += 1
    # a parametric fold (K1c) launches the kernel like any other family
    kw = dict(image_size=64, aggr_rgb_func='hard', aggr_alpha_func='yager',
              aggr_alpha_t_conorm_p=2.0)
    img = render(fv, tex, **kw)
    assert CB.LAUNCHES['rasterize_fwd'] == launches + 1
    launches += 1
    assert float((img - render(fv, tex, backend='torch', **kw)).abs().max()) \
        <= IMG_ATOL
    # softmax RGB above 1024 texels per face is outside the envelope
    _, big = flagship_scene(cuda, TS=1089)
    with pytest.raises(ValueError, match='backend="torch"'):
        render(fv, big, image_size=64, aggr_rgb_func='softmax')
    _, odd = flagship_scene(cuda, TS=3)
    with pytest.raises(ValueError, match='square'):
        render(fv, odd, image_size=64)
    assert CB.LAUNCHES['rasterize_fwd'] == launches


def _bwd_kernel_vs_plain(cfg, params, B, device, seed=0):
    fv, tex = flagship_scene(device, B, seed)
    aux = CB.prepass(fv, tex, cfg, params)
    launches = CB.LAUNCHES['rasterize_bwd']
    got = grads_through(cfg, params, fv, tex, True, aux)
    again = grads_through(cfg, params, fv, tex, True, aux)
    assert CB.LAUNCHES['rasterize_bwd'] == launches + 2
    want = grads_through(cfg, params, fv, tex, False, aux)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert agreement(got[0], want[0]) > GRAD_AGREE
    assert agreement(got[1], want[1]) > GRAD_AGREE
    return want


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,B,size', CASES, ids=[c[0] for c in CASES])
def test_bwd_kernel_matches_plain(cuda, name, kw, B, size):
    want = _bwd_kernel_vs_plain(flagship_cfg(size, **kw),
                                C.RenderParams(dist_scale=1e-2).as_dict(), B,
                                cuda)
    assert float(want[0].abs().max()) > 100 * GRAD_ATOL


@pytest.mark.cuda
def test_kernels_match_plain_on_opt_shape_inputs(cuda):
    # the shape optimizer's soft and hard renderers at B=24, 64x64, on the
    # template, and its goal renderer at B=120 on the cube
    names = []
    for name, cfg, params, fv, tex in training_inputs(cuda):
        check_kernels(name, cfg, params, fv, tex)
        names.append(name)
    assert names == ['opt soft', 'opt hard', 'opt goal']


@pytest.mark.cuda
@pytest.mark.parametrize('fid', range(18))
def test_bwd_kernel_cdf_zoo_matches_plain(cuda, fid):
    for squared in (False, True):
        cfg, params = _zoo_cfg_params(fid, squared)
        want = _bwd_kernel_vs_plain(cfg, params, 1, cuda, seed=fid)
        # a step's PDF is 0, so heaviside has no geometry gradient; the
        # others' must lie well above the absolute tolerance
        if fid != C.HEAVISIDE:
            assert float(want[0].abs().max()) > 100 * GRAD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize('size,face_chunk', [(17, 32), (40, 64), (64, 16)])
def test_bwd_kernel_small_and_ragged_sizes(cuda, size, face_chunk):
    for channels in ('rgba', 'alpha'):
        cfg = flagship_cfg(size, face_chunk=face_chunk, channels=channels,
                           dist_func='logistic')
        _bwd_kernel_vs_plain(cfg, C.RenderParams(dist_scale=3e-2).as_dict(),
                             2, cuda)


@pytest.mark.cuda
def test_render_backward_on_cuda_launches_the_kernel(cuda):
    fv, tex = flagship_scene(cuda)
    fv.requires_grad_(True)
    kw = dict(image_size=64, aggr_rgb_func='hard', dist_func='logistic',
              dist_scale=3e-2)
    grads = {}
    for backend in ('cuda', 'torch'):
        launches = CB.LAUNCHES['rasterize_bwd']
        img = render(fv, tex, backend=backend, **kw)
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        grads[backend] = torch.autograd.grad(loss, fv)[0]
        assert CB.LAUNCHES['rasterize_bwd'] == launches \
            + (backend == 'cuda')
    assert agreement(grads['cuda'], grads['torch']) > GRAD_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,B,size,ts', TEXTURE_CASES,
                         ids=[c[0] for c in TEXTURE_CASES])
def test_textured_kernels_match_plain(cuda, name, kw, B, size, ts):
    # K1b/K2b: softmax RGB and textures, both kernels against their plain
    # versions (image, no hard-RGB winner flips, gradients, bitwise repeats)
    fv, tex = flagship_scene(cuda, B, TS=ts,
                             texture_type=kw.get('texture_type', 'surface'))
    cfg = flagship_cfg(size, **kw)
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    check_kernels(name, cfg, params, fv, tex)


@pytest.mark.cuda
def test_kernels_match_plain_on_panda_and_gendr_inputs(cuda):
    # the panda_dist renderer on its TS=25 scene at 256x256, and the
    # default GenDR's inputs (4 views at 512x512, surface and vertex)
    check_kernels('panda', *panda_inputs(cuda))
    names = []
    for name, cfg, params, fv, tex in gendr_inputs():
        check_kernels(name, cfg, params, fv, tex)
        names.append(name)
    assert names == ['gendr surf', 'gendr vert']


@pytest.mark.cuda
@pytest.mark.parametrize('texture_type', ['surface', 'vertex'])
def test_default_renderer_launches_each_kernel_once(cuda, texture_type):
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    v, f, tex = data.textured_scene(5)
    if texture_type == 'vertex':
        tex = np.random.RandomState(0).rand(v.shape[0], 3)
    grads = {}
    for backend in (None, 'torch'):
        verts = torch.tensor(v, device=cuda, requires_grad=True)
        t = torch.tensor(tex, dtype=torch.float32, device=cuda,
                         requires_grad=True)
        mesh = G.Mesh.create(verts, f, t, 5 if texture_type == 'surface'
                             else 1, texture_type)
        look = G.LookAt().to(cuda)
        look.set_eyes_from_angles(2.732, 30.0, 45.0)
        launches = dict(CB.LAUNCHES)
        img = G.GenDR(image_size=64, anti_aliasing=True,
                      texture_type=texture_type, backend=backend)(
            look(G.Lighting().to(cuda)(mesh)))
        loss = 0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()
        grads[backend] = (img.detach(),
                          *torch.autograd.grad(loss, (verts, t)))
        ran = int(backend is None)
        # softmax RGB: the appended chunks keep the chunk kernel
        assert {k: CB.LAUNCHES[k] - n for k, n in launches.items()} \
            == render_launches(ran, ran)
    assert float((grads[None][0] - grads['torch'][0]).abs().max()) \
        <= IMG_ATOL
    assert agreement(grads[None][2], grads['torch'][2]) > GRAD_AGREE
    assert float(grads[None][1].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,p,ts', T_CONORM_CASES,
                         ids=[c[0] for c in T_CONORM_CASES])
def test_parametric_fold_kernels_match_plain(cuda, name, kw, p, ts):
    # K1c/K2c: the six parametric t-conorms in alpha-only, hard-RGB and
    # softmax-RGB renders, both kernels against their plain versions (the
    # same serial fold order on both sides)
    check_kernels(name, *t_conorm_inputs(kw, p, ts, cuda))


@pytest.mark.cuda
def test_probe_kernels_match_torch(cuda):
    # both probe kernels over every case of the three tools, the whole
    # phase in one launch of each: they agree with each other bitwise, each
    # case's output bitwise its own one-case launch, and with torch on the
    # card within the budget of the op's kind
    from chip_smoke import within_ulp_budget
    from gendr_tpu_torch.tools import _ulp
    cases = _ulp.check_cases() + _ulp.bisect_cases() + _ulp.smem_cases()
    launches = dict(_ulp.LAUNCHES)
    outs = {k: _ulp.run_cases(cases, k, cuda) for k in launches}
    assert _ulp.LAUNCHES == {k: n + 1 for k, n in launches.items()}
    bits = {k: [o.view(torch.int32) for o in v] for k, v in outs.items()}
    for i, case in enumerate(cases):
        by_value, by_vector = (bits[k][i] for k in launches)
        assert torch.equal(by_value, by_vector), case.name
        for k in launches:
            alone = _ulp.run_cases([case], k, cuda)[0].view(torch.int32)
            assert torch.equal(alone, bits[k][i]), (k, case.name)
    for k, o in outs.items():
        for r in _ulp.compare(cases, k, o):
            assert within_ulp_budget(r), (k, r.case.name, r.card)


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,p,ts', BIG_TEXTURE_CASES,
                         ids=[c[0] for c in BIG_TEXTURE_CASES])
def test_big_texture_kernels_match_plain(cuda, name, kw, p, ts):
    # K1d/K2d: 49 texels per face (sums in shared memory), 256, 1024 and
    # hard RGB at 1089 (sums in global memory), both kernels against their
    # plain versions
    check_kernels(name, *t_conorm_inputs(kw, p, ts, cuda))


@pytest.mark.cuda
def test_render_of_a_loaded_obj_launches_each_kernel_once(cuda, tmp_path):
    # save_obj -> load_obj(texture_res=16) onto the card -> the default
    # renderer at 256 texels per face, forward and backward
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    from gendr_tpu_torch.geometry import obj_io
    v, f, tex = data.textured_scene(16)
    path = str(tmp_path / 'm.obj')
    obj_io.save_obj(path, v, f, tex[0], texture_res=16)
    mesh = G.Mesh.from_obj(path, load_texture=True, texture_res=16,
                           device=cuda)
    assert mesh.textures.is_cuda
    assert tuple(mesh.textures.shape) == (1, 1280, 256, 3)
    textures = mesh.textures.clone().requires_grad_(True)
    look = G.LookAt().to(cuda)
    look.set_eyes_from_angles(2.732, 30.0, 45.0)
    launches = dict(CB.LAUNCHES)
    img = G.GenDR(image_size=64, anti_aliasing=True)(
        look(G.Lighting().to(cuda)(mesh.with_textures(textures))))
    (0.5 * (img[:, 3] ** 2).sum() + 0.1 * img[:, :3].sum()).backward()
    assert {k: CB.LAUNCHES[k] - n for k, n in launches.items()} \
        == render_launches(1, 1)
    assert bool(torch.isfinite(textures.grad).all())
    assert float(textures.grad.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('vs', [16, 32])
def test_voxelization_on_the_card_equals_the_cpu(cuda, vs):
    import gendr_tpu_torch as G
    from gendr_tpu_torch import data
    v, f = data.icosphere(2)
    got = G.Mesh.create(v * 0.4, f, device=cuda).voxelize(vs)
    want = G.Mesh.create(v * 0.4, f, device='cpu').voxelize(vs)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert int(want[0, vs // 2, vs // 2, vs // 2]) == 1


@pytest.mark.cuda
def test_opt_camera_steps_launch_the_kernels(cuda):
    """Each of 10 steps launches each kernel once: step by step through
    the wrappers (--chain 1); with --chain 20 the wrappers count the
    capture's warm-up steps and its calls (which record, not launch), and
    each replay launches what the capture recorded."""
    from gendr_tpu_torch.experiments import opt_camera as OC
    for chain in (1, 20):
        args = OC.parse_args(['--quick', '-ni', '10', '-bs', '8', '--chain',
                              str(chain)])
        exp = OC.CameraExperiment(args, cuda)
        launches = dict(CB.LAUNCHES)
        rec = exp.run(OC.initial_poses(8, 15, 35))
        steps = exp.chains['iou']
        captured = steps.captured
        counted = {k: CB.LAUNCHES[k] - n - captured.get(k, 0)
                   + captured.get(k, 0) * steps.replays
                   for k, n in launches.items()}
        warmup = steps.warmup if chain > 1 else 0
        assert counted == {k: 10 + warmup for k in launches}
        assert steps.replays == (10 if chain > 1 else 0)
        assert np.isfinite(rec['losses']).all()
        assert np.isfinite(rec['poses']).all()


@pytest.mark.cuda
@pytest.mark.parametrize('tau', CAMERA_DEFAULT_TAUS)
def test_kernels_match_plain_on_opt_camera_defaults(cuda, tau):
    """chip_smoke.py path (k1): the soft render of opt_camera's first step
    at its defaults, 200 poses at 64x64 on the cube, compacted (one slab a
    tile: 3200 slab blocks in K2's launch of the appended chunks), at the
    anneal's first and last tau: both kernels against their plain
    versions (check_kernels)."""
    exp, init = camera_experiment(20, device=cuda)
    cfg, params, fv, tex = camera_inputs(exp, init, tau)
    aux = CB.prepass(fv, tex, cfg, params)
    assert fv.shape[0] == 200 and 'oct_ids' in aux
    check_kernels(f'camera {tau:g}', cfg, params, fv, tex, aux)


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,p,ts', BAND_CASES,
                         ids=[c[0] for c in BAND_CASES])
def test_band_and_shard_kernels_match_plain(cuda, name, kw, p, ts):
    """K1e and K2e: each row band of BANDS (one ragged) and each face half
    (the second with caller-padded faces) against the plain versions; the
    kernel's band rows bitwise its full render's; an offset shard's winner
    ids are the plain version's input ids plus its base_offset."""
    cfg, params, fv, tex = t_conorm_inputs(kw, p, ts, cuda)
    for label, f, t, aux in band_parts(cfg, params, fv, tex):
        check_kernels(f'{name} {label}', cfg, params, f, t, aux)
    full, _ = CB.forward_partial(fv, tex, cfg, params)
    size = cfg.image_size
    for r0, hb in BANDS:
        band, _ = CB.forward_partial(fv, tex, cfg, params, row_band=(r0, hb))
        pix = slice(r0 * size, (r0 + hb) * size)
        assert all(torch.equal(a, b[:, pix]) for a, b in zip(band, full))
    f, t, valid, offset = face_halves(cfg, fv, tex)[1]
    carry, aux = CB.forward_partial(f, t, cfg, params, base_offset=offset,
                                    fvalid=valid)
    plain = CB.rasterize_fwd_plain(aux['tile_counts'], aux['tile_ids'],
                                   aux['par'], aux['packed'], aux['perm'],
                                   cfg, ts)
    torch.cuda.synchronize()
    assert float((carry[0] - plain[:, 0]).abs().max()) <= IMG_ATOL
    if CB.render_mode(cfg) == CB.MODE_HARD:
        ids = plain[:, 2].to(torch.int32)
        want = torch.where(ids >= 0, ids + offset, ids)
        covered = (carry[5] >= 0) | (want >= 0)
        assert int(covered.sum()) > 0 and int(carry[5].max()) >= offset
        assert float((carry[5] == want)[covered].float().mean()) \
            >= WINNER_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize('ts,slices', [(25, 128), (1024, 4)])
def test_split_bwd_kernel_on_lists_longer_than_their_slices(cuda, ts,
                                                            slices):
    """K2 split into slices at 4 views of 512x512, softmax RGB: at 25
    texels per face S = 128 and the longest list is longer, so a block
    walks two tiles; at 1024 the workspace cuts S to 4.  Kernel vs plain
    and bitwise repeats (check_kernels)."""
    cfg = flagship_cfg(512, aggr_rgb_func='softmax', compact='off')
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    fv, tex = flagship_scene(cuda, 4, TS=ts)
    aux = CB.prepass(fv, tex, cfg, params)
    B, _, Fp = aux['packed'].shape
    S = CB.bwd_slice_count(B, CB._bwd_layout(cfg, ts)[1], Fp,
                           aux['chunk_ids'].shape[2])
    assert S == slices and int(aux['chunk_counts'].max()) > S
    check_kernels(f'split ts{ts}', cfg, params, fv, tex, aux)


@pytest.mark.cuda
@pytest.mark.parametrize('size,face_chunk', [(16, 128), (40, 64)])
def test_split_bwd_kernel_with_empty_slices(cuda, size, face_chunk):
    """One tile (T = 1, so S = 1), and a ragged 40x40 image (T = S = 9)
    whose chunks of 64 faces list a few tiles each, so most slices are
    empty: their blocks write zeros that the second pass adds."""
    params = C.RenderParams(dist_scale=1e-2).as_dict()
    for channels in ('rgba', 'alpha'):
        cfg = flagship_cfg(size, face_chunk=face_chunk, channels=channels,
                           dist_func='logistic')
        fv, tex = flagship_scene(cuda, 2)
        aux = CB.prepass(fv, tex, cfg, params)
        B, K = aux['chunk_counts'].shape
        T = aux['chunk_ids'].shape[2]
        S = CB.bwd_slice_count(B, CB._bwd_layout(cfg)[1], K * face_chunk, T)
        assert S == T
        if T > 1:
            assert int(aux['chunk_counts'].sum()) < B * K * S // 2
        _bwd_kernel_vs_plain(cfg, params, 2, cuda)


@pytest.mark.cuda
def test_split_bwd_kernel_on_a_band_of_a_face_shard(cuda):
    """K2e split into slices: the second face half (offset, with
    caller-padded faces) over the ragged band of rows 37-136."""
    cfg, params, fv, tex = t_conorm_inputs({}, 0.0, 1, cuda)
    f, t, valid, _ = face_halves(cfg, fv, tex)[1]
    aux = CB.prepass(f, t, cfg, params, valid, (37, 100))
    assert int(aux['chunk_counts'].max()) > 1
    check_kernels('split band', cfg, params, f, t, aux)


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['flagship', 'band', 'overflow'])
def test_kernels_on_compacted_inputs(cuda, name):
    """Per-tile face compaction: the gate fires (packed columns past the
    sorted faces), both kernels hold against their plain versions, K2
    sums the appended slabs unsliced, and the forward's output is bitwise
    that of compact='off'."""
    import dataclasses
    from chip_smoke import overflow_scene
    if name == 'overflow':
        cfg = flagship_cfg(128, dist_func='logistic')
        params = C.RenderParams(dist_scale=3e-3).as_dict()
        fv, tex = overflow_scene(cuda)
    else:
        cfg = flagship_cfg()
        params = C.RenderParams(dist_scale=1e-2).as_dict()
        fv, tex = flagship_scene(cuda)
    band = (128, 128) if name == 'band' else None
    aux = CB.prepass(fv, tex, cfg, params, row_band=band)
    assert 'oct_ids' in aux
    assert aux['packed'].shape[2] > CB.sorted_face_count(aux)
    if name == 'overflow':
        assert int(aux['tile_counts'].max()) > 1
    check_kernels(f'compact {name}', cfg, params, fv, tex, aux)
    off = CB.prepass(fv, tex, dataclasses.replace(cfg, compact='off'),
                     params, row_band=band)
    outs = [CB.rasterize_fwd(a['tile_counts'], a['tile_ids'], a['par'],
                             a['packed'], a['perm'], cfg, 1, a['row0'],
                             a['height']) for a in (aux, off)]
    assert torch.equal(*outs)


@pytest.mark.cuda
def test_training_is_reproducible_without_deterministic_algorithms(cuda):
    """Two runs from one start, with no deterministic algorithms asked for:
    5 eager opt_shape steps (24 views at 64x64) and 3 reconstruction steps
    at batch 64 give bitwise equal losses and parameters (every sum of
    the training paths runs in a fixed order, and the reconstruction asks
    cuDNN for its deterministic algorithms)."""
    import tempfile
    from chip_smoke import (TRAIN_LR, TRAIN_SIGMA, _shape_experiment,
                            reconstruction_args)
    from gendr_tpu_torch.experiments import train_reconstruction as TR
    assert not torch.are_deterministic_algorithms_enabled()

    def shape_run():
        exp, eyes, targets = _shape_experiment(None,
                                               extra=['--chain', '1'])
        rec = exp.run(TRAIN_LR, TRAIN_SIGMA, eyes, targets, 5)
        return rec['losses'], torch.cat([p.detach().reshape(-1)
                                         for p in exp.model.parameters()])

    def recon_run():
        with tempfile.TemporaryDirectory() as tmp:
            res = TR.main(reconstruction_args(cuda, [
                '--eval_freq', '3', '--print_freq', '3',
                '--max-eval-batches', '1']) + [
                '-ni', '3', '--chain', '1', '--checkpoint-dir', tmp])
            state = torch.load(TR._checkpoints(tmp)[-1], weights_only=True)
        return res['losses'], torch.cat([
            v.reshape(-1).float() for part in ('encoder', 'decoder')
            for v in state[part].values()])

    for run in (shape_run, recon_run):
        (l1, p1), (l2, p2) = run(), run()
        assert list(l1) == list(l2), run.__name__
        assert torch.equal(p1, p2), run.__name__


# rasterize_bwd_slab's inputs: path (k)'s render at both ends of its anneal
# and the compacted flagship, hard RGB over one texel and vertex colours
SLAB_CASES = ['camera 0.1', 'camera 1e-07', 'flagship', 'flagship vertex']


@pytest.mark.cuda
@pytest.mark.parametrize('name', SLAB_CASES)
def test_slab_kernel_matches_plain(cuda, name):
    """rasterize_bwd_slab (compaction's appended chunks, a thread per pixel
    of the chunk's tile) against rasterize_bwd_plain on the same pixel
    columns, with phase 1's gates (chip_smoke.check_slab), and two runs of
    K2 bitwise equal."""
    if name.startswith('camera'):
        exp, init = camera_experiment(20, device=cuda)
        cfg, params, fv, tex = camera_inputs(exp, init, float(name[7:]))
        assert fv.shape[0] == 200
    else:
        vertex = name.endswith('vertex')
        cfg = flagship_cfg(texture_type='vertex' if vertex else 'surface')
        params = C.RenderParams(dist_scale=1e-2).as_dict()
        fv, tex = flagship_scene(cuda, texture_type='vertex' if vertex
                                 else 'surface')
    aux = CB.prepass(fv, tex, cfg, params)
    assert 'oct_ids' in aux
    TS = tex.shape[2]
    out = CB.rasterize_fwd(aux['tile_counts'], aux['tile_ids'], aux['par'],
                           aux['packed'], aux['perm'], cfg, TS)
    check_slab(name, cfg, params, aux, TS, out)
    bargs = backward_args(aux, cfg, params, TS, out)
    assert torch.equal(CB.rasterize_bwd(*bargs), CB.rasterize_bwd(*bargs))


@pytest.mark.cuda
def test_torch_backend_texel_gradient_repeats_bitwise(cuda):
    """backend='torch' above the kernels' softmax cap, where it is the only
    backend on the card: the default GenDR at 33 x 33 texels a face on 4
    views, forward and backward twice, the image and the face, vertex and
    texel gradients bitwise equal (the texel gradient is a fixed-order
    segment sum, no atomics), under TORCH_PEAK_GIB (path (l),
    chip_smoke.torch_texel_phase)."""
    from chip_smoke import torch_texel_phase
    torch_texel_phase()
