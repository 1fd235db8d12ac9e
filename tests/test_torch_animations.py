"""The port's sweeps (gendr_tpu_torch.animations) on the CPU.

* panda_tcn's, triangles_tcn's and triangles_dist's frames (a frame per
  parametric t-conorm family, a p-sweep frame, the triangle), through
  backend='cuda', against the JAX package's renderer with the same
  configuration on the same scene, to the same 2e-3; t_conorms' surfaces
  and distributions_to_csv's table against the JAX scripts' (and the
  latter against the committed dist_function_values.csv);
* panda_dist's frames, through backend='cuda' (on CPU tensors the kernels' plain
  versions), against the JAX package's renderer with the same
  configuration on the same scene: image max-abs below 2e-3
  (tools/tpu_selfcheck.py:404-409);
* its command line: the JAX script's options and defaults plus --device,
  which names the card and exits with a clear error without one (as
  experiments/opt_shape.py does), and a --quick run at a tiny resolution
  whose PNGs the standard library reads back.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import gendr_tpu
from animations import common as JA
from gendr_tpu_torch.animations import common as TA
from animations import distributions_to_csv as JCSV
from animations import t_conorms as JTC
from gendr_tpu_torch.animations import distributions_to_csv as CSV
from gendr_tpu_torch.animations import panda_dist as PD
from gendr_tpu_torch.animations import panda_tcn as TCN
from gendr_tpu_torch.animations import (panda_tcn_p, t_conorms,
                                        triangles_dist, triangles_tcn,
                                        triangles_tcn_p)
from gendr_tpu_torch.experiments import opt_shape as OS
from gendr_tpu_torch.raster import cuda_backend as CB
from torch_threads import one_torch_thread  # noqa: F401

IMG_TOL = 2e-3


def read_png(path):
    """An 8-bit RGB PNG without filtering, as save_png writes it, read
    with the standard library: uint8 [H, W, 3]."""
    data = open(path, 'rb').read()
    assert data[:8] == b'\x89PNG\r\n\x1a\n'
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + payload) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b'') + payload
        pos += 12 + n
    w, h, depth, ctype = struct.unpack('>IIBB', chunks[b'IHDR'][:10])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b'IDAT']), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()  # filter type 0 on every row
    return rows[:, 1:].reshape(h, w, 3)


def _jax_frame(dist_func, dist_shape, tau, resolution):
    """The JAX package's panda_dist frame (animations/panda_dist.py) on
    the same stand-in scene, through its xla backend."""
    mesh = JA.textured_scene(PD.parse_args([]).texture_res)
    transform = gendr_tpu.LookAt()
    transform.set_eyes_from_angles(3.0, 20.0, 180.0)
    mesh = transform(gendr_tpu.Lighting()(mesh))
    renderer = gendr_tpu.GenDR(
        image_size=resolution, anti_aliasing=True, dist_func=dist_func,
        dist_shape=dist_shape, dist_shift=0., dist_eps=PD.DIST_EPS,
        aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0.,
        aggr_rgb_func='softmax', aggr_rgb_gamma=PD.GAMMA,
        aggr_rgb_eps=PD.EPS, backend='xla')
    renderer.dist_scale = jnp.float32(tau)
    return np.asarray(renderer.forward_tensors(mesh.face_vertices,
                                               mesh.face_textures))


def test_quick_sweep_matches_the_jax_renderer(monkeypatch):
    monkeypatch.delenv('GENDR_PANDA_OBJ', raising=False)
    args = PD.parse_args(['--quick', '--device', 'cpu', '--resolution', '12',
                          '--backend', 'cuda'])
    fv, tex = PD.scene(args.texture_res, 'cpu')
    assert tuple(fv.shape) == (1, 1280, 3, 3)
    assert tuple(tex.shape) == (1, 1280, 25, 3)
    log_taus, dists = PD.sweep(args)
    assert len(log_taus) == 7 and len(dists) == 2
    launches = dict(CB.LAUNCHES)
    n = 0
    for dist_id, tau_idx, images in PD.frames(args, fv, tex):
        n += 1
        if tau_idx not in (0, 4, 6):  # tau 1e-6, 1e-2 and 1 are compared
            continue
        dist_func, dist_shape = dists[dist_id]
        want = _jax_frame(dist_func, dist_shape, 10.0 ** log_taus[tau_idx],
                          12)
        assert images.shape == (1, 4, 12, 12)
        err = float(np.abs(images.numpy() - want).max())
        assert err < IMG_TOL, (dist_func, tau_idx, err)
    assert n == 14
    assert CB.LAUNCHES == launches  # CPU: the plain versions


def test_composite_matches_the_jax_helper():
    images = np.random.RandomState(0).rand(1, 4, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(
        TA.composite_on_background(torch.from_numpy(images)),
        JA.composite_on_background(images))


def test_quick_run_on_cpu_writes_pngs_the_stdlib_reads(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv('GENDR_PANDA_OBJ', raising=False)
    argv = ['--quick', '--device', 'cpu', '--resolution', '8', '--out-dir',
            str(tmp_path)]
    ms, stats = PD.main(argv)
    assert len(ms) == 2 and len(stats) == 14
    assert all(fin and 0.0 <= lo and hi <= 1.0 for fin, lo, hi in stats)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 14 and names[0] == 'panda_dist_0_0_t000.png'
    # the first frame's PNG is the composite of that frame
    args = PD.parse_args(argv)
    fv, tex = PD.scene(args.texture_res, 'cpu')
    _, _, first = next(PD.frames(args, fv, tex))
    np.testing.assert_array_equal(read_png(tmp_path / names[0]),
                                  TA.composite_on_background(first))


def test_save_png_round_trip(tmp_path):
    arr = np.random.RandomState(1).randint(0, 256, (7, 5, 3), np.uint8)
    TA.save_png(tmp_path / 'sub' / 'a.png', arr)
    np.testing.assert_array_equal(read_png(tmp_path / 'sub' / 'a.png'), arr)


def test_command_lines_default_to_the_card():
    args = PD.parse_args([])
    assert (args.resolution, args.texture_res, args.quick, args.backend,
            args.device) == (768, 5, False, None, 'cuda')
    assert OS.parse_args([]).device == 'cuda'
    args = TCN.parse_args([])
    assert (args.resolution, args.out_dir, args.quick, args.triangle,
            args.sweep_p, args.backend, args.device) \
        == (768, './results/tcn', False, False, False, None, 'cuda')
    args = triangles_dist.parse_args([])
    assert (args.resolution, args.out_dir, args.quick, args.dists,
            args.backend, args.device) \
        == (768, './results/triangles', False, 0, None, 'cuda')


@pytest.mark.parametrize('main', [PD.main, OS.main, TCN.main,
                                  panda_tcn_p.main, triangles_tcn.main,
                                  triangles_tcn_p.main, triangles_dist.main],
                         ids=['panda_dist', 'opt_shape', 'panda_tcn',
                              'panda_tcn_p', 'triangles_tcn',
                              'triangles_tcn_p', 'triangles_dist'])
def test_no_card_is_a_clear_error(main, monkeypatch, tmp_path):
    """Without a card the default --device cuda stops with a message that
    names --device cpu, instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='--device cpu'):
        main(['--quick', '--out-dir', str(tmp_path)])


def _jax_tcn_frame(triangle, t_conorm, p, tau, resolution):
    """The JAX package's panda_tcn frame (animations/panda_tcn.py:40-60,
    79-83) through its xla backend."""
    if triangle:
        mesh = JA.triangle_scene()
    else:
        mesh = JA.textured_scene(5)
        transform = gendr_tpu.LookAt()
        transform.set_eyes_from_angles(3.0, 20.0, 180.0)
        mesh = transform(gendr_tpu.Lighting()(mesh))
    renderer = gendr_tpu.GenDR(
        image_size=resolution, anti_aliasing=True, dist_func='uniform',
        dist_shape=0., dist_shift=0., aggr_alpha_func=t_conorm,
        aggr_alpha_t_conorm_p=jnp.float32(p), dist_scale=jnp.float32(tau),
        backend='xla')
    return np.asarray(renderer.forward_tensors(mesh.face_vertices,
                                               mesh.face_textures))


@pytest.mark.parametrize('flags,configs,grid', [
    # a tau-sweep frame of each parametric family of the canonical list
    ([], [('yager', .5), ('aczel_alsina', 2.)], [-1.5]),
    # p-sweep frames: hamacher at the sweep's smallest p on the mesh; yager
    # and aczel_alsina at its smallest and largest on the triangle
    (['--sweep-p'], ['hamacher'], [-4.0]),
    (['--triangle'], [('yager', 2.)], [-1.0]),
    (['--triangle', '--sweep-p'], ['yager', 'aczel_alsina'], [-4.0, 3.975]),
], ids=['tau', 'p-hamacher', 'triangle', 'triangle-p'])
def test_tcn_frames_match_the_jax_renderer(flags, configs, grid,
                                           monkeypatch):
    monkeypatch.delenv('GENDR_PANDA_OBJ', raising=False)
    args = TCN.parse_args(flags + ['--device', 'cpu', '--resolution', '12',
                                   '--backend', 'cuda'])
    fv, tex = TCN.scene(args)
    frames = TCN.p_frames if args.sweep_p else TCN.tau_frames
    launches = dict(CB.LAUNCHES)
    n = 0
    for cfg_id, idx, images in frames(args, fv, tex, configs, grid):
        n += 1
        if args.sweep_p:
            t_conorm, p, tau = configs[cfg_id], 2.0 ** grid[idx], \
                TCN.P_SWEEP_TAU
        else:
            (t_conorm, p), tau = configs[cfg_id], 10.0 ** grid[idx]
        want = _jax_tcn_frame(args.triangle, t_conorm, p, tau, 12)
        assert images.shape == (1, 4, 12, 12)
        alpha = images[0, 3]
        assert 0.0 <= float(alpha.min()) and float(alpha.max()) <= 1.0
        assert float(alpha.max()) > 0.5
        err = float(np.abs(images.numpy() - want).max())
        assert err < IMG_TOL, (t_conorm, p, tau, err)
    assert n == len(configs) * len(grid)
    assert CB.LAUNCHES == launches  # CPU: the plain versions


def test_triangles_dist_frame_matches_the_jax_renderer():
    args = triangles_dist.parse_args(['--device', 'cpu', '--resolution',
                                      '12', '--backend', 'cuda'])
    mesh = TA.triangle_scene('cpu')
    jmesh = JA.triangle_scene()
    np.testing.assert_array_equal(mesh.face_vertices.numpy(),
                                  np.asarray(jmesh.face_vertices))
    dists = [('logistic', 0), ('gamma', .5)]
    for dist_id, tau_idx, images in triangles_dist.frames(
            args, mesh.face_vertices, mesh.face_textures, dists, [-1.0]):
        dist_func, dist_shape = dists[dist_id]
        renderer = gendr_tpu.GenDR(
            image_size=12, anti_aliasing=True, dist_func=dist_func,
            dist_shape=dist_shape, dist_shift=0.,
            aggr_alpha_func='probabilistic', aggr_alpha_t_conorm_p=0.,
            dist_scale=jnp.float32(0.1), backend='xla')
        want = np.asarray(renderer.forward_tensors(jmesh.face_vertices,
                                                   jmesh.face_textures))
        err = float(np.abs(images.numpy() - want).max())
        assert err < IMG_TOL, (dist_func, err)


@pytest.mark.parametrize('name,p', t_conorms.CONFIGS,
                         ids=[c[0] for c in t_conorms.CONFIGS])
def test_t_conorm_surface_matches_the_jax_script(name, p):
    """Surfaces to 2e-6 (tests/test_torch_ops.py's fold tolerance); the
    aggregate-inverse gradient, which divides by 1 - b or a 1e-6 guard, to
    1e-4 of max(|value|, 1) off the grid's b = 1 and a = 1 edges and to
    finiteness-agreement on them."""
    A, B, Z, dZ = t_conorms.surface(name, p, 33)
    jA, jB, jZ, jdZ = JTC.surface(name, p, 33)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_array_equal(B, jB)
    np.testing.assert_allclose(Z, jZ, atol=2e-6, rtol=0)
    assert Z.min() >= 0.0 and Z.max() <= 1.0
    np.testing.assert_array_equal(np.isfinite(dZ), np.isfinite(jdZ))
    inner = (A < 1) & (B < 1) & np.isfinite(jdZ)
    assert (np.abs(dZ - jdZ)[inner]
            <= 1e-4 * np.maximum(np.abs(jdZ[inner]), 1.0)).all()


def test_distributions_csv_matches_the_jax_script_and_the_golden_file(
        tmp_path):
    CSV.main(str(tmp_path / 'port.csv'), 201)
    got = np.loadtxt(tmp_path / 'port.csv', delimiter=',')
    golden = np.loadtxt(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'dist_function_values.csv'),
        delimiter=',')
    assert got.shape == golden.shape == (201, 11)
    # 2e-6: tests/test_torch_ops.py's cdf tolerance against the JAX
    # package; the committed file's four gamma columns (7-10) were written
    # by an earlier gamma series and differ from today's JAX script by up
    # to 4.4e-5 as well, so they are held to 1e-4
    np.testing.assert_allclose(got[:, :7], golden[:, :7], atol=2e-6, rtol=0)
    np.testing.assert_allclose(got[:, 7:], golden[:, 7:], atol=1e-4, rtol=0)
    # the JAX script itself, on a coarser grid (its scalar calls are slow)
    CSV.main(str(tmp_path / 'port21.csv'), 21)
    JCSV.main(str(tmp_path / 'jax21.csv'), 21)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / 'port21.csv', delimiter=','),
        np.loadtxt(tmp_path / 'jax21.csv', delimiter=','), atol=2e-6, rtol=0)
    # and the PDFs through the backward seam
    fid = CSV.C.DIST_FUNC_MAP['logistic']
    xs = np.linspace(-2, 2, 9)
    np.testing.assert_allclose(CSV.sweep(fid, xs, backward=True),
                               JCSV.sweep(fid, xs, backward=True), rtol=1e-5)


@pytest.mark.parametrize('main,argv,first,n', [
    (TCN.main, [], 'tcn_0_t000.png', 14),
    (panda_tcn_p.main, [], 'tcn_p_aczel_alsina_000.png', 24),
    (triangles_tcn.main, [], 'tcn_0_t000.png', 14),
    (triangles_tcn_p.main, [], 'tcn_p_aczel_alsina_000.png', 24),
    (triangles_dist.main, ['--dists', '2'], 'triangle_dist_0_t000.png', 28),
], ids=['panda_tcn', 'panda_tcn_p', 'triangles_tcn', 'triangles_tcn_p',
        'triangles_dist'])
def test_new_sweeps_quick_run_on_cpu_writes_pngs(main, argv, first, n,
                                                 tmp_path, monkeypatch):
    monkeypatch.delenv('GENDR_PANDA_OBJ', raising=False)
    stats = main(argv + ['--quick', '--device', 'cpu', '--resolution', '8',
                         '--out-dir', str(tmp_path)])
    assert len(stats) == n
    names = sorted(os.listdir(tmp_path))
    assert len(names) == n and names[0] == first
    assert read_png(tmp_path / first).shape == (8, 8, 3)
    if main is not triangles_dist.main:
        assert all(fin and 0.0 <= lo and hi <= 1.0 for fin, lo, hi in stats)
    else:
        assert all(stats)


def test_t_conorms_cli_writes_the_surfaces(tmp_path, capsys):
    t_conorms.main(str(tmp_path), 9)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 9 and 'yager_p2.0.csv' in names
    Z = np.loadtxt(tmp_path / 'frank_p2.0.csv', delimiter=',')
    assert Z.shape == (9, 9) and Z[0, 0] == 0.0 and Z[-1, -1] == 1.0
    assert 'schweizer_sklar (p=-2.0)' in capsys.readouterr().out
