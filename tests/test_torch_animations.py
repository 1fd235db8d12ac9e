"""The port's panda_dist sweep (gendr_tpu_torch.animations) on the CPU.

* its frames, through backend='cuda' (on CPU tensors the kernels' plain
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
from gendr_tpu_torch.animations import panda_dist as PD
from gendr_tpu_torch.experiments import opt_shape as OS
from gendr_tpu_torch.raster import cuda_backend as CB

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


@pytest.mark.parametrize('main', [PD.main, OS.main],
                         ids=['panda_dist', 'opt_shape'])
def test_no_card_is_a_clear_error(main, monkeypatch, tmp_path):
    """Without a card the default --device cuda stops with a message that
    names --device cpu, instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='--device cpu'):
        main(['--quick', '--out-dir', str(tmp_path)])
