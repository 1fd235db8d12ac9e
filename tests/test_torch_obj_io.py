"""OBJ / MTL / PNG I/O of the port: the cases of tests/test_obj_io.py and
tests/test_native.py against ``gendr_tpu_torch``, and the port against
``gendr_tpu`` on files the tests write.

Tolerances: parsed arrays, ``create_texture_image`` and the text files of
``save_obj`` are equal exactly; ``load_textures`` within 1e-6 (one float32
einsum and a bilinear blend in each library; 2e-5 on atlases of random
noise, see NOISE_ATOL); PNG pixels exactly.
"""

import os
import shutil
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from gendr_tpu import data
from gendr_tpu.geometry import obj_io as JIO
from gendr_tpu_torch import interop
from gendr_tpu_torch.geometry import obj_io
from gendr_tpu_torch.geometry.mesh import Mesh
from gendr_tpu_torch.native import objparse
from gendr_tpu_torch.utils import png
from torch_threads import one_torch_thread  # noqa: F401

PARSERS = ['python', 'native']
# load_textures on an atlas of random noise: the two libraries' float32
# einsum rounds a texel's UV differently by an ulp (6e-8), the pixel
# position is that times the atlas width (up to 80 here), and neighbouring
# pixels differ by up to 1, so the bilinear blend moves by up to ~1e-5.
# On smooth or small images (the other tests) the difference stays below
# 1e-6
NOISE_ATOL = 2e-5


# -- the cases of tests/test_obj_io.py ----------------------------------------

def test_save_load_roundtrip(tmp_path):
    v, f = data.icosphere(1)
    path = str(tmp_path / 'mesh.obj')
    obj_io.save_obj(path, v, f)
    v2, f2 = obj_io.load_obj(path, device='cpu')
    assert isinstance(v2, torch.Tensor) and v2.dtype == torch.float32
    assert f2.dtype == torch.int32
    np.testing.assert_allclose(v2.numpy(), v, atol=1e-6)
    np.testing.assert_array_equal(f2.numpy(), f)


def test_mesh_class_roundtrip(tmp_path):
    v, f = data.test_meshes('cube')
    mesh = Mesh.create(v, f, device='cpu')
    path = str(tmp_path / 'cube.obj')
    mesh.save_obj(path)
    mesh2 = Mesh.from_obj(path, device='cpu')
    np.testing.assert_allclose(mesh2.vertices.numpy(),
                               mesh.vertices.numpy(), atol=1e-6)
    np.testing.assert_array_equal(mesh2.faces.numpy(), mesh.faces.numpy())


def test_normalization(tmp_path):
    v, f = data.test_meshes('cube')
    v = v * 3.0 + 5.0
    path = str(tmp_path / 'c.obj')
    obj_io.save_obj(path, v, f)
    v2, _ = obj_io.load_obj(path, normalization=True, device='cpu')
    assert np.abs(v2.numpy()).max() <= 1.0 + 1e-5
    want, _ = JIO.load_obj(path, normalization=True)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(want))


def test_quad_triangulation(tmp_path):
    path = str(tmp_path / 'quad.obj')
    with open(path, 'w') as fh:
        fh.write('v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n')
        fh.write('f 1 2 3 4\n')  # quad -> 2 triangles (fan)
    for parser in PARSERS:
        v, f = obj_io.load_obj(path, parser=parser, device='cpu')
        np.testing.assert_array_equal(f.numpy(), [[0, 1, 2], [0, 2, 3]])


def _write_textured(tmp_path):
    # 8x8 texture: left half red, right half green
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 255, 0]
    png.save_png(str(tmp_path / 'tex.png'), img)
    with open(tmp_path / 'm.mtl', 'w') as fh:
        fh.write('newmtl mat_tex\nmap_Kd tex.png\n')
        fh.write('newmtl mat_blue\nKd 0.0 0.0 1.0\n')
    with open(tmp_path / 'mesh.obj', 'w') as fh:
        fh.write('mtllib m.mtl\n')
        fh.write('v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n')
        fh.write('vt 0.1 0.5\nvt 0.2 0.5\nvt 0.15 0.6\n')
        fh.write('vt 0.9 0.5\nvt 0.95 0.5\nvt 0.9 0.6\n')
        fh.write('usemtl mat_tex\n')
        fh.write('f 1/1 2/2 3/3\n')   # left of texture -> red
        fh.write('f 2/4 4/5 3/6\n')   # right of texture -> green
        fh.write('usemtl mat_blue\n')
        fh.write('f 1 2 4\n')          # constant blue
    return str(tmp_path / 'mesh.obj')


def test_textured_pipeline(tmp_path):
    """mtl Kd colors + map_Kd texture image sampling
    (load_obj.py:33-106 / load_textures CUDA kernel)."""
    path = _write_textured(tmp_path)
    v, f, tex = obj_io.load_obj(path, load_texture=True, texture_res=2,
                                device='cpu')
    tex = tex.numpy()
    assert tex.shape == (3, 4, 3)
    # face 0 red-dominant, face 1 green-dominant, face 2 exactly blue
    assert tex[0, :, 0].mean() > 0.8 and tex[0, :, 1].mean() < 0.2
    assert tex[1, :, 1].mean() > 0.8 and tex[1, :, 0].mean() < 0.2
    np.testing.assert_allclose(tex[2], np.broadcast_to([0, 0, 1], (4, 3)),
                               atol=1e-6)
    _, _, want = JIO.load_obj(path, load_texture=True, texture_res=2)
    np.testing.assert_allclose(tex, np.asarray(want), atol=1e-6)


def test_save_textured_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    v, f = data.test_meshes('cube')
    tex = rng.rand(f.shape[0], 4, 3).astype(np.float32)  # R=2
    path = str(tmp_path / 'textured.obj')
    obj_io.save_obj(path, v, f, textures=tex, texture_res=8)
    assert os.path.exists(str(tmp_path / 'textured.png'))
    assert os.path.exists(str(tmp_path / 'textured.mtl'))
    v2, f2, tex2 = obj_io.load_obj(path, load_texture=True, texture_res=2,
                                   device='cpu')
    # colors survive the bake -> sample roundtrip approximately
    err = np.abs(tex2.numpy().mean(axis=1) - tex.mean(axis=1)).max()
    assert err < 0.25, err


def test_vertex_color_obj(tmp_path):
    path = str(tmp_path / 'vc.obj')
    with open(path, 'w') as fh:
        fh.write('v 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 0 1 0 0 0 1\n')
        fh.write('f 1 2 3\n')
    for parser in PARSERS:
        v, f, tex = obj_io.load_obj(path, load_texture=True,
                                    texture_type='vertex', parser=parser,
                                    device='cpu')
        np.testing.assert_allclose(tex.numpy(), np.eye(3), atol=1e-6)
    mesh = Mesh.from_obj(path, load_texture=True, texture_type='vertex',
                         device='cpu')
    assert mesh.texture_type == 'vertex'
    assert tuple(mesh.textures.shape) == (1, 3, 3)
    # and saved again with its colours
    out = str(tmp_path / 'vc2.obj')
    obj_io.save_obj(out, v, f, textures=tex, texture_type='vertex')
    _, _, tex2 = obj_io.load_obj(out, load_texture=True,
                                 texture_type='vertex', device='cpu')
    np.testing.assert_allclose(tex2.numpy(), np.eye(3), atol=1e-6)


def test_save_voxel(tmp_path):
    vox = np.zeros((4, 4, 4), np.int32)
    vox[1, 2, 3] = 1
    path = str(tmp_path / 'vox.obj')
    obj_io.save_voxel(path, torch.from_numpy(vox))
    v, f = obj_io.load_obj(path, device='cpu')
    assert tuple(v.shape) == (1, 3)
    np.testing.assert_allclose(v.numpy(), [[0.25, 0.5, 0.75]])
    assert tuple(f.shape) == (0, 3)


def test_wrapped_uv_texture_load(tmp_path):
    """UV coordinates > 1 wrap modulo 1 exactly like the reference
    (load_obj.py:76).  A face with vt = base + 1 must sample the identical
    texels as the in-range face."""
    rng = np.random.RandomState(3)
    img = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
    png.save_png(str(tmp_path / 'tex.png'), img)
    with open(str(tmp_path / 'mat.mtl'), 'w') as fh:
        fh.write('newmtl m0\nmap_Kd tex.png\n')

    def write_obj(name, uv_offset):
        path = str(tmp_path / name)
        with open(path, 'w') as fh:
            fh.write('mtllib mat.mtl\n')
            fh.write('v 0 0 0\nv 1 0 0\nv 0 1 0\n')
            for (u, vv) in [(0.1, 0.2), (0.6, 0.25), (0.3, 0.7)]:
                fh.write(f'vt {u + uv_offset} {vv + uv_offset}\n')
            fh.write('usemtl m0\nf 1/1 2/2 3/3\n')
        return path

    _, _, tex_base = obj_io.load_obj(write_obj('a.obj', 0.0),
                                     load_texture=True, texture_res=3,
                                     device='cpu')
    _, _, tex_wrap = obj_io.load_obj(write_obj('b.obj', 1.0),
                                     load_texture=True, texture_res=3,
                                     device='cpu')
    np.testing.assert_allclose(tex_wrap.numpy(), tex_base.numpy(), atol=1e-6)
    # and the samples really came from the image, not the default white
    assert tex_base.numpy().std() > 0.01
    _, _, want = JIO.load_obj(str(tmp_path / 'a.obj'), load_texture=True,
                              texture_res=3)
    np.testing.assert_allclose(tex_base.numpy(), np.asarray(want), atol=1e-6)


# -- the cases of tests/test_native.py ----------------------------------------

OBJ_TEXT = """# comment
mtllib scene.mtl
v 0.0 0.0 0.0
v 1.0 0.0 0.5
v 1.0 1.0 -0.25
v 0.0 1.0 0.125
vt 0.1 0.2
vt 0.9 0.2
vt 0.9 0.8
vt 0.1 0.8
usemtl red
f 1/1 2/2 3/3
usemtl blue
f 1/1 3/3 4/4
f 1 2 3 4
f 1//2 2//3 3//1
"""

needs_gxx = pytest.mark.skipif(shutil.which('g++') is None,
                               reason='no g++ to build the tokenizer')


def _assert_parsed_equal(a, b):
    for key in ('vertices', 'faces', 'tex_faces', 'vt'):
        np.testing.assert_array_equal(a[key], b[key])
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
    assert a['mtllib'] == b['mtllib']
    assert list(a['face_materials']) == list(b['face_materials'])
    if a['vertex_colors'] is None:
        assert b['vertex_colors'] is None
    else:
        np.testing.assert_array_equal(a['vertex_colors'], b['vertex_colors'])


@needs_gxx
def test_native_matches_python():
    native = objparse.parse_obj_native(OBJ_TEXT)
    py = obj_io._parse_obj_python(OBJ_TEXT.splitlines(True))
    _assert_parsed_equal(native, py)
    assert native['mtllib'] == 'scene.mtl'
    assert native['face_materials'] == ['red', 'blue', 'blue', 'blue', 'blue']


@needs_gxx
def test_native_vertex_colors():
    text = 'v 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 0 1 0 0 0 1\nf 1 2 3\n'
    native = objparse.parse_obj_native(text)
    np.testing.assert_allclose(native['vertex_colors'], np.eye(3))


@needs_gxx
def test_native_speed_sanity():
    """The native path should beat the Python splitter comfortably."""
    objparse.parse_obj_native('v 0 0 0\n')  # built and loaded
    lines = []
    rng = np.random.RandomState(0)
    for i in range(20000):
        x, y, z = rng.rand(3)
        lines.append(f'v {x:.6f} {y:.6f} {z:.6f}\n')
    for i in range(0, 19998, 3):
        lines.append(f'f {i+1} {i+2} {i+3}\n')
    text = ''.join(lines)
    t0 = time.perf_counter()
    objparse.parse_obj_native(text)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    obj_io._parse_obj_python(lines)
    t_python = time.perf_counter() - t0
    assert t_native < t_python, (t_native, t_python)


# -- the port against the JAX package -----------------------------------------

@pytest.mark.parametrize('parser', PARSERS)
def test_parse_obj_equals_jax(tmp_path, parser):
    if parser == 'native' and shutil.which('g++') is None:
        pytest.skip('no g++ to build the tokenizer')
    path = tmp_path / 'scene.obj'
    path.write_text(OBJ_TEXT)
    got = obj_io.parse_obj(str(path), parser=parser)
    want = JIO._parse_obj_python(OBJ_TEXT.splitlines(True))
    _assert_parsed_equal(got, want)
    # and an icosphere written by the JAX package's save_obj
    v, f = data.icosphere(2)
    rng = np.random.RandomState(1)
    tex = rng.rand(f.shape[0], 9, 3).astype(np.float32)
    big = str(tmp_path / 'ico.obj')
    JIO.save_obj(big, v, f, textures=tex, texture_res=6)
    _assert_parsed_equal(obj_io.parse_obj(big, parser=parser),
                         JIO.parse_obj(big))


def test_parser_argument_and_errors(tmp_path, monkeypatch, capsys):
    path = tmp_path / 'bad.obj'
    path.write_text('v 0 0 zero\nf 1 1 1\n')
    with pytest.raises(ValueError, match='parser'):
        obj_io.parse_obj(str(path), parser='fast')
    # an error while parsing is raised, not swallowed
    with pytest.raises(ValueError):
        obj_io.parse_obj(str(path), parser='python')
    # no g++: parser=None parses in Python and says so once on stderr;
    # parser='native' is an error
    good = tmp_path / 'good.obj'
    good.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    monkeypatch.setattr(objparse, '_lib', None)
    monkeypatch.setattr(objparse, '_unavailable', False)
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    from gendr_tpu_torch import _build
    monkeypatch.setattr(_build, 'CACHE', tmp_path / 'empty_cache')
    parsed = obj_io.parse_obj(str(good))
    obj_io.parse_obj(str(good))
    assert parsed['faces'].tolist() == [[0, 1, 2]]
    err = capsys.readouterr().err
    assert err.count('parsing in Python') == 1 and 'g++' in err
    with pytest.raises(RuntimeError, match='not available'):
        obj_io.parse_obj(str(good), parser='native')


@pytest.mark.parametrize('res_in,res_out', [(2, 8), (5, 16), (16, 16)])
def test_create_texture_image_and_save_obj_equal_jax(tmp_path, res_in,
                                                     res_out):
    v, f = data.icosphere(1)
    rng = np.random.RandomState(res_in)
    tex = rng.rand(f.shape[0], res_in ** 2, 3).astype(np.float32)
    img, uv = obj_io.create_texture_image(torch.from_numpy(tex), res_out)
    want_img, want_uv = JIO.create_texture_image(tex, res_out)
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(uv, want_uv)

    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    JIO.save_obj(str(tmp_path / 'j' / 'm.obj'), v, f, tex, res_out)
    obj_io.save_obj(str(tmp_path / 't' / 'm.obj'), torch.from_numpy(v),
                    torch.from_numpy(f), torch.from_numpy(tex), res_out)
    for name in ('m.obj', 'm.mtl'):
        assert (tmp_path / 't' / name).read_bytes() \
            == (tmp_path / 'j' / name).read_bytes()
    # the PNG containers differ (filters, compression); the pixels do not
    got_px = png.read_png(str(tmp_path / 't' / 'm.png'))
    want_px = png.read_png(str(tmp_path / 'j' / 'm.png'))
    np.testing.assert_array_equal(got_px, want_px)
    import imageio.v2 as imageio
    np.testing.assert_array_equal(
        got_px, imageio.imread(str(tmp_path / 'j' / 'm.png')))

    # each package loads the other's files alike
    for side in ('j', 't'):
        path = str(tmp_path / side / 'm.obj')
        _, _, want = JIO.load_obj(path, load_texture=True,
                                  texture_res=res_in)
        _, _, got = obj_io.load_obj(path, load_texture=True,
                                    texture_res=res_in, device='cpu')
        assert tuple(got.shape) == (f.shape[0], res_in ** 2, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=NOISE_ATOL)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_sample_textures_from_image_equals_jax():
    rng = np.random.RandomState(5)
    image = rng.rand(12, 9, 3).astype(np.float32)
    uvs = rng.rand(7, 3, 2).astype(np.float32)
    uvs[0] = [[0, 0], [1, 0], [1, 1]]          # the image's corners
    for res in (1, 2, 4, 16):
        got = obj_io.sample_textures_from_image(image, uvs, res, 'cpu')
        want = JIO.sample_textures_from_image(image, uvs, res)
        assert tuple(got.shape) == (7, res * res, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(obj_io.texel_barycentrics(res),
                                      JIO.texel_barycentrics(res))


def test_load_mtl_equals_jax(tmp_path):
    path = tmp_path / 'm.mtl'
    path.write_text('newmtl a\nKd 0.1 0.2 0.3\nmap_Kd a.png\n\n'
                    'newmtl b\nKd 1 0 0\n')
    colors, files = obj_io.load_mtl(str(path))
    jcolors, jfiles = JIO.load_mtl(str(path))
    assert files == jfiles == {'a': 'a.png'}
    assert colors.keys() == jcolors.keys()
    for k in colors:
        np.testing.assert_array_equal(colors[k], jcolors[k])


def test_missing_material_library_is_an_error(tmp_path):
    path = tmp_path / 'plain.obj'
    path.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    with pytest.raises(Exception, match='textures'):
        obj_io.load_obj(str(path), load_texture=True, device='cpu')
    with pytest.raises(Exception, match='vertex colors'):
        obj_io.load_obj(str(path), load_texture=True, texture_type='vertex',
                        device='cpu')


# -- the PNG reader --------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _encode_png(arr, colour, filters):
    """A PNG of uint8 arr [H, W] or [H, W, C] whose row y is filtered with
    filters[y % len(filters)], written byte by byte from the PNG
    specification (independent of the port's reader)."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(int)
    bpp = rows.shape[1] // w
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        raw.append(kind)
        for x in range(rows.shape[1]):
            a = rows[y, x - bpp] if x >= bpp else 0
            b = rows[y - 1, x] if y else 0
            c = rows[y - 1, x - bpp] if y and x >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            raw.append((rows[y, x] - pred) % 256)
    chunk = png._png_chunk
    half = len(raw) // 2
    data_ = zlib.compress(bytes(raw))
    return (png.SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, colour, 0, 0,
                                         0))
            + chunk(b'tEXt', b'Comment\0made by a test')
            + chunk(b'IDAT', data_[:half]) + chunk(b'IDAT', data_[half:])
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('filters', [[0], [1], [2], [3], [4],
                                     [4, 1, 3, 2, 0]])
@pytest.mark.parametrize('colour,channels', [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_read_png_colour_types_and_filters(tmp_path, colour, channels,
                                           filters):
    rng = np.random.RandomState(colour * 10 + filters[0])
    arr = rng.randint(0, 256, (7, 5, channels)).astype(np.uint8)
    if channels == 1:
        arr = arr[:, :, 0]
    path = tmp_path / 'x.png'
    path.write_bytes(_encode_png(arr, colour, filters))
    got = png.read_png(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, arr)
    import imageio.v2 as imageio
    np.testing.assert_array_equal(got, imageio.imread(str(path)))
    # as a texture: float RGB in [0, 1], alpha dropped, grey repeated
    img = obj_io._read_image(str(path))
    assert img.shape == (7, 5, 3) and img.dtype == np.float32
    rgb = arr[..., None].repeat(3, -1) if channels == 1 \
        else arr[..., :1].repeat(3, -1) if channels == 2 else arr[..., :3]
    np.testing.assert_array_equal(img, rgb.astype(np.float32) / 255.0)


def test_read_png_reads_the_writer_and_refuses_the_rest(tmp_path):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (33, 20, 3)).astype(np.uint8)
    path = str(tmp_path / 'sub' / 'w.png')
    png.save_png(path, arr)                    # makes the directory
    np.testing.assert_array_equal(png.read_png(path), arr)
    from gendr_tpu_torch.animations import common as TA
    assert TA.save_png is png.save_png  # the sweeps' writer is this one
    with pytest.raises(ValueError, match='RGB'):
        png.save_png(path, arr[:, :, :1])
    blob = open(path, 'rb').read()
    bad = tmp_path / 'bad.png'
    bad.write_bytes(b'JFIF' + blob[4:])
    with pytest.raises(ValueError, match='not a PNG'):
        png.read_png(str(bad))
    bad.write_bytes(blob[:40] + bytes([blob[40] ^ 1]) + blob[41:])
    with pytest.raises(ValueError, match='checksum'):
        png.read_png(str(bad))
    # 16-bit and interlaced files are refused by name
    for depth, interlace in ((16, 0), (8, 1)):
        hdr = struct.pack('>IIBBBBB', 1, 1, depth, 2, 0, 0, interlace)
        bad.write_bytes(png.SIGNATURE + png._png_chunk(b'IHDR', hdr)
                        + png._png_chunk(b'IDAT', zlib.compress(b'\0' * 7))
                        + png._png_chunk(b'IEND', b''))
        with pytest.raises(ValueError, match='interlace'):
            png.read_png(str(bad))


# -- the loaders that feed the experiments and the sweeps ----------------------------

def test_panda_obj_and_load_or_make_mesh_read_a_written_obj(tmp_path,
                                                           monkeypatch):
    """save_obj of the procedural stand-in at texture_res 4, then the
    file through GENDR_PANDA_OBJ, experiments' load_or_make_mesh,
    Mesh.from_obj and interop, against the JAX package on the same file."""
    from gendr_tpu_torch import data as tdata
    from gendr_tpu_torch.animations import common as TA
    from gendr_tpu_torch.experiments.common import load_or_make_mesh
    v, f, tex = tdata.textured_scene(4)
    path = str(tmp_path / 'panda.obj')
    obj_io.save_obj(path, v, f, tex[0], texture_res=4)
    jv, jf, jtex = JIO.load_obj(path, normalization=True, load_texture=True,
                                texture_res=4)

    monkeypatch.setenv('GENDR_PANDA_OBJ', path)
    mesh = TA.textured_scene(4, 'cpu')
    assert mesh.texture_res == 4 and mesh.texture_type == 'surface'
    assert tuple(mesh.textures.shape) == (1, 1280, 16, 3)
    np.testing.assert_array_equal(mesh.vertices[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mesh.faces[0].numpy(), np.asarray(jf))
    np.testing.assert_allclose(mesh.textures[0].numpy(), np.asarray(jtex),
                               atol=1e-6)
    carried = interop.mesh_from_numpy(np.asarray(jv), np.asarray(jf),
                                      np.asarray(jtex), device='cpu')
    assert carried.texture_res == 4 and carried.batch_size == 1
    np.testing.assert_allclose(carried.face_textures.numpy(),
                               mesh.face_textures.numpy(), atol=1e-6)
    np.testing.assert_array_equal(carried.face_vertices.numpy(),
                                  mesh.face_vertices.numpy())

    lv, lf = load_or_make_mesh(path)
    assert lv.shape == (642, 3) and lf.shape == (1280, 3)
    np.testing.assert_allclose(lv, v, atol=1e-6)
    np.testing.assert_array_equal(lf, f)
