"""Wavefront OBJ / MTL I/O and texture (un)baking.

Port of ``gendr_tpu/geometry/obj_io.py``, which replaces the reference's
CPU parsers (gendr/functional/load_obj.py, save_obj.py) and its two small
CUDA kernels:

* ``load_textures`` (load_textures_cuda_kernel.cu:14-72): bilinear sampling
  of the .mtl texture image at per-face-texel UV coordinates, here one
  vectorized torch gather on the device the caller names (the barycentric
  texel-centre and bilinear math is identical);
* ``create_texture_image`` (create_texture_image_cuda_kernel.cu:16-75):
  baking per-face textures into a tiled atlas for ``save_obj``, here numpy
  (save-time only).

Parsing uses the native C++ tokenizer of ``gendr_tpu_torch.native`` where
it can be built and a Python parser that computes the same elsewhere.
Texture images are PNG files, read and written with the standard library
(``gendr_tpu_torch.utils.png``).  ``load_obj`` returns torch tensors on the
card unless another ``device`` is named; the savers take tensors or numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gendr_tpu_torch.device import resolve_device
from gendr_tpu_torch.utils import png


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def _parse_obj_python(lines):
    """Parse v / f statements (load_obj.py:117-142 semantics: triangle-fan
    splitting of polygons, 1-based indices, optional texture indices)."""
    vertices = []
    faces = []
    tex_faces = []  # vt indices per face corner (0 where missing)
    vt = []
    vertex_colors = []
    mtllib = None
    face_materials = []
    material = ''
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == 'v':
            vertices.append([float(x) for x in parts[1:4]])
            if len(parts) >= 7:
                vertex_colors.append([float(x) for x in parts[4:7]])
        elif tag == 'vt':
            vt.append([float(x) for x in parts[1:3]])
        elif tag == 'f':
            vs = parts[1:]
            def vidx(tok):
                return int(tok.split('/')[0])
            def tidx(tok):
                if '/' in tok and '//' not in tok:
                    return int(tok.split('/')[1])
                return 0
            v0, t0 = vidx(vs[0]), tidx(vs[0])
            for i in range(len(vs) - 2):
                faces.append((v0, vidx(vs[i + 1]), vidx(vs[i + 2])))
                tex_faces.append((t0, tidx(vs[i + 1]), tidx(vs[i + 2])))
                face_materials.append(material)
        elif tag == 'usemtl':
            material = parts[1]
        elif tag == 'mtllib':
            mtllib = parts[1]
    return dict(
        vertices=np.array(vertices, np.float32),
        faces=np.array(faces, np.int32) - 1,
        tex_faces=np.array(tex_faces, np.int32) - 1,
        vt=np.array(vt, np.float32) if vt else np.zeros((0, 2), np.float32),
        vertex_colors=np.array(vertex_colors, np.float32)
        if vertex_colors else None,
        mtllib=mtllib,
        face_materials=face_materials,
    )


def parse_obj(filename_obj, parser=None):
    """Tokenize an OBJ file into numpy arrays (see _parse_obj_python).

    parser: 'native' (the C++ tokenizer; an error where it cannot be
    built), 'python', or None: native where there is a g++, else Python.
    An error raised while parsing is raised to the caller either way."""
    if parser not in (None, 'native', 'python'):
        raise ValueError(f"parser must be 'native', 'python' or None, got "
                         f'{parser!r}')
    with open(filename_obj) as f:
        lines = f.readlines()
    if parser != 'python':
        from gendr_tpu_torch.native import objparse
        parsed = objparse.parse_obj_native(''.join(lines))
        if parsed is not None:
            return parsed
        if parser == 'native':
            raise RuntimeError('the native OBJ tokenizer is not available '
                               '(no g++ to build it)')
    return _parse_obj_python(lines)


def load_mtl(filename_mtl):
    """Kd colors and map_Kd texture filenames (load_obj.py:14-30)."""
    texture_filenames = {}
    colors = {}
    material_name = ''
    with open(filename_mtl) as f:
        for line in f.readlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'newmtl':
                material_name = parts[1]
            elif parts[0] == 'map_Kd':
                texture_filenames[material_name] = parts[1]
            elif parts[0] == 'Kd':
                colors[material_name] = np.array(
                    [float(v) for v in parts[1:4]], np.float32)
    return colors, texture_filenames


def _read_image(path):
    """Read a PNG texture as float32 [H, W, 3] in [0, 1] (alpha dropped,
    greyscale repeated)."""
    img = png.read_png(path).astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 3 and img.shape[2] == 2:  # greyscale + alpha
        img = img[:, :, 0]
    if img.ndim == 2:
        img = np.stack((img,) * 3, -1)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


# ---------------------------------------------------------------------------
# Texture texel-grid sampling (replaces load_textures CUDA kernel)
# ---------------------------------------------------------------------------

def texel_barycentrics(texture_res):
    """Barycentric centers of the R x R texel grid folded into two triangles
    (load_textures_cuda_kernel.cu:33-41). Returns [R*R, 3]."""
    R = texture_res
    idx = np.arange(R * R)
    w_y = (idx // R).astype(np.float32)
    w_x = (idx % R).astype(np.float32)
    lower = (w_x + w_y) < R
    w0 = np.where(lower, (w_x + 1.0 / 3.0) / R,
                  ((R - 1.0 - w_x) + 2.0 / 3.0) / R)
    w1 = np.where(lower, (w_y + 1.0 / 3.0) / R,
                  ((R - 1.0 - w_y) + 2.0 / 3.0) / R)
    w2 = 1.0 - w0 - w1
    return np.stack([w0, w1, w2], axis=-1)


def sample_textures_from_image(image, face_uvs, texture_res, device=None):
    """Bilinear-sample per-face-texel colors from a texture image.

    image: [H, W, 3] (v=0 at the bottom, i.e. already flipped like the
    reference does with ``image[::-1]``, load_obj.py:102);
    face_uvs: [nf, 3, 2] UV coords per face corner; -> [nf, R^2, 3] float32
    tensor on ``device``.

    Bilinear weights match load_textures_cuda_kernel.cu:51-63 (truncation
    indexing); the +1 neighbours are clamped to the last row/column, which
    only differs for out-of-range UVs.  ``device=None``: the device of a
    tensor argument, else the card (device.resolve_device).
    """
    device = resolve_device(device, image, face_uvs)
    H, W = image.shape[:2]
    img = torch.as_tensor(np.ascontiguousarray(image), dtype=torch.float32,
                          device=device)
    bary = torch.as_tensor(texel_barycentrics(texture_res), device=device)
    uvs = torch.as_tensor(np.ascontiguousarray(face_uvs),
                          dtype=torch.float32, device=device)
    uv = torch.einsum('tk,fkc->ftc', bary, uvs)             # [nf, R2, 2]
    pos_x = uv[..., 0] * (W - 1)
    pos_y = uv[..., 1] * (H - 1)
    x0 = torch.floor(pos_x).long().clamp(0, W - 1)
    y0 = torch.floor(pos_y).long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx1 = pos_x - torch.floor(pos_x)
    wx0 = 1.0 - wx1
    wy1 = pos_y - torch.floor(pos_y)
    wy0 = 1.0 - wy1
    return (img[y0, x0] * (wx0 * wy0)[..., None]
            + img[y1, x0] * (wx0 * wy1)[..., None]
            + img[y0, x1] * (wx1 * wy0)[..., None]
            + img[y1, x1] * (wx1 * wy1)[..., None])


def load_textures(filename_obj, filename_mtl, texture_res, device=None,
                  parser=None):
    """Build [nf, R^2, 3] per-face textures from an OBJ+MTL pair
    (load_obj.py:33-106), a float32 tensor on ``device`` (None: the card,
    device.resolve_device)."""
    device = resolve_device(device)
    parsed = parse_obj(filename_obj, parser)
    vt = parsed['vt']
    tex_faces = np.maximum(parsed['tex_faces'], 0)
    face_uvs = vt[tex_faces] if len(vt) else np.zeros(
        (len(tex_faces), 3, 2), np.float32)
    # wrap UVs > 1 (load_obj.py:76)
    face_uvs = np.where(face_uvs > 1, face_uvs % 1, face_uvs)
    material_names = np.array(parsed['face_materials'], dtype=object)

    colors, texture_filenames = load_mtl(filename_mtl)

    nf = len(face_uvs)
    textures = torch.ones((nf, texture_res ** 2, 3), dtype=torch.float32,
                          device=device)
    for material_name, color in colors.items():
        sel = torch.as_tensor(material_names == material_name, device=device)
        textures[sel] = torch.as_tensor(color, device=device)

    for material_name, filename_texture in texture_filenames.items():
        sel = material_names == material_name
        if not sel.any():
            continue
        path = os.path.join(os.path.dirname(filename_obj), filename_texture)
        image = _read_image(path)[::-1]  # flip v axis (load_obj.py:102)
        textures[torch.as_tensor(sel, device=device)] = \
            sample_textures_from_image(image, face_uvs[sel], texture_res,
                                       device)
    return textures


def load_obj(filename_obj, normalization=False, load_texture=False,
             texture_res=4, texture_type='surface', device=None,
             parser=None):
    """Load a Wavefront .obj (load_obj.py:109-172): (vertices [nv, 3]
    float32, faces [nf, 3] int32) and, with load_texture, the textures
    ([nf, texture_res^2, 3] surface texels sampled from the .mtl's image,
    or [nv, 3] vertex colours), as tensors on ``device`` (None: the card,
    device.resolve_device; name ``'cpu'`` to load onto the CPU)."""
    assert texture_type in ['surface', 'vertex']
    device = resolve_device(device)
    parsed = parse_obj(filename_obj, parser)
    vertices = parsed['vertices']
    faces = parsed['faces']

    textures = None
    if load_texture and texture_type == 'surface':
        if parsed['mtllib'] is None:
            raise Exception('Failed to load textures.')
        filename_mtl = os.path.join(os.path.dirname(filename_obj),
                                    parsed['mtllib'])
        textures = load_textures(filename_obj, filename_mtl, texture_res,
                                 device, parser)
    elif load_texture and texture_type == 'vertex':
        if parsed['vertex_colors'] is None:
            raise Exception('Failed to load vertex colors.')
        textures = torch.as_tensor(parsed['vertex_colors'], device=device)

    if normalization:
        # unit-cube normalization (load_obj.py:162-167)
        vertices = vertices - vertices.min(0)[None, :]
        vertices = vertices / np.abs(vertices).max()
        vertices = vertices * 2
        vertices = vertices - vertices.max(0)[None, :] / 2

    vertices = torch.as_tensor(vertices, device=device)
    faces = torch.as_tensor(faces, device=device)
    if load_texture:
        return vertices, faces, textures
    return vertices, faces


# ---------------------------------------------------------------------------
# Saving (replaces create_texture_image CUDA kernel with numpy)
# ---------------------------------------------------------------------------

def create_texture_image(textures, texture_res=16):
    """Bake [nf, R_in^2, 3] per-face textures into a tiled atlas image +
    per-face UV vertices (functional/save_obj.py:13-40 and
    create_texture_image_cuda_kernel.cu:16-75)."""
    textures = _numpy(textures)
    num_faces = textures.shape[0]
    R_in = int(np.sqrt(textures.shape[1]))
    tile_width = int((num_faces - 1.0) ** 0.5) + 1
    tile_height = int((num_faces - 1.0) / tile_width) + 1
    image = np.ones((tile_height * texture_res, tile_width * texture_res, 3),
                    np.float32)
    vertices = np.zeros((num_faces, 3, 2), np.float32)
    face_nums = np.arange(num_faces)
    column = face_nums % tile_width
    row = face_nums // tile_width
    vertices[:, 0, 0] = column * texture_res + texture_res / 2.0
    vertices[:, 0, 1] = row * texture_res + 1
    vertices[:, 1, 0] = column * texture_res + 1
    vertices[:, 1, 1] = (row + 1) * texture_res - 1 - 1
    vertices[:, 2, 0] = (column + 1) * texture_res - 1 - 1
    vertices[:, 2, 1] = (row + 1) * texture_res - 1 - 1

    eps = 1e-5
    H, W = image.shape[:2]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    fn = (xs // texture_res) + (ys // texture_res) * tile_width
    valid = fn < num_faces
    fn_c = np.minimum(fn, num_faces - 1)

    p0, p1, p2 = vertices[fn_c, 0], vertices[fn_c, 1], vertices[fn_c, 2]
    det = (p2[..., 0] * (p0[..., 1] - p1[..., 1])
           + p0[..., 0] * (p1[..., 1] - p2[..., 1])
           + p1[..., 0] * (p2[..., 1] - p0[..., 1])) + eps
    w0 = ((p1[..., 1] - p2[..., 1]) * xs + (p2[..., 0] - p1[..., 0]) * ys
          + p1[..., 0] * p2[..., 1] - p2[..., 0] * p1[..., 1]) / det
    w1 = ((p2[..., 1] - p0[..., 1]) * xs + (p0[..., 0] - p2[..., 0]) * ys
          + p2[..., 0] * p0[..., 1] - p0[..., 0] * p2[..., 1]) / det
    w2 = ((p0[..., 1] - p1[..., 1]) * xs + (p1[..., 0] - p0[..., 0]) * ys
          + p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]) / det
    w = np.stack([w0, w1, w2], -1)
    w = np.clip(w, 0.0, 1.0)
    w = w / (w.sum(-1, keepdims=True) + eps)

    R = R_in
    w_x = (w[..., 0] * R).astype(np.int32)
    w_y = (w[..., 1] * R).astype(np.int32)
    lower = (w[..., 0] + w[..., 1]) * R - w_x - w_y <= 1
    texel = np.where(lower, w_y * R + w_x,
                     (R - 1 - w_y) * R + (R - 1 - w_x))
    texel = np.clip(texel, 0, R * R - 1)
    baked = textures[fn_c, texel]
    image = np.where(valid[..., None], baked, image)

    vertices[:, :, 0] /= (W - 1)
    vertices[:, :, 1] /= (H - 1)
    image = image[::-1, ::1]
    return image, vertices


def save_obj(filename, vertices, faces, textures=None, texture_res=16,
             texture_type='surface'):
    """Write an OBJ (+MTL+PNG when textured) (functional/save_obj.py:43-96)."""
    vertices = _numpy(vertices)
    faces = _numpy(faces)
    assert vertices.ndim == 2
    assert faces.ndim == 2
    assert texture_type in ['surface', 'vertex']

    filename_mtl = filename[:-4] + '.mtl'
    filename_texture = filename[:-4] + '.png'
    material_name = 'material_1'
    vertices_textures = None
    if textures is not None and texture_type == 'surface':
        assert texture_res >= 2
        texture_image, vertices_textures = create_texture_image(
            textures, texture_res)
        texture_image = (np.clip(texture_image, 0, 1) * 255).astype('uint8')
        png.save_png(filename_texture, texture_image)

    with open(filename, 'w') as f:
        f.write('# %s\n#\n\n' % os.path.basename(filename))
        if textures is not None:
            f.write('mtllib %s\n\n' % os.path.basename(filename_mtl))
        if textures is not None and texture_type == 'vertex':
            for vertex, color in zip(vertices, _numpy(textures)):
                f.write('v %.8f %.8f %.8f %.8f %.8f %.8f\n' % (
                    vertex[0], vertex[1], vertex[2],
                    color[0], color[1], color[2]))
            f.write('\n')
        else:
            for vertex in vertices:
                f.write('v %.8f %.8f %.8f\n' % (vertex[0], vertex[1],
                                                vertex[2]))
            f.write('\n')
        if textures is not None and texture_type == 'surface':
            for vertex in vertices_textures.reshape((-1, 2)):
                f.write('vt %.8f %.8f\n' % (vertex[0], vertex[1]))
            f.write('\n')
            f.write('usemtl %s\n' % material_name)
            for i, face in enumerate(faces):
                f.write('f %d/%d %d/%d %d/%d\n' % (
                    face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2,
                    face[2] + 1, 3 * i + 3))
            f.write('\n')
        else:
            for face in faces:
                f.write('f %d %d %d\n' % (face[0] + 1, face[1] + 1,
                                          face[2] + 1))

    if textures is not None and texture_type == 'surface':
        with open(filename_mtl, 'w') as f:
            f.write('newmtl %s\n' % material_name)
            f.write('map_Kd %s\n' % os.path.basename(filename_texture))


def save_voxel(filename, voxel):
    """Write occupied voxel centers as OBJ vertices
    (functional/save_obj.py:98-106)."""
    voxel = _numpy(voxel)
    idx = np.argwhere(voxel == 1)
    vertices = idx.astype(np.float32) / np.array(voxel.shape, np.float32)
    return save_obj(filename, vertices, np.zeros((0, 3), np.int32))
