"""Shared setup for the animation sweeps.

Port of ``animations/common.py``: the canonical distribution and
t-conorm sweeps, the single-triangle and textured stand-in scenes,
compositing onto the reference's background and writing a PNG.  The PNG writer needs only the standard library (``zlib``
and ``struct``), so the sweeps run where neither imageio nor PIL is
installed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from gendr_tpu_torch import data
from gendr_tpu_torch.geometry.mesh import Mesh

# the reference's canonical distribution sweep (panda_dist.py:50-61)
SIGMOID_FUNCTIONS = [
    ('uniform', 0),
    ('gaussian', 0),
    ('logistic', 0),
    ('laplace', 0),
    ('cubic_hermite', 0),
    ('cauchy', 0),
    ('gamma', 2.),
    ('gamma', .5),
    ('gamma_rev', 2.),
    ('gamma_rev', .5),
]

# the canonical t-conorm sweep (panda_tcn.py:63-76)
T_CONORMS = [
    ('max', 0.),
    ('probabilistic', 0.),
    ('einstein', 0.),
    ('yager', .5), ('yager', 1.), ('yager', 2.), ('yager', 4.),
    ('aczel_alsina', .5), ('aczel_alsina', 1.), ('aczel_alsina', 2.),
    ('aczel_alsina', 4.),
]


def require_device(prog, device):
    """Stop a command line that asks for a CUDA device where there is
    none: no sweep falls back to the CPU on its own."""
    if device.startswith('cuda') and not torch.cuda.is_available():
        raise SystemExit(f'{prog}: --device cuda needs a CUDA device '
                         f'(torch.cuda.is_available() is False); pass '
                         f'--device cpu to render on the CPU')


def triangle_scene(device=None) -> Mesh:
    """A single triangle in view (triangles_dist.py's subject)."""
    verts = np.array([[-0.6, -0.5, 2.0], [0.7, -0.4, 2.5],
                      [0.0, 0.7, 3.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    return Mesh.create(verts, faces, device=device)


def textured_scene(texture_res=5, device=None) -> Mesh:
    """The textured panda's procedural stand-in (data.textured_scene) as a
    Mesh.  The reference's panda is an OBJ asset; GENDR_PANDA_OBJ, which
    names one for the JAX package, raises until the port reads OBJ files
    (ROADMAP.md Queue 1 item 10)."""
    path = os.environ.get('GENDR_PANDA_OBJ')
    if path:
        raise NotImplementedError(
            f'GENDR_PANDA_OBJ={path!r}: the port does not read OBJ files yet '
            f'(ROADMAP.md Queue 1 item 10); unset it to render the '
            f'procedural stand-in')
    v, f, tex = data.textured_scene(texture_res)
    return Mesh.create(v, f, tex, texture_res, 'surface', device=device)


def composite_on_background(images, bg=(66 / 255, 145 / 255, 0.0)):
    """Alpha-composite the first RGBA render of images [B, 4, H, W] onto
    the reference's green background (panda_dist.py:110): uint8 [H, W, 3]."""
    img = torch.as_tensor(images)[0].detach().float().cpu()
    rgb, a = img[:3], img[3:]
    bg = torch.tensor(bg, dtype=torch.float32).reshape(3, 1, 1)
    out = a * rgb + (1 - a) * bg
    return (255 * out.clamp(0, 1)).to(torch.uint8).permute(1, 2, 0).numpy()


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload) & 0xFFFFFFFF))


def save_png(path, arr):
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG (no filtering)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f'save_png writes RGB, got {c} channels')
    raw = b''.join(b'\x00' + arr[y].tobytes() for y in range(h))
    png = (b'\x89PNG\r\n\x1a\n'
           + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0,
                                             0))
           + _png_chunk(b'IDAT', zlib.compress(raw, 6))
           + _png_chunk(b'IEND', b''))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'wb') as fh:
        fh.write(png)
