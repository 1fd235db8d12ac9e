"""Shared setup for the animation sweeps.

Port of ``animations/common.py``: the canonical distribution and
t-conorm sweeps, the single-triangle and textured stand-in scenes,
compositing onto the reference's background and writing a PNG.  The PNG
writer (``gendr_tpu_torch.utils.png``, re-exported here) needs only the
standard library, so the sweeps run where neither imageio nor PIL is
installed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gendr_tpu_torch import data
from gendr_tpu_torch.geometry.mesh import Mesh
from gendr_tpu_torch.utils.png import save_png  # noqa: F401

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
    """A single triangle in view (triangles_dist.py's subject), on
    ``device`` (None: the card, device.resolve_device)."""
    verts = np.array([[-0.6, -0.5, 2.0], [0.7, -0.4, 2.5],
                      [0.0, 0.7, 3.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    return Mesh.create(verts, faces, device=device)


def textured_scene(texture_res=5, device=None) -> Mesh:
    """The textured panda: the OBJ file GENDR_PANDA_OBJ names (the
    reference's panda is an OBJ asset with an MTL and a texture image),
    loaded with texture_res^2 texels per face and normalized to the unit
    cube; without the variable, its procedural stand-in
    (data.textured_scene); on ``device`` (None: the card,
    device.resolve_device)."""
    path = os.environ.get('GENDR_PANDA_OBJ')
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f'GENDR_PANDA_OBJ={path!r} does not exist; unset it to '
                f'render the procedural stand-in')
        return Mesh.from_obj(path, normalization=True, load_texture=True,
                             texture_res=texture_res, texture_type='surface',
                             device=device)
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
