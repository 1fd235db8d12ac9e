"""Shared experiment utilities: losses, image grids, GIF writing, meshes.

Port of ``experiments/common.py`` (the helpers at the top of the reference
experiment scripts, experiments/opt_shape.py:20-47 there).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gendr_tpu_torch import data
from gendr_tpu_torch.geometry import obj_io


def iou_loss(predict, target, reduce='mean'):
    """1 - IoU per batch element (opt_shape.py:20-24 / opt_camera.py:18-22:
    the two scripts differ only in the final reduction)."""
    dims = tuple(range(1, predict.ndim))
    intersect = (predict * target).sum(dims)
    union = (predict + target - predict * target).sum(dims) + 1e-6
    per = 1.0 - intersect / union
    return per.mean() if reduce == 'mean' else per.sum()


def mse_loss(predict, target):
    return ((predict - target) ** 2).mean()


def make_grid(pred, target, grid_x, grid_y):
    """Tile predicted/target silhouettes side by side into a uint8 image
    (opt_shape.py:31-47)."""
    pred = np.asarray(torch.as_tensor(pred).detach().cpu())
    target = np.asarray(torch.as_tensor(target).detach().cpu())
    rows = []
    j = 0
    for _ in range(grid_y):
        row = []
        for _ in range(grid_x):
            row.append(pred[j])
            row.append(target[j])
            j += 1
        rows.append(np.concatenate(row, 1))
    img = np.concatenate(rows, 0)
    return (255 * np.clip(img, 0, 1)).astype(np.uint8)


def require_gif_support(prog):
    """Stop a command line that asks for --gif where imageio, an optional
    dependency, is not installed: before any step runs, not after them."""
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        raise SystemExit(f'{prog}: --gif writes its frames with imageio, '
                         f'which is not installed; install it or run '
                         f'without --gif') from None


class GifWriter:
    """Frames to a GIF file; imageio is imported only here (it is an
    optional dependency: see require_gif_support)."""

    def __init__(self, path):
        import imageio.v2 as imageio
        self.writer = imageio.get_writer(path, mode='I')

    def append(self, frame):
        self.writer.append_data(frame)

    def close(self):
        self.writer.close()


def load_or_make_mesh(model_obj, data_dir=None):
    """(vertices [nv, 3] float32, faces [nf, 3] int32) as numpy: the OBJ
    file model_obj, or the file of that name in data_dir, where one
    exists; else a procedural stand-in for the reference's binary assets,
    as the JAX package makes them: sphere_642/1352 regenerate by
    tessellation class, and any other missing asset (airplane, teapot)
    falls back to a cube.
    """
    name = os.path.basename(model_obj)
    candidates = [model_obj]
    if data_dir:
        candidates.append(os.path.join(data_dir, name))
    for path in candidates:
        if os.path.exists(path):
            vertices, faces = obj_io.load_obj(path, device='cpu')
            return vertices.numpy(), faces.numpy()
    if name.startswith('sphere_'):
        return data.sphere(int(name.split('_')[1].split('.')[0]))
    print(f'[gendr_tpu_torch] asset {model_obj} not found; using '
          f'procedural cube', file=sys.stderr)
    return data.test_meshes('cube')
