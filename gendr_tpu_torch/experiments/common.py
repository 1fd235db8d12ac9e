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


class GifWriter:
    """Frames to a GIF file; imageio is imported only here (it is an
    optional dependency)."""

    def __init__(self, path):
        import imageio.v2 as imageio
        self.writer = imageio.get_writer(path, mode='I')

    def append(self, frame):
        self.writer.append_data(frame)

    def close(self):
        self.writer.close()


def load_or_make_mesh(model_obj, data_dir=None):
    """(vertices [nv, 3] float32, faces [nf, 3] int32) as numpy.

    Procedural stand-ins for the reference's binary assets, as the JAX
    package makes them: sphere_642/1352 regenerate by tessellation class,
    and any other missing asset (airplane, teapot) falls back to a cube.
    Reading an OBJ file that does exist is not ported yet.
    """
    name = os.path.basename(model_obj)
    candidates = [model_obj]
    if data_dir:
        candidates.append(os.path.join(data_dir, name))
    for path in candidates:
        if os.path.exists(path):
            raise NotImplementedError(
                f'{path} exists, but OBJ loading is not ported to '
                'gendr_tpu_torch yet (ROADMAP.md Queue 1 item 10, '
                'geometry/obj_io.py)')
    if name.startswith('sphere_'):
        return data.sphere(int(name.split('_')[1].split('.')[0]))
    print(f'[gendr_tpu_torch] asset {model_obj} not found; using '
          f'procedural cube', file=sys.stderr)
    return data.test_meshes('cube')
