"""Carrying state across from the JAX package.

The renderer has no learned weights: its state is the mesh, its textures
and the render parameters; the shape experiment adds its model's
parameters.  These helpers take them as the JAX package holds them,
converted to numpy (``np.asarray`` of a ``gendr_tpu.Mesh``'s arrays, of a
JAX render-params dict, or of a params pytree), and build the port's
counterparts, so both packages compute the same thing.  Nothing here
imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gendr_tpu_torch.geometry.mesh import Mesh


def mesh_from_numpy(vertices, faces, textures=None, texture_type='surface',
                    device=None) -> Mesh:
    """A port Mesh from numpy vertices [B, nv, 3], faces [B, nf, 3] and
    textures (surface [B, nf, TS, 3] or vertex [B, nv, 3])."""
    return Mesh.create(np.array(vertices, np.float32),
                       np.array(faces, np.int32),
                       None if textures is None
                       else np.array(textures, np.float32),
                       texture_type=texture_type, device=device)


def params_from_jax(params: Dict) -> Dict:
    """A JAX render-params dict (its values as numpy, or anything
    ``np.asarray`` takes) -> the port's params dict: float32 CPU scalar
    tensors and a [3] background colour, the form the raster backends
    take (config.RenderParams.as_dict)."""
    return {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in params.items()}


def shape_params_from_jax(params: Dict) -> Dict:
    """The JAX ``experiments/opt_shape.ShapeModel`` params (``displace``
    [1, nv, 3], ``center`` [1, 1, 3], as numpy) -> a state dict for
    ``gendr_tpu_torch.experiments.opt_shape.ShapeModel.load_state_dict``
    (``strict=False``: the template's buffers stay the model's own)."""
    return {name: torch.tensor(np.asarray(params[name], np.float32))
            for name in ('displace', 'center')}
