"""Carrying state across from the JAX package.

The renderer has no learned weights: its state is the mesh, its textures
and the render parameters; the shape experiment adds its model's
parameters, the reconstruction experiment its encoder's and decoder's
weights and BatchNorm statistics.  These helpers take them as the JAX
package holds them, converted to numpy (``np.asarray`` of a
``gendr_tpu.Mesh``'s arrays, of a JAX render-params dict, or of a params
pytree), and build the port's counterparts, so both packages compute the
same thing.  Nothing here imports jax.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gendr_tpu_torch.device import resolve_device
from gendr_tpu_torch.geometry.mesh import Mesh


def mesh_from_numpy(vertices, faces, textures=None, texture_type='surface',
                    device=None) -> Mesh:
    """A port Mesh from numpy vertices [B, nv, 3], faces [B, nf, 3] and
    textures (surface [B, nf, TS, 3] or vertex [B, nv, 3]): a
    ``gendr_tpu.Mesh``'s arrays, or what the JAX package's ``load_obj``
    returns (unbatched: vertices [nv, 3], faces [nf, 3], textures
    [nf, texture_res^2, 3]), which becomes a batch of one.  The mesh's
    ``texture_res`` follows from the texel count, as in ``Mesh.from_obj``;
    it lies on ``device`` (None: the card, device.resolve_device)."""
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


def camera_poses_from_numpy(poses, device=None, requires_grad=False):
    """A pose batch of ``experiments/opt_camera.py`` (``poses_gt`` or the
    initial poses, numpy [B, 4]: distance, elevation, azimuth, field of
    view) -> the port's float32 tensor on ``device`` (None: the card,
    device.resolve_device); with requires_grad the leaf that
    ``CameraExperiment.train_step`` optimizes."""
    poses = np.array(poses, np.float32)
    if poses.ndim != 2 or poses.shape[1] != 4:
        raise ValueError(f'poses must be [B, 4], got {poses.shape}')
    return torch.tensor(poses, device=resolve_device(device),
                        requires_grad=requires_grad)


def reconstruction_params_from_jax(params: Dict, batch_stats: Dict):
    """The JAX ``experiments/train_reconstruction`` model (``params`` =
    {'enc': ..., 'dec': ...} and the encoder's ``batch_stats``, as numpy;
    a gradient pytree of the same structure converts too) -> (encoder
    state dict, decoder state dict) for the port's ``Encoder`` and
    ``Decoder``.  flax convolution kernels are HWIO (torch: OIHW), Dense
    kernels [in, out] (torch Linear: [out, in]), BatchNorm's scale / bias
    / mean / var are weight / bias / running_mean / running_var, and the
    first encoder Dense reads flax's NHWC flatten, (h, w, c), where the
    port's Linear reads the NCHW flatten, (c, h, w)."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    enc, dec = params['enc'], params['dec']
    encoder = {}
    for i in range(3):
        conv, bn = enc[f'Conv_{i}'], enc[f'BatchNorm_{i}']
        stats = batch_stats[f'BatchNorm_{i}']
        encoder[f'convs.{i}.weight'] = t(np.transpose(
            np.asarray(conv['kernel']), (3, 2, 0, 1)))
        encoder[f'convs.{i}.bias'] = t(conv['bias'])
        encoder[f'bns.{i}.weight'] = t(bn['scale'])
        encoder[f'bns.{i}.bias'] = t(bn['bias'])
        encoder[f'bns.{i}.running_mean'] = t(stats['mean'])
        encoder[f'bns.{i}.running_var'] = t(stats['var'])
    channels = np.asarray(enc['Conv_2']['kernel']).shape[3]
    for i in range(3):
        kernel = np.asarray(enc[f'Dense_{i}']['kernel'])
        if i == 0:
            side = int(round(np.sqrt(kernel.shape[0] // channels)))
            kernel = kernel.reshape(side, side, channels, -1) \
                .transpose(2, 0, 1, 3).reshape(kernel.shape[0], -1)
        encoder[f'fcs.{i}.weight'] = t(kernel.T)
        encoder[f'fcs.{i}.bias'] = t(enc[f'Dense_{i}']['bias'])
    decoder = {}
    for i, name in enumerate(('fc1', 'fc2', 'fc_centroid', 'fc_displace')):
        decoder[f'{name}.weight'] = t(np.asarray(
            dec[f'Dense_{i}']['kernel']).T)
        decoder[f'{name}.bias'] = t(dec[f'Dense_{i}']['bias'])
    return encoder, decoder
