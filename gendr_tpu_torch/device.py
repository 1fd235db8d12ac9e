"""Where the port's entry points put the tensors they make.

``gendr_tpu`` puts a new mesh on JAX's default device, the accelerator
where there is one.  The port's entry points (``Mesh.create``,
``Mesh.from_obj``, ``load_obj``, ``load_textures``,
``sample_textures_from_image``, ``interop.mesh_from_numpy``,
``interop.camera_poses_from_numpy``, the stand-in scenes of
``animations.common``) do the same through :func:`resolve_device`: a named
device wins, else the device of a tensor argument, else the card.  Without
a card they raise rather than carry on on the CPU, which would render
through ``backend='torch'`` without a word.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, *tensors) -> torch.device:
    """``device`` where the caller names one; else the device of the first
    of ``tensors`` that is a tensor; else ``'cuda'``.  Raises RuntimeError
    where that would be the card and there is none."""
    if device is not None:
        return torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): the port's "
            "entry points put new tensors on the card unless a device is "
            "named; pass device='cpu' to work on the CPU")
    return torch.device('cuda')
