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

:func:`to_device` and :func:`as_float32` put numbers the host holds on the
card without the wait that a copy from pageable memory costs (PyTorch
synchronizes the stream after one), and :func:`as_float32` without any
copy at all, so a CUDA graph can capture the code that calls it.
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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A copy from host memory to the card goes
    through pinned memory and does not wait for the card; anything else is
    ``t.to(device)`` (``t`` itself where it is there already)."""
    device = torch.device(device)
    if device.type == 'cuda' and t.device.type == 'cpu':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def as_float32(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``.  A number, or a flat tuple or
    list of numbers, is made there by fills (each rounds to float32 as
    ``torch.as_tensor`` rounds it), with no copy from host memory; anything
    else (a tensor, an array) goes through ``torch.as_tensor``."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=torch.float32, device=device)
    if isinstance(v, (tuple, list)) and all(isinstance(x, (int, float))
                                            for x in v):
        out = torch.empty(len(v), dtype=torch.float32, device=device)
        for i, x in enumerate(v):
            out[i].fill_(x)
        return out
    return torch.as_tensor(v, dtype=torch.float32, device=device)
