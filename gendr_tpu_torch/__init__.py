"""gendr_tpu_torch — the PyTorch / CUDA port of gendr_tpu.

A generalized differentiable renderer (Felix-Petersen/gendr, CVPR 2022):
soft mesh rasterization whose per-pixel occlusion test is the CDF of any of
18 distributions and whose per-pixel coverage is aggregated by a t-conorm.
This package is the port of the JAX package ``gendr_tpu`` to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper; ``gendr_tpu`` stays the
reference it is tested against.  It covers the render, its gradient and
the silhouette shape optimizer (``experiments.opt_shape``) so far; see
ROADMAP.md for what is still to come.
"""

import torch

# float32 throughout: a TF32 matmul (the camera transform's einsum on the
# card) or convolution keeps ~3 decimal digits, which is what cost the JAX
# package its camera experiment on the TPU.  Both switches are global.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from gendr_tpu_torch.config import RenderConfig, RenderParams  # noqa: E402,F401
from gendr_tpu_torch.geometry.mesh import Mesh  # noqa: E402,F401
from gendr_tpu_torch.geometry.transforms import LookAt  # noqa: E402,F401
from gendr_tpu_torch.geometry.lighting import (  # noqa: E402,F401
    AmbientLighting, DirectionalLighting, Lighting)
from gendr_tpu_torch.raster.render import render  # noqa: E402,F401
from gendr_tpu_torch.renderer import GenDR  # noqa: E402,F401

__version__ = '0.1.0'
