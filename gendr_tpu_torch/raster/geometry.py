"""Texel lookup for surface textures.

Port of ``surface_texel_index`` from ``gendr_tpu/raster/geometry.py``
(reference: generalized_renderer_cuda_kernel.cu:178-185).  The clipped
barycentrics it takes come from the pair math (pairmath.py, cu:67-72).
"""

from __future__ import annotations

import torch


def surface_texel_index(w_clip, R: int):
    """Texel index into the R x R folded-triangle texture grid
    (forward_sample_texture, cu:178-185).  Result clamped to [0, R^2-1]
    (the reference reads out of bounds when w hits an exact corner).

    Where w_clip[2] is 0 (a pixel beyond the edge opposite vertex 2, its
    barycentric clipped) w_clip[0] + w_clip[1] is 1, and the fold's test
    reads exactly 1 there: the lower triangle's texel, which the float sum's
    last bit would otherwise pick at random."""
    w_x = torch.floor(w_clip[0] * R).to(torch.int32)
    w_y = torch.floor(w_clip[1] * R).to(torch.int32)
    lower = (w_clip[2] == 0) | ((w_clip[0] + w_clip[1]) * R
                                - w_x.to(torch.float32)
                                - w_y.to(torch.float32) <= 1.0)
    idx = torch.where(lower, w_y * R + w_x,
                      (R - 1 - w_y) * R + (R - 1 - w_x))
    return torch.clamp(idx, 0, R * R - 1)
