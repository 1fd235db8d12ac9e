"""Public render entry point.

Port of ``gendr_tpu/raster/render.py``: the same keywords and defaults as
the reference's functional ``render`` (functional/renderer.py:239-288),
and the same eager checks of ``dist_scale``, ``dist_eps`` and the
t-conorm parameter.  The render runs through a ``torch.autograd.Function``
whose backward will launch the backward kernel; until that kernel is
ported the backward raises, so no plain-torch gradient ever stands in for
it on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.raster import cuda_backend, torch_backend


def _get_backend(cfg: C.RenderConfig, face_vertices):
    backend = cfg.backend
    if backend is None:
        backend = 'cuda' if face_vertices.is_cuda else 'torch'
    return cuda_backend if backend == 'cuda' else torch_backend


class _Render(torch.autograd.Function):
    """soft_colors = render(face_vertices, textures); gradients would flow
    to face_vertices and textures only."""

    @staticmethod
    def forward(ctx, face_vertices, textures, cfg, params):
        soft_colors, _ = _get_backend(cfg, face_vertices).forward(
            face_vertices, textures, cfg, params)
        return soft_colors

    @staticmethod
    def backward(ctx, grad_soft_colors):
        raise NotImplementedError(
            'gendr_tpu_torch renders forward only: the backward kernel '
            '(gendr_tpu/raster/pallas_backend.py:_bwd_kernel, sub-kernel '
            'K2a in ROADMAP.md) is not ported yet')


def _check_t_conorm_p(tid, p_val):
    # the reference kernels printf + emit NaN at runtime (cu:491-556)
    bad = ((tid == C.HAMACHER_TCN and p_val < 0)
           or (tid == C.FRANK_TCN and (p_val <= 0 or p_val == 1))
           or (tid in (C.YAGER_TCN, C.ACZEL_ALSINA_TCN, C.DOMBI_TCN)
               and p_val <= 0)
           or (tid == C.SCHWEIZER_SKLAR_TCN and p_val >= 0))
    if bad:
        raise ValueError(f'invalid t-conorm parameter p={p_val} for '
                         f'aggr_alpha_func id {tid}')


def render(
    face_vertices,
    textures,
    #
    image_size=256,
    background_color=(0, 0, 0),
    #
    dist_func: Union[str, int] = 'uniform',
    dist_scale=1e-2,
    dist_squared=False,
    dist_shape=None,
    dist_shift=None,
    dist_eps=1e4,
    #
    aggr_alpha_func: Union[str, int] = 'probabilistic',
    aggr_alpha_t_conorm_p=None,
    #
    aggr_rgb_func: Union[str, int] = 'softmax',
    aggr_rgb_eps=1e-3,
    aggr_rgb_gamma=1e-3,
    #
    near=1,
    far=100,
    double_side=True,
    texture_type='surface',
    #
    backend: Optional[str] = None,
    face_chunk=128,
    channels='rgba',
):
    """Generalized rasterization (forward).

    face_vertices: [B, F, 3, 3] or [B, F, 9]; textures: [B, F, TS, 3]
    (surface) or [B, F, 3, 3] (vertex colors gathered per face).
    Returns soft_colors [B, 4(RGBA), H, W] on the inputs' device.

    backend: 'cuda' (the hand-written kernel; raises for a configuration
    outside its envelope), 'torch' (the plain streaming backend), or None
    ('cuda' for CUDA tensors, 'torch' for CPU tensors).
    """
    cfg = C.RenderConfig.create(
        image_size=image_size, dist_func=dist_func, dist_squared=dist_squared,
        aggr_alpha_func=aggr_alpha_func, aggr_rgb_func=aggr_rgb_func,
        double_side=double_side, texture_type=texture_type, backend=backend,
        face_chunk=face_chunk, channels=channels)

    # dist_scale >= 0 and dist_eps >= 1 (functional/renderer.py:96, 101);
    # plain numbers are checked eagerly, tensors pass through
    if isinstance(dist_scale, (int, float)) and dist_scale < 0:
        raise ValueError(f'dist_scale must be >= 0, got {dist_scale}')
    if isinstance(dist_eps, (int, float)) and dist_eps < 1:
        raise ValueError(f'dist_eps must be >= 1, got {dist_eps}')
    if aggr_alpha_t_conorm_p is None or isinstance(aggr_alpha_t_conorm_p,
                                                    (int, float)):
        _check_t_conorm_p(cfg.aggr_alpha_func,
                          float(aggr_alpha_t_conorm_p or 0.0))

    face_vertices = torch.as_tensor(face_vertices, dtype=torch.float32)
    if face_vertices.ndim == 4:
        face_vertices = face_vertices.reshape(
            face_vertices.shape[0], face_vertices.shape[1], 9)
    textures = torch.as_tensor(textures, dtype=torch.float32,
                               device=face_vertices.device)

    params = C.RenderParams(
        dist_scale=dist_scale, dist_shape=dist_shape, dist_shift=dist_shift,
        dist_eps=dist_eps, aggr_alpha_t_conorm_p=aggr_alpha_t_conorm_p,
        aggr_rgb_eps=aggr_rgb_eps, aggr_rgb_gamma=aggr_rgb_gamma, near=near,
        far=far, background_color=background_color).as_dict()
    return _Render.apply(face_vertices, textures, cfg, params)
