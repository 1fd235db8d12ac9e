"""Public render entry point.

Port of ``gendr_tpu/raster/render.py``: the same keywords and defaults as
the reference's functional ``render`` (functional/renderer.py:239-288),
and the same eager checks of ``dist_scale``, ``dist_eps`` and the
t-conorm parameter.  The render runs through a ``torch.autograd.Function``
(the JAX package's ``custom_vjp``): gradients flow to ``face_vertices``
and ``textures`` only, and the backward recomputes from the reference's
residuals (inputs, soft_colors, aggrs_info, functional/renderer.py:183)
plus the backend's prepass products, so it never re-sorts or re-packs.
With ``backend='cuda'`` the gradient comes from the backward kernel and
from nothing else.

The backends read the continuous parameters from one [16] float32 vector
on the inputs' device (``pairmath.params_vector``): derived on the host
and copied there once per render, or handed in as ``par``, which is how a
captured training step renders with the dist_scale that a static buffer
holds at each replay.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gendr_tpu_torch import config as C
from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.raster import cuda_backend, pairmath, torch_backend


def _get_backend(cfg: C.RenderConfig, face_vertices):
    backend = cfg.backend
    if backend is None:
        backend = 'cuda' if face_vertices.is_cuda else 'torch'
    return cuda_backend if backend == 'cuda' else torch_backend


class _Render(torch.autograd.Function):
    """soft_colors = render(face_vertices, textures); gradients flow to
    face_vertices and textures only."""

    @staticmethod
    def forward(ctx, face_vertices, textures, cfg, params):
        backend = _get_backend(cfg, face_vertices)
        soft_colors, aggrs_info, aux = backend.forward_with_aux(
            face_vertices, textures, cfg, params)
        ctx.save_for_backward(face_vertices, textures, soft_colors,
                              aggrs_info)
        ctx.backend, ctx.aux, ctx.cfg, ctx.params = backend, aux, cfg, \
            params
        return soft_colors

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_soft_colors):
        face_vertices, textures, soft_colors, aggrs_info = ctx.saved_tensors
        grad_faces, grad_textures = ctx.backend.backward_from_aux(
            face_vertices, textures, ctx.aux, soft_colors, aggrs_info,
            grad_soft_colors, ctx.cfg, ctx.params)
        return grad_faces, grad_textures, None, None


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
    compact='auto',
    par=None,
):
    """Generalized rasterization (forward).

    face_vertices: [B, F, 3, 3] or [B, F, 9]; textures: [B, F, TS, 3]
    (surface) or [B, F, 3, 3] (vertex colors gathered per face).
    Returns soft_colors [B, 4(RGBA), H, W] on the inputs' device.

    backend: 'cuda' (the hand-written kernels: every distribution, alpha
    and RGB mode and any square surface texture; raises for softmax RGB
    over more than 1024 texels per face), 'torch' (the plain streaming
    backend), or None ('cuda' for CUDA tensors, 'torch' for CPU tensors).

    compact: per-tile face compaction of backend='cuda', 'auto' (where
    gendr_tpu's gate turns it on) or 'off' (RenderConfig.compact).

    par: the [16] float32 parameter vector on the inputs' device to render
    with (``pairmath.params_vector`` of these keywords, whose continuous
    values it then stands for); None derives it here and copies it to the
    inputs' device.
    """
    cfg = checked_config(
        image_size=image_size, dist_func=dist_func, dist_scale=dist_scale,
        dist_squared=dist_squared, dist_eps=dist_eps,
        aggr_alpha_func=aggr_alpha_func,
        aggr_alpha_t_conorm_p=aggr_alpha_t_conorm_p,
        aggr_rgb_func=aggr_rgb_func, double_side=double_side,
        texture_type=texture_type, backend=backend, face_chunk=face_chunk,
        channels=channels, compact=compact)

    face_vertices = torch.as_tensor(face_vertices, dtype=torch.float32)
    if face_vertices.ndim == 4:
        face_vertices = face_vertices.reshape(
            face_vertices.shape[0], face_vertices.shape[1], 9)
    dev = face_vertices.device
    textures = torch.as_tensor(textures, dtype=torch.float32, device=dev)
    if par is None:
        host = pairmath.params_vector(C.RenderParams(
            dist_scale=dist_scale, dist_shape=dist_shape,
            dist_shift=dist_shift, dist_eps=dist_eps,
            aggr_alpha_t_conorm_p=aggr_alpha_t_conorm_p,
            aggr_rgb_eps=aggr_rgb_eps, aggr_rgb_gamma=aggr_rgb_gamma,
            near=near, far=far, background_color=background_color).as_dict(),
            cfg)
        params = pairmath.vector_params(to_device(host, dev), host)
    else:
        if tuple(par.shape) != (pairmath.NPAR,) or par.dtype != torch.float32 \
                or par.device != dev:
            raise ValueError(f'par must be a [{pairmath.NPAR}] float32 '
                             f'tensor on {dev}, got {tuple(par.shape)} '
                             f'{par.dtype} on {par.device}')
        params = pairmath.vector_params(par)
    return _Render.apply(face_vertices, textures, cfg, params)


def checked_config(*, image_size, dist_func, dist_scale, dist_squared,
                   dist_eps, aggr_alpha_func, aggr_alpha_t_conorm_p,
                   aggr_rgb_func, double_side, texture_type, backend,
                   face_chunk, channels, compact='auto'):
    """The RenderConfig of ``render``'s keywords, after its eager checks of
    the continuous ones given as numbers."""
    cfg = C.RenderConfig.create(
        image_size=image_size, dist_func=dist_func, dist_squared=dist_squared,
        aggr_alpha_func=aggr_alpha_func, aggr_rgb_func=aggr_rgb_func,
        double_side=double_side, texture_type=texture_type, backend=backend,
        face_chunk=face_chunk, channels=channels, compact=compact)

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
    return cfg


def render_config(*, image_size, background_color, dist_func, dist_scale,
                  dist_squared, dist_shape, dist_shift, dist_eps,
                  aggr_alpha_func, aggr_alpha_t_conorm_p, aggr_rgb_func,
                  aggr_rgb_eps, aggr_rgb_gamma, near, far, double_side,
                  texture_type, backend, face_chunk, channels,
                  compact='auto'):
    """(RenderConfig, params dict) of ``render``'s keywords, after its
    eager checks; what the backends' kernels and plain versions take."""
    cfg = checked_config(
        image_size=image_size, dist_func=dist_func, dist_scale=dist_scale,
        dist_squared=dist_squared, dist_eps=dist_eps,
        aggr_alpha_func=aggr_alpha_func,
        aggr_alpha_t_conorm_p=aggr_alpha_t_conorm_p,
        aggr_rgb_func=aggr_rgb_func, double_side=double_side,
        texture_type=texture_type, backend=backend, face_chunk=face_chunk,
        channels=channels, compact=compact)
    params = C.RenderParams(
        dist_scale=dist_scale, dist_shape=dist_shape, dist_shift=dist_shift,
        dist_eps=dist_eps, aggr_alpha_t_conorm_p=aggr_alpha_t_conorm_p,
        aggr_rgb_eps=aggr_rgb_eps, aggr_rgb_gamma=aggr_rgb_gamma, near=near,
        far=far, background_color=background_color).as_dict()
    return cfg, params
