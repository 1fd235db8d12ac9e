"""GenDR: the configured renderer module.

Port of ``gendr_tpu/renderer.py`` (API parity with the reference's
``gendr.GenDR`` nn.Module, gendr/renderer.py:12-125): the same constructor
keywords and defaults, a mutable ``dist_scale`` for tau-annealing loops,
2x supersampled anti-aliasing, and a raw-tensor ``forward_tensors``.
The JAX package's TPU tiling knobs (``pixel_tile``, ``on_fallback``) have
no counterpart: the CUDA kernel tiles by itself and never falls back.

The module keeps the parameter vector it last copied to a device and
copies it again only when its parameters change.  A training loop whose
step is captured as a CUDA graph renders with ``par``, a static buffer it
writes :meth:`GenDR.params_vector` rows into between replays.
"""

from __future__ import annotations

import torch
from torch import nn

from gendr_tpu_torch.device import to_device
from gendr_tpu_torch.raster import pairmath
from gendr_tpu_torch.raster.render import render, render_config


def _avg_pool2(images):
    """2x2 average pooling, stride 2, NCHW (renderer.py:92-93)."""
    b, c, h, w = images.shape
    return images.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


class GenDR(nn.Module):
    def __init__(self,
                 image_size=256,
                 background_color=(0, 0, 0),
                 anti_aliasing=False,
                 #
                 dist_func='uniform',
                 dist_scale=1e-2,
                 dist_squared=False,
                 dist_shape=None,
                 dist_shift=None,
                 dist_eps=1e4,
                 #
                 aggr_alpha_func='probabilistic',
                 aggr_alpha_t_conorm_p=None,
                 #
                 aggr_rgb_func='softmax',
                 aggr_rgb_eps=1e-3,
                 aggr_rgb_gamma=1e-3,
                 #
                 near=1,
                 far=100,
                 double_side=False,
                 texture_type='surface',
                 #
                 backend=None,
                 face_chunk=128,
                 channels='rgba',
                 ):
        super().__init__()
        if aggr_rgb_func not in ['hard', 'softmax', 0, 1]:
            raise ValueError(
                'Aggregate function (RGB) currently only supports hard and '
                'softmax.')
        if texture_type not in ['surface', 'vertex']:
            raise ValueError('Texture type only support surface and vertex.')

        self.image_size = image_size
        self.background_color = background_color
        self.anti_aliasing = anti_aliasing

        self.dist_func = dist_func
        self.dist_scale = dist_scale
        self.dist_squared = dist_squared
        self.dist_shape = dist_shape
        self.dist_shift = dist_shift
        self.dist_eps = dist_eps

        self.aggr_alpha_func = aggr_alpha_func
        self.aggr_alpha_t_conorm_p = aggr_alpha_t_conorm_p

        self.aggr_rgb_func = aggr_rgb_func
        self.aggr_rgb_eps = aggr_rgb_eps
        self.aggr_rgb_gamma = aggr_rgb_gamma

        self.near = near
        self.far = far
        self.double_side = double_side
        self.texture_type = texture_type

        self.backend = backend
        self.face_chunk = face_chunk
        self.channels = channels
        # (vector on the CPU, its copy on a device) of the last render
        self._par_copy = None

    def forward(self, mesh, par=None):
        return self.forward_tensors(mesh.face_vertices, mesh.face_textures,
                                    par)

    def forward_tensors(self, face_vertices, face_textures, par=None):
        """Render; ``par`` (a [16] float32 tensor on the inputs' device)
        stands for the continuous parameters, else this module's give the
        vector."""
        if par is None:
            par = self._device_vector(torch.as_tensor(face_vertices).device)
        images = render(face_vertices, face_textures, **self.render_kwargs(),
                        par=par)
        if self.anti_aliasing:
            images = _avg_pool2(images)
        return images

    def params_vector(self, **overrides):
        """pairmath.params_vector of this module's parameters, with
        ``overrides`` (render keywords, e.g. dist_scale) in place of some:
        [16] float32 on the CPU for numbers; a dist_scale of n values gives
        [n, 16], one row each."""
        cfg, params = render_config(**{**self.render_kwargs(), **overrides})
        return pairmath.params_vector(params, cfg)

    def _device_vector(self, device):
        """The parameter vector on ``device``: the last copy while the
        vector stays the same, else one new copy."""
        host = self.params_vector()
        if host.device == device:
            return host
        last = self._par_copy
        if last is not None and last[1].device == device \
                and torch.equal(last[0], host):
            return last[1]
        self._par_copy = (host, to_device(host, device))
        return self._par_copy[1]

    def render_kwargs(self):
        """The keywords this module passes to ``render``."""
        return dict(
            image_size=self.image_size * (2 if self.anti_aliasing else 1),
            background_color=self.background_color,
            dist_func=self.dist_func,
            dist_scale=self.dist_scale,
            dist_squared=self.dist_squared,
            dist_shape=self.dist_shape,
            dist_shift=self.dist_shift,
            dist_eps=self.dist_eps,
            aggr_alpha_func=self.aggr_alpha_func,
            aggr_alpha_t_conorm_p=self.aggr_alpha_t_conorm_p,
            aggr_rgb_func=self.aggr_rgb_func,
            aggr_rgb_eps=self.aggr_rgb_eps,
            aggr_rgb_gamma=self.aggr_rgb_gamma,
            near=self.near,
            far=self.far,
            double_side=self.double_side,
            texture_type=self.texture_type,
            backend=self.backend,
            face_chunk=self.face_chunk,
            channels=self.channels,
        )
