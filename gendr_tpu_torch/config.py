"""Render configuration for the PyTorch port.

The name->id tables, guard constants and defaults are copies of
``gendr_tpu/config.py`` (importing that module would run
``gendr_tpu/__init__``, which imports jax); ``tests/test_torch_config.py``
holds the two copies equal.  They mirror the reference implementation
(``gendr/functional/renderer.py:44-83`` in Felix-Petersen/gendr).

:class:`RenderConfig` holds the discrete choices (which CDF, which
t-conorm, which RGB aggregation, which backend); :class:`RenderParams` the
continuous ones.  PyTorch runs eagerly, so the split no longer decides what
recompiles: it decides what the CUDA kernel takes as template arguments
(the alpha family, the RGB mode) and what it reads from its parameter
vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

# Distribution ("sigmoid") ids — reference: generalized_renderer_cuda_kernel.cu:217-239
HEAVISIDE = 0
UNIFORM = 1
CUBIC_HERMITE = 2
WIGNER_SEMICIRCLE = 3
GAUSSIAN = 4
LAPLACE = 5
LOGISTIC = 6
GUDERMANNIAN = 7
CAUCHY = 8
RECIPROCAL = 9
GUMBEL_MAX = 10
GUMBEL_MIN = 11
EXPONENTIAL = 12
EXPONENTIAL_REV = 13
GAMMA = 14
GAMMA_REV = 15
LEVY = 16
LEVY_REV = 17

DIST_FUNC_MAP = {
    'hard': 0, 'heaviside': 0,
    'uniform': 1,
    'cubic_hermite': 2,
    'wigner_semicircle': 3,
    'gaussian': 4,
    'laplace': 5,
    'logistic': 6,
    'gudermannian': 7, 'hyperbolic_secant': 7,
    'cauchy': 8,
    'reciprocal': 9,
    'gumbel_max': 10,
    'gumbel_min': 11,
    'exponential': 12,
    'exponential_rev': 13,
    'gamma': 14,
    'gamma_rev': 15,
    'levy': 16,
    'levy_rev': 17,
}

# T-conorm ids — reference: generalized_renderer_cuda_kernel.cu:462-470
# (0 is the "hard" alpha aggregation mode, not a t-conorm)
ALPHA_HARD = 0
MAX_TCN = 1
PROBABILISTIC_TCN = 2
EINSTEIN_TCN = 3
HAMACHER_TCN = 4
FRANK_TCN = 5
YAGER_TCN = 6
ACZEL_ALSINA_TCN = 7
DOMBI_TCN = 8
SCHWEIZER_SKLAR_TCN = 9

AGGR_ALPHA_FUNC_MAP = {
    'hard': 0,
    'max': 1,
    'probabilistic': 2,
    'einstein': 3,
    'hamacher': 4,
    'frank': 5,
    'yager': 6,
    'aczel_alsina': 7,
    'dombi': 8,
    'schweizer_sklar': 9,
}

# RGB aggregation — reference: functional/renderer.py:64-67
RGB_HARD = 0
RGB_SOFTMAX = 1
AGGR_RGB_FUNC_MAP = {
    'hard': 0,
    'softmax': 1,
}

# Texture types — reference: functional/renderer.py:80-83
TEXTURE_SURFACE = 0
TEXTURE_VERTEX = 1
TEXTURE_TYPE_MAP = {
    'surface': 0,
    'vertex': 1,
}

# Numerical guards — reference: generalized_renderer_cuda_kernel.cu:13-17
PROBABILITY_THRESHOLD = 1e-6
NUM_STEPS_GAMMA = 32
GAMMA_THRESHOLD = 15.0
DET_EPS = 1e-10

BACKENDS = ('torch', 'cuda')
CHANNELS = ('rgba', 'alpha')
COMPACT = ('auto', 'off')


def resolve(name_or_id: Union[str, int], table: dict) -> int:
    """Accept either a pre-mapped int id or a string name (reference quirk:
    functional/renderer.py:91-94 accepts both)."""
    if isinstance(name_or_id, str):
        return table[name_or_id]
    return int(name_or_id)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Discrete part of the renderer configuration.

    Mirrors the keyword surface of ``gendr.GenDR`` (reference:
    gendr/renderer.py:13-36) minus the continuous parameters, which travel
    in :class:`RenderParams`.  ``backend=None`` picks ``'cuda'`` for CUDA
    tensors and ``'torch'`` for CPU tensors at render time.
    """

    image_size: int = 256
    dist_func: int = UNIFORM
    dist_squared: bool = False
    aggr_alpha_func: int = PROBABILISTIC_TCN
    aggr_rgb_func: int = RGB_SOFTMAX
    double_side: bool = True
    texture_type: int = TEXTURE_SURFACE
    # 'cuda' (hand-written kernel), 'torch' (plain streaming scan, the
    # oracle the kernel is held against), or None (by tensor device)
    backend: Optional[str] = None
    # face-chunk size: the streaming scan's step, and the kernel's
    # shared-memory stage (one chunk of packed rows per load)
    face_chunk: int = 128
    # 'rgba' (reference semantics) or 'alpha' (silhouette-only: skips
    # depth/RGB work; RGB outputs are the background)
    channels: str = 'rgba'
    # per-tile face compaction ('auto' | 'off'), gendr_tpu's option: the
    # prepass of backend='cuda' gathers each 16x16 tile's hit faces, 8
    # Morton-consecutive faces (an octet) at a time, into 128-face chunks
    # of its own appended after the faces, and the tile lists only those;
    # the backward folds their gradients back onto the faces.  'auto' turns
    # it on where gendr_tpu's gate does (cuda_backend.compact_slabs: the
    # alpha modes hard, max, probabilistic and einstein, one render of all
    # faces, a density and size budget); 'off' never.  The image is the
    # same bits either way.
    compact: str = 'auto'

    @classmethod
    def create(cls, image_size=256, dist_func='uniform', dist_squared=False,
               aggr_alpha_func='probabilistic', aggr_rgb_func='softmax',
               double_side=True, texture_type='surface', backend=None,
               face_chunk=128, channels='rgba',
               compact='auto') -> 'RenderConfig':
        if backend is not None and backend not in BACKENDS:
            raise ValueError(f'backend must be one of {BACKENDS} or None, '
                             f'got {backend!r}')
        if channels not in CHANNELS:
            raise ValueError(f'channels must be one of {CHANNELS}, '
                             f'got {channels!r}')
        if compact not in COMPACT:
            raise ValueError(f'compact must be one of {COMPACT}, '
                             f'got {compact!r}')
        return cls(
            image_size=int(image_size),
            dist_func=resolve(dist_func, DIST_FUNC_MAP),
            dist_squared=bool(dist_squared),
            aggr_alpha_func=resolve(aggr_alpha_func, AGGR_ALPHA_FUNC_MAP),
            aggr_rgb_func=resolve(aggr_rgb_func, AGGR_RGB_FUNC_MAP),
            double_side=bool(double_side),
            texture_type=resolve(texture_type, TEXTURE_TYPE_MAP),
            backend=backend,
            face_chunk=int(face_chunk),
            channels=channels,
            compact=compact,
        )


@dataclasses.dataclass
class RenderParams:
    """Continuous render parameters.

    Defaults follow the reference (functional/renderer.py:18-38), with the
    ``None`` defaults for dist_shape/dist_shift/t_conorm_p normalized to 0.0
    (the reference forwards ``None`` into float-typed pybind args, which every
    in-repo caller avoids by passing numbers).
    """

    dist_scale: float = 1e-2
    dist_shape: float = 0.0
    dist_shift: float = 0.0
    dist_eps: float = 1e4
    aggr_alpha_t_conorm_p: float = 0.0
    aggr_rgb_eps: float = 1e-3
    aggr_rgb_gamma: float = 1e-3
    near: float = 1.0
    far: float = 100.0
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        if self.dist_shape is None:
            self.dist_shape = 0.0
        if self.dist_shift is None:
            self.dist_shift = 0.0
        if self.aggr_alpha_t_conorm_p is None:
            self.aggr_alpha_t_conorm_p = 0.0

    def as_dict(self) -> dict:
        """The params dict the raster backends take: float32 tensors, each
        number a scalar on the CPU (the arithmetic that derives the
        kernel's parameter vector, pairmath.params_vector, then rounds as
        the JAX package's does), a [3] background colour; a parameter
        given as a tensor stays on its device."""
        d = dataclasses.asdict(self)
        return {k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in d.items()}
