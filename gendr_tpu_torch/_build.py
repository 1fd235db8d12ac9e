"""Builds the CUDA kernels in ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build_cache/lib<name>_<hash>.so``,
where the hash covers the source and the flags, so an edited source builds
anew and an unchanged one loads at once.  The library is loaded with
ctypes; its functions take raw device pointers and the CUDA stream as
``c_void_p`` and ints as ``c_int``.  Nothing here runs at import time: the
CPU tests import every module on machines with neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / 'csrc'
CACHE = PKG / '_build_cache'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each library's C functions, by library name
SIGNATURES = {
    'rasterize_fwd': {
        # tile_counts tile_ids kcap par packed perm out B NI Fp FC
        # image_size dist_func dist_squared alpha_func hard_rgb double_side
        # device stream
        'gendr_rasterize_fwd': ((_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P), _I),
        'gendr_error_string': ((_I,), ctypes.c_char_p),
    },
}

# the ptxas report (registers, shared memory, spills) of each build made by
# this process, by library name
BUILD_LOG = {}


def _nvcc():
    path = shutil.which('nvcc')
    if path is None:
        cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        path = os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA '
            'kernels of gendr_tpu_torch are built at first use and need the '
            'CUDA toolkit')
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return CACHE / f'lib{name}_{digest}.so'


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already cached."""
    out = library_path(name)
    if out.exists():
        return out
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                           f'{name}:\n{proc.stdout}\n{proc.stderr}')
    BUILD_LOG[name] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library csrc/<name>.cu with its argtypes set."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
