"""Builds the CUDA kernels in ``csrc/`` and the host library in
``native/`` at first use and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build_cache/lib<name>_<hash>.so``,
where the hash covers the source, every header of ``csrc/`` (the kernels
share their device code through ``csrc/*.cuh``) and the flags, so an
edited source or header builds anew and an unchanged one loads at once.
The ptxas report of each build (registers, shared memory and spills of
every kernel instantiation) is kept beside the library as
``lib<name>_<hash>.ptxas.txt``, so whichever process built it, every later
one can read it (``BUILD_LOG``).  The library is loaded with
ctypes; its functions take raw device pointers and the CUDA stream as
``c_void_p`` and ints as ``c_int``.  Nothing here runs at import time: the
CPU tests import every module on machines with neither nvcc nor a card.

``native/<name>.cpp`` (the OBJ tokenizer) is host code: ``build_native``
compiles it with ``g++`` into the same cache, named by a hash of its source
and flags.
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
NATIVE = PKG / 'native'
CACHE = PKG / '_build_cache'

# --fmad=false: no multiply-add contraction, so each product and sum rounds
# on its own as in the plain PyTorch versions, and the pair math the forward
# and backward kernels share (csrc/pairmath.cuh) rounds the same in both
# whatever each kernel's surroundings (the max t-conorm's gradient finds its
# winner by exact float equality with the forward's coverage).  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W, flagship scene: with contraction the
# max case's gradient agrees with its plain version on 97.8 % of entries,
# below the 99 % gate, and the other cases on 99.95-99.98 %; without, on
# 100 % everywhere, for about 0.01 ms on the forward kernel's 0.19 ms and
# 0.1 ms on the backward's 3 ms
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each library's C functions, by library name
SIGNATURES = {
    'rasterize_fwd': {
        # tile_counts tile_ids kcap par packed perm out, then B NI Fp FC
        # image_size row0 height dist_func dist_squared alpha_func mode
        # double_side texture_type texture_res device, then stream
        'gendr_rasterize_fwd': ((_P, _P, _I, _P, _P, _P, _P) + (_I,) * 15
                                + (_P,), _I),
        'gendr_error_string': ((_I,), ctypes.c_char_p),
    },
    'rasterize_bwd': {
        # chunk_counts chunk_ids T par packed perm pix ws out, then B NI NO
        # Fp FC S k_sliced image_size row0 height dist_func dist_squared
        # alpha_func mode double_side texture_type texture_res device, then
        # stream and the host int that says whether rasterize_bwd_slab ran
        'gendr_rasterize_bwd': ((_P, _P, _I, _P, _P, _P, _P, _P, _P)
                                + (_I,) * 18 + (_P, _P), _I),
        'gendr_error_string': ((_I,), ctypes.c_char_p),
    },
    'prepass': {
        # fv tex fvalid par packed perm tile_counts tile_ids chunk_counts
        # chunk_ids, then B F Fp FC NI TS ntex image_size row0 height
        # device, then stream
        'gendr_prepass': ((_P,) * 10 + (_I,) * 11 + (_P,), _I),
        # the compacted prepass's three launches, each with B F Fp slabs
        # image_size row0 height device after its pointers, then stream:
        # fv perm; fv par perm oct_ids tile_live tile_counts tile_ids
        # chunk_counts chunk_ids; fv tex oct_ids tile_live perm packed, then
        # B F Fp NI TS ntex slabs image_size row0 height device
        'gendr_compact_sort': ((_P,) * 2 + (_I,) * 8 + (_P,), _I),
        'gendr_compact_plan': ((_P,) * 9 + (_I,) * 8 + (_P,), _I),
        'gendr_compact_pack': ((_P,) * 6 + (_I,) * 11 + (_P,), _I),
        'gendr_error_string': ((_I,), ctypes.c_char_p),
    },
    'ulp_probe': {
        # the case table on the host (and, for the parameter vector, on
        # the card), its cases, in n_in out n_out, device, stream
        'gendr_ulp_elementwise': ((_P, _I, _P, _I, _P, _I, _I, _P), _I),
        'gendr_ulp_param_vector': ((_P, _P, _I, _P, _I, _P, _I, _I, _P),
                                   _I),
        'gendr_error_string': ((_I,), ctypes.c_char_p),
    },
}

# the ptxas report (registers, shared memory, spills) of each library that
# build() was asked for, by library name: read from the file beside the
# cached library, whichever process built it
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
    """The cached library of csrc/<name>.cu: its name hashes the source,
    every csrc/*.cuh header (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + b'\0' + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return CACHE / f'lib{name}_{h.hexdigest()[:16]}.so'


def report_path(name: str) -> Path:
    """The ptxas report kept beside library_path(name)."""
    return library_path(name).with_suffix('.ptxas.txt')


def build(*names: str) -> list:
    """Compile csrc/<name>.cu for each name whose library is not cached yet,
    one nvcc process per source, all started together; returns the library
    paths."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        CACHE.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}) building '
                          f'{name}:\n{stdout}\n{stderr}')
            continue
        # the report first: whoever finds the library finds its report
        report_tmp = tmp.with_suffix('.txt')
        report_tmp.write_text(stderr)
        os.replace(report_tmp, report_path(name))
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError('\n'.join(failed))
    for name in names:
        report = report_path(name)
        BUILD_LOG[name] = report.read_text() if report.exists() else ''
    return [library_path(name) for name in names]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library csrc/<name>.cu with its argtypes set."""
    lib = ctypes.CDLL(str(build(name)[0]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def native_library_path(name: str) -> Path:
    """The cached library of native/<name>.cpp: its name hashes the source
    and the flags."""
    h = hashlib.sha256((NATIVE / f'{name}.cpp').read_bytes())
    h.update(' '.join(GXX_FLAGS).encode())
    return CACHE / f'lib{name}_{h.hexdigest()[:16]}.so'


def build_native(name: str) -> Path:
    """Compile native/<name>.cpp with g++ unless its library is cached;
    returns the library's path.  Raises FileNotFoundError where there is
    no g++, RuntimeError where the compiler fails."""
    out = native_library_path(name)
    if out.exists():
        return out
    gxx = shutil.which('g++')
    if gxx is None:
        raise FileNotFoundError('g++ not found on PATH')
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, '-o', str(tmp), str(NATIVE / f'{name}.cpp')],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed ({proc.returncode}) building {name}:'
                           f'\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out
