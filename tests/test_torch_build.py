"""The kernel build cache: a library's name hashes its source, the shared
headers it may include, and the flags.  No nvcc is needed."""

from gendr_tpu_torch import _build
from torch_threads import one_torch_thread  # noqa: F401


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    (tmp_path / 'k.cu').write_text('#include "shared.cuh"\n')
    header = tmp_path / 'shared.cuh'
    header.write_text('__device__ float f(float x) { return x; }\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    first = _build.library_path('k')
    assert _build.library_path('k') == first  # stable for unchanged files
    assert first.parent == _build.CACHE and first.name.startswith('libk_')

    header.write_text('__device__ float f(float x) { return 2 * x; }\n')
    edited = _build.library_path('k')
    assert edited != first

    (tmp_path / 'k.cu').write_text('#include "shared.cuh"\n// v2\n')
    assert _build.library_path('k') not in (first, edited)


def test_every_kernel_source_has_its_signatures():
    names = sorted(p.stem for p in _build.CSRC.glob('*.cu'))
    assert names == sorted(_build.SIGNATURES) == ['rasterize_bwd',
                                                    'rasterize_fwd',
                                                    'ulp_probe']
    assert (_build.CSRC / 'pairmath.cuh').exists()
    # pyproject.toml's patterns ship every source and name every subpackage
    import fnmatch
    import tomllib
    from setuptools import find_packages
    root = _build.PKG.parent
    cfg = tomllib.loads((root / 'pyproject.toml').read_text())['tool'][
        'setuptools']
    packages = find_packages(str(root),
                             include=cfg['packages']['find']['include'])
    assert {'gendr_tpu_torch.tools', 'gendr_tpu_torch.animations',
            'gendr_tpu_torch.native', 'gendr_tpu_torch.functional',
            'gendr_tpu_torch.utils'} <= set(packages)
    shipped = cfg['package-data']['gendr_tpu_torch']
    for path in _build.CSRC.iterdir():
        rel = f'csrc/{path.name}'
        assert any(fnmatch.fnmatch(rel, pat) for pat in shipped), rel
    # and the host tokenizer's source
    assert [p.name for p in _build.NATIVE.glob('*.cpp')] == ['objparse.cpp']
    assert any(fnmatch.fnmatch('native/objparse.cpp', pat)
               for pat in shipped)


def test_native_library_path_follows_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / 'tok.cpp').write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(_build, 'NATIVE', tmp_path)
    first = _build.native_library_path('tok')
    assert _build.native_library_path('tok') == first
    assert first.parent == _build.CACHE and first.name.startswith('libtok_')
    (tmp_path / 'tok.cpp').write_text('extern "C" int one() { return 2; }\n')
    edited = _build.native_library_path('tok')
    assert edited != first
    monkeypatch.setattr(_build, 'GXX_FLAGS', _build.GXX_FLAGS + ('-g',))
    assert _build.native_library_path('tok') not in (first, edited)


def test_build_native_builds_once_and_reports_failures(tmp_path, monkeypatch):
    import ctypes
    import shutil
    import pytest
    monkeypatch.setattr(_build, 'NATIVE', tmp_path)
    monkeypatch.setattr(_build, 'CACHE', tmp_path / 'cache')
    (tmp_path / 'tok.cpp').write_text('extern "C" int one() { return 1; }\n')
    (tmp_path / 'bad.cpp').write_text('this is not C++\n')
    if shutil.which('g++') is not None:
        lib = _build.build_native('tok')
        assert lib == _build.native_library_path('tok') and lib.exists()
        assert ctypes.CDLL(str(lib)).one() == 1
        stamp = lib.stat().st_mtime_ns
        assert _build.build_native('tok') == lib
        assert lib.stat().st_mtime_ns == stamp  # cached: not built again
        with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
            _build.build_native('bad')
        assert not list((tmp_path / 'cache').glob('libbad_*.so'))
    # no compiler: an error of its own kind, which the tokenizer's loader
    # turns into the Python parser
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    with pytest.raises(FileNotFoundError, match='g\\+\\+'):
        _build.build_native('bad')


def test_importing_the_port_builds_nothing(tmp_path):
    """Importing every module of the port (as test collection does) needs
    neither g++ nor nvcc and writes nothing: kernels and the tokenizer are
    built at first use."""
    import subprocess
    import sys
    code = (
        'import shutil, subprocess, importlib, pkgutil\n'
        'def boom(*a, **k): raise AssertionError("a build at import")\n'
        'shutil.which = lambda name: None\n'
        'subprocess.run = subprocess.Popen = boom\n'
        'import gendr_tpu_torch\n'
        'from gendr_tpu_torch import _build\n'
        'before = sorted(_build.CACHE.glob("*")) if _build.CACHE.exists() '
        'else []\n'
        'n = 0\n'
        'for m in pkgutil.walk_packages(gendr_tpu_torch.__path__, '
        '"gendr_tpu_torch."):\n'
        '    importlib.import_module(m.name); n += 1\n'
        'after = sorted(_build.CACHE.glob("*")) if _build.CACHE.exists() '
        'else []\n'
        'assert before == after\n'
        'print(n)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=str(_build.PKG.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 40


def test_ptxas_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    """build() writes nvcc's ptxas report next to the library it caches
    and BUILD_LOG reads it from there, so a process that finds the library
    already built still sees every instantiation's registers and spills."""
    import stat
    (tmp_path / 'csrc').mkdir()
    (tmp_path / 'csrc' / 'k.cu').write_text('// kernel\n')
    report = "ptxas info    : Used 42 registers, used 1 barriers\n"
    nvcc = tmp_path / 'nvcc'
    # a stand-in compiler: writes the -o target and reports on stderr
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'echo built > "$2"\nprintf \'{report}\' >&2\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, 'CSRC', tmp_path / 'csrc')
    monkeypatch.setattr(_build, 'CACHE', tmp_path / 'cache')
    monkeypatch.setattr(_build, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(_build, 'BUILD_LOG', {})
    lib, = _build.build('k')
    assert lib.read_text() == 'built\n'
    assert _build.report_path('k') == lib.with_suffix('.ptxas.txt')
    assert _build.report_path('k').read_text() == report
    assert _build.BUILD_LOG == {'k': report}
    # a second process: the library is cached, nvcc is not run again
    monkeypatch.setattr(_build, 'BUILD_LOG', {})
    monkeypatch.setattr(_build, '_nvcc', lambda: 1 / 0)
    assert _build.build('k') == [lib]
    assert _build.BUILD_LOG == {'k': report}
    assert sorted(p.name for p in (tmp_path / 'cache').iterdir()) \
        == sorted([lib.name, _build.report_path('k').name])


def test_device_t_conorm_ids_match_python():
    """csrc/pairmath.cuh's ids of the nine t-conorms equal config.py's, and
    the render kernels' ALPHA_PARAMETRIC template value is none of them."""
    import re
    from gendr_tpu_torch import config as C
    src = (_build.CSRC / 'pairmath.cuh').read_text()
    consts = {name: int(val) for name, val in
              re.findall(r'\b([A-Z][A-Z0-9_]*) = (\d+)\b', src)}
    for name in ('HAMACHER_TCN', 'FRANK_TCN', 'YAGER_TCN',
                 'ACZEL_ALSINA_TCN', 'DOMBI_TCN', 'SCHWEIZER_SKLAR_TCN'):
        assert consts[name] == getattr(C, name), name
    assert consts['ALPHA_PARAMETRIC'] not in C.AGGR_ALPHA_FUNC_MAP.values()
    for kernel in ('rasterize_fwd.cu', 'rasterize_bwd.cu'):
        text = (_build.CSRC / kernel).read_text()
        assert text.count('launch<ALPHA_PARAMETRIC, MODE>') == 1


def test_device_constants_match_python():
    """csrc/pairmath.cuh's slots, rows and ids equal the Python modules'
    (the kernels read the tensors those modules build)."""
    import re
    from gendr_tpu_torch import config as C
    from gendr_tpu_torch.raster import cuda_backend as CB, pack
    from gendr_tpu_torch.raster import pairmath as PM
    src = (_build.CSRC / 'pairmath.cuh').read_text()
    consts = {name: int(val) for name, val in
              re.findall(r'\b([A-Z][A-Z0-9_]*) = (\d+)\b', src)}
    want = {name: getattr(PM if name.startswith('P_') else pack, name)
            for name in consts if name.startswith(('P_', 'R_'))}
    assert len(want) >= 20
    assert {k: consts[k] for k in want} == want
    assert consts['NI_BASE'] == pack.NI_BASE
    assert consts['TILE'] == CB.TILE
    for name in ('HEAVISIDE', 'ALPHA_HARD', 'MAX_TCN', 'PROBABILISTIC_TCN',
                 'EINSTEIN_TCN', 'TEXTURE_SURFACE', 'TEXTURE_VERTEX'):
        assert consts[name] == getattr(C, name), name
    for name in ('MODE_ALPHA', 'MODE_HARD', 'MODE_SOFTMAX'):
        assert consts[name] == getattr(CB, name), name
    dists = re.search(r'enum \{\s*HEAVISIDE = 0, ([^}]*)\}', src).group(1)
    names = ['HEAVISIDE'] + [n.strip() for n in dists.split(',') if n.strip()]
    assert [getattr(C, n) for n in names] == list(range(18))
    bwd = (_build.CSRC / 'rasterize_bwd.cu').read_text()
    assert f'MAX_FC = {CB.MAX_BWD_CHUNK};' in bwd
    for name in ('PIX_GA', 'PIX_FA', 'PIX_GR', 'PIX_WID', 'PIX_FR',
                 'PIX_SSUM', 'PIX_SMAX'):
        assert f'{name} = {getattr(CB, name)}' in bwd, name
