"""The kernel build cache: a library's name hashes its source, the shared
headers it may include, and the flags.  No nvcc is needed."""

from gendr_tpu_torch import _build


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
                                                    'rasterize_fwd']
    assert (_build.CSRC / 'pairmath.cuh').exists()


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
