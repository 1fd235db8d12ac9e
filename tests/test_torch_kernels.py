"""The CUDA forward kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without one.  The
file imports no jax, so it also runs where the JAX package is not
installed; from the repo root on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance: image max-abs 1e-4 and winner ids equal on >= 99.9 % of covered
pixels.  nvcc contracts multiply-adds into FMAs, which moves the affine
barycentric and distance values by an ulp, so a pixel within an ulp of a
shared edge can change its winner; the probabilistic product and the
einstein fold run in the same order in both.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CASES, flagship_cfg, flagship_scene
from gendr_tpu_torch import config as C, render
from gendr_tpu_torch.raster import cuda_backend as CB

IMG_ATOL = 1e-4
WINNER_AGREE = 0.999

# (shape, shift) of the distributions that take them
DIST_PARAMS = {14: (2.0, 0.1), 15: (2.0, 0.1), 16: (0.0, 0.1),
               17: (0.0, 0.1), 12: (0.0, 0.05), 13: (0.0, 0.05)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'False)')
    return 'cuda'


def _kernel_vs_plain(cfg, params, B, device, seed=0):
    fv, tex = flagship_scene(device, B, seed)
    aux = CB.prepass(fv, tex, cfg, params)
    args = (aux['tile_counts'], aux['tile_ids'], aux['par'], aux['packed'],
            aux['perm'], cfg)
    launches = CB.LAUNCHES['rasterize_fwd']
    got = CB.rasterize_fwd(*args)
    assert CB.LAUNCHES['rasterize_fwd'] == launches + 1
    want = CB.rasterize_fwd_plain(*args)
    torch.cuda.synchronize()
    soft_k, ag_k = CB._finalize_soa(got, cfg, params)
    soft_p, ag_p = CB._finalize_soa(want, cfg, params)
    assert float((soft_k - soft_p).abs().max()) <= IMG_ATOL
    if cfg.channels == 'rgba':
        covered = (ag_k[:, 1] >= 0) | (ag_p[:, 1] >= 0)
        assert int(covered.sum()) > 0
        agree = float((ag_k[:, 1] == ag_p[:, 1])[covered].float().mean())
        assert agree >= WINNER_AGREE


@pytest.mark.cuda
@pytest.mark.parametrize('name,kw,B,size', CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, kw, B, size):
    _kernel_vs_plain(flagship_cfg(size, **kw),
                     C.RenderParams(dist_scale=1e-2).as_dict(), B, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize('fid', range(18))
def test_kernel_cdf_zoo_matches_plain(cuda, fid):
    shape, shift = DIST_PARAMS.get(fid, (0.0, 0.0))
    for squared in (False, True):
        cfg = flagship_cfg(64, dist_func=fid, dist_squared=squared,
                           double_side=False)
        params = C.RenderParams(dist_scale=3e-2, dist_shape=shape,
                                dist_shift=shift, dist_eps=1e3).as_dict()
        _kernel_vs_plain(cfg, params, 1, cuda, seed=fid)


@pytest.mark.cuda
@pytest.mark.parametrize('size,face_chunk', [(17, 32), (40, 64), (64, 16)])
def test_kernel_small_and_ragged_sizes(cuda, size, face_chunk):
    cfg = flagship_cfg(size, face_chunk=face_chunk)
    _kernel_vs_plain(cfg, C.RenderParams(dist_scale=1e-2).as_dict(), 2,
                     cuda)


@pytest.mark.cuda
def test_render_on_cuda_launches_the_kernel_or_raises(cuda):
    fv, tex = flagship_scene(cuda)
    launches = CB.LAUNCHES['rasterize_fwd']
    img = render(fv, tex, image_size=64, aggr_rgb_func='hard')
    assert img.is_cuda and CB.LAUNCHES['rasterize_fwd'] == launches + 1
    with pytest.raises(ValueError, match='K1b'):
        render(fv, tex, image_size=64, aggr_rgb_func='softmax')
    with pytest.raises(ValueError, match='K1c'):
        render(fv, tex, image_size=64, aggr_rgb_func='hard',
               aggr_alpha_func='yager', aggr_alpha_t_conorm_p=2.0)
    ref = render(fv, tex, image_size=64, aggr_rgb_func='hard',
                 backend='torch')
    assert CB.LAUNCHES['rasterize_fwd'] == launches + 1
    assert float((img - ref).abs().max()) <= IMG_ATOL
