"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests`` from the repository's root).  Tests that need the card
carry the ``card`` marker and skip without one, decided inside the
``card`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA device; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec(workload, **traffic):
    """The cell's spec at a size a CPU test holds: the camera at 4 poses of
    16x16 on the level-1 stand-in, the reconstruction at batch 2
    (ShapeNet's 64x64) on one object of each of two classes."""
    from benchmark import run
    spec = run.load_spec(workload)
    cfg = spec['cfg']
    if cfg['driver'] == 'camera':
        cfg.update(batch_size=4, image_size=16)
        cfg['mesh']['level'] = 1
    else:
        cfg.update(batch_size=2, image_size=64, objects=1,
                   classes=cfg['classes'][:2])
    spec['traffic'].update(trace_steps=2, **traffic)
    return spec
