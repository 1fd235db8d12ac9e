"""The compacted camera cell, camera.sharp128, through a whole run of the
harness at a tiny size on the CPU.  The cell's program path is per-tile
face compaction, which only the kernels' path takes (``backend='cuda'``,
whose plain versions run on CPU tensors); the CPU's default backend is the
plain torch renderer, so the experiment's renderers are built with
``backend='cuda'`` here.  At 4 poses of 32x32 on the level-1 stand-in (80
faces in one chunk of 128 over 4 tiles) compaction is on, as it is at the
cell's 128x128 on the 1280-face stand-in."""

import pytest

from benchmark import run
from gendr_tpu_torch.experiments import opt_camera as OC
from gendr_tpu_torch.raster import pack

CELL = 'camera.sharp128'


def tiny_spec():
    spec = run.load_spec(CELL)
    cfg = spec['cfg']
    cfg.update(batch_size=4, image_size=32)
    cfg['mesh']['level'] = 1
    spec['traffic'].update(trace_steps=2, chain=3)
    return spec


@pytest.fixture
def kernels_path(monkeypatch):
    """The experiment's renderers on the kernels' path; the compaction
    plans made."""
    build = OC.build_renderers
    monkeypatch.setattr(OC, 'build_renderers',
                        lambda args, backend=None: build(args, 'cuda'))
    plans = []
    whole = pack.compact_plan

    def plan(*a, **k):
        plans.append(1)
        return whole(*a, **k)
    monkeypatch.setattr(pack, 'compact_plan', plan)
    return plans


def test_the_compacted_cell_agrees_with_the_reference(kernels_path):
    result, _ = run.run_cell(tiny_spec(), 2 ** 31 + 29, 0.2, 0,
                             device='cpu')
    assert kernels_path, 'no compaction plan was made'
    assert result['correct'], result['checks']
    assert run.forbidden_loaded() == []
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) == {'step_ms.sharp', 'setup_s'}
    assert set(result['checks']) == {'loss_timed_gap', 'loss_gap',
                                     'grad_gap', 'change_gap',
                                     'nonfinite_steps'}
