"""The plain reference agrees with the program at a tiny size on the CPU
(the program's plain torch backend there), through a whole run of each
cell's harness with the look for a chip skipped; the run holds nothing of
JAX."""

import pytest

from benchmark import run
from conftest import tiny_spec

CELLS = ('camera.blur', 'camera.sharp', 'recon.train')
# batch normalisation over the tiny size's 4 images, and Adam's first step
# moving every weight by lr whatever the sign's margin, make the
# reconstruction's gaps wider there than at the cell's batch of 64
TINY_RECON_LIMITS = dict(loss=1e-2, grad_q75=1e-3, change=0.05)


@pytest.mark.parametrize('workload', CELLS)
def test_reference_agrees(workload):
    spec = tiny_spec(workload)
    if workload == 'recon.train':
        spec['limits'] = TINY_RECON_LIMITS
    result, info = run.run_cell(spec, 2 ** 31 + 17, 0.2, 0, device='cpu')
    assert result['correct'], result['checks']
    assert run.forbidden_loaded() == []
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) == {m['name'] for m in
                                      run.load_spec(workload)['end_to_end']}


def test_a_traced_run_reports_the_cells_per_layer_metrics_it_can_read():
    result, info = run.run_cell(tiny_spec('camera.blur'), 5, 0.2, 1,
                                device='cpu')
    assert result['correct']
    # on the CPU the trace holds no device operation: the readers of the
    # device's numbers find nothing and leave their metrics out
    assert set(result['metrics']) == {'step_mfu'}
    assert result['device']['window_s'] > 0
    assert list(result)[-1] == 'checks'
