"""``correct`` comes out false when the timed path is broken underneath: a
step that leaves its state unchanged, or a loss over half of the batch
(the mean over the rest); and the camera's control, the reference computed
in bfloat16 in the program's place, fails a limit.  The reconstruction's
control (the reference with TF32 on) needs the card."""

import pytest

from benchmark import calibrate, run
from conftest import tiny_spec


@pytest.mark.parametrize('workload,fault', [
    ('camera.blur', 'frozen'), ('camera.blur', 'half_batch'),
    ('camera.sharp', 'frozen'), ('camera.sharp', 'half_batch'),
    ('recon.train', 'frozen'), ('recon.train', 'half_batch')])
def test_a_fault_is_not_correct(workload, fault):
    result, info = run.run_cell(tiny_spec(workload), 23, 0.2, 0,
                                device='cpu', fault=fault)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('workload', ('camera.blur', 'camera.sharp'))
def test_the_camera_control_fails(workload):
    spec = tiny_spec(workload)
    g, _, _, _ = calibrate.reading(spec, 29, 'control', 'cpu')
    assert any(g[k] > lim for k, lim in spec['limits'].items()), g


@pytest.mark.card
def test_the_reconstruction_control_fails(card):
    spec = tiny_spec('recon.train')
    g, _, _, _ = calibrate.reading(spec, 31, 'control', card)
    assert any(g[k] > lim for k, lim in spec['limits'].items()), g
