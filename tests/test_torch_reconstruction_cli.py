"""The reconstruction experiment's command line on the CPU: checkpoint
resume, --data-parallel and --quick (the model, the loss and the step
against the JAX experiment: tests/test_torch_reconstruction.py, whose
sizes these runs share).

Tolerances: a resumed run bitwise; the dp step within 1e-5 norm-relative
of the one-process step.
"""

import os

import numpy as np
import pytest
import torch

from gendr_tpu_torch.experiments import train_reconstruction as TR
from tests.test_torch_reconstruction import BATCH, SIZE, _rel
from torch_threads import one_torch_thread  # noqa: F401


def _cli(*extra):
    """A tiny full-width run on the CPU: one synthetic object, 16x16,
    batch 2, one evaluation batch."""
    return ['--synthetic', '--class_ids', 'syn_ellipsoid',
            '--synthetic-objects', '1', '--image_size', str(SIZE),
            '--batch_size', str(BATCH), '--print_freq', '100',
            '--max-eval-batches', '1', '--device', 'cpu', *extra]


def _load(directory):
    paths = TR._checkpoints(directory)
    return paths, torch.load(paths[-1], weights_only=True)


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_states_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms while a test drives the CLI,
    beside the module's one intra-op thread (tests/torch_threads.py):
    on the CPU two runs of the same steps otherwise differ in the last
    bits from the second step on (threaded accumulations in the
    backward)."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_checkpoint_resume_is_bitwise(tmp_path, deterministic):
    """4 steps with a checkpoint at each, against 2 steps, then a restart
    to 4 from the checkpoint at 2: the same losses and bitwise the same
    model, BatchNorm statistics, Adam state and batch stream; each run
    keeps its last 3 checkpoints."""
    whole, part = str(tmp_path / 'whole'), str(tmp_path / 'part')
    run = _cli('--eval_freq', '1')
    full = TR.main(run + ['-ni', '4', '--checkpoint-dir', whole])
    first = TR.main(run + ['-ni', '2', '--checkpoint-dir', part])
    assert [os.path.basename(p) for p in TR._checkpoints(part)] == \
        ['ckpt_000000001.pt', 'ckpt_000000002.pt']
    rest = TR.main(run + ['-ni', '4', '--checkpoint-dir', part])
    assert len(full['losses']) == 4 and len(rest['losses']) == 2
    assert first['losses'] + rest['losses'] == full['losses']
    for d in (whole, part):
        assert [os.path.basename(p) for p in TR._checkpoints(d)] == \
            [f'ckpt_00000000{i}.pt' for i in (2, 3, 4)]
    _, want = _load(whole)
    _, got = _load(part)
    assert want['iteration'] == got['iteration'] == 4
    _assert_states_equal(got, want)
    assert rest['mean_iou'] == full['mean_iou']


def test_data_parallel_step_matches_one_process(tmp_path, deterministic,
                                                monkeypatch):
    """--data-parallel 2 (two gloo ranks on the CPU, spawned through
    parallel.sharding) against one process, from the checkpoint each saves
    after its first step: the loss and the BatchNorm statistics (which
    need the moments of the whole batch) to rtol 1e-5; the parameters over
    the whole model norm-relative within 1e-5 (Adam's first step is about
    lr times the gradient's sign, so an entry whose gradient is near 0
    may step either way); the gradient, Adam's first moment, per tensor
    within 1e-3 norm-relative: reordering the batch in one process
    (BatchNorm's sums in another order) moves it by about 1e-4, while a
    gradient not averaged over the ranks would be off by a factor 2.
    The spawned ranks start with torch's default thread count, read from
    OMP_NUM_THREADS: one thread each, as in this process."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    one, two = str(tmp_path / 'one'), str(tmp_path / 'two')
    run = _cli('-ni', '1', '--eval_freq', '1')
    single = TR.main(run + ['--checkpoint-dir', one])
    dp = TR.main(run + ['--checkpoint-dir', two, '--data-parallel', '2'])
    np.testing.assert_allclose(dp['losses'], single['losses'], rtol=1e-5)
    assert len(dp['collective_seconds']) == 2
    assert all(s > 0 for s in dp['collective_seconds'])
    _, want = _load(one)
    _, got = _load(two)
    flat = {}
    for name, ckpt in (('got', got), ('want', want)):
        flat[name] = np.concatenate([
            v.numpy().reshape(-1) for part in ('encoder', 'decoder')
            for k, v in ckpt[part].items() if 'running' not in k])
        for part in ('encoder', 'decoder'):
            for k, v in ckpt[part].items():
                if 'running' in k:
                    np.testing.assert_allclose(
                        v.numpy(), want[part][k].numpy(), rtol=1e-5,
                        atol=1e-7)
    assert _rel(flat['got'], flat['want']) < 1e-5
    names = TR.build_experiment(TR.parse_args(run), 'cpu').parameter_names()
    for i, name in enumerate(names):
        g = got['optimizer']['state'][i]['exp_avg'].numpy()
        w = want['optimizer']['state'][i]['exp_avg'].numpy()
        if not (name.startswith('encoder.convs.') and name.endswith('.bias')):
            assert _rel(g, w) < 1e-3, name
    assert got['rng']['pos'] == want['rng']['pos']


def test_cli_quick(deterministic):
    """python -m gendr_tpu_torch.experiments.train_reconstruction --quick
    --synthetic on the CPU: dataset, steps, evaluation and the report."""
    res = TR.main(['--quick', '--synthetic', '--device', 'cpu',
                   '--image_size', str(SIZE), '-ni', '2', '--batch_size', '2',
                   '--synthetic-objects', '1', '--max-eval-batches', '1'])
    assert len(res['losses']) == 2 and res['grads_finite']
    assert all(np.isfinite(res['losses']))
    assert 0.0 <= res['mean_iou'] <= 100.0


def test_cli_without_a_card_stops():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    with pytest.raises(SystemExit, match='--device cpu'):
        TR.main(['--synthetic', '--quick'])
