"""The port's host spans and phase marks (``utils/profiling.py``) on the CPU.

A span is one shared no-op without a profiler and a ``gendr.*`` range of
the exported trace under one; ``grad_mark`` is the very tensor without a
recorder and leaves gradients bitwise equal with one; a chained
``opt_camera`` run (``tests/test_torch_chain.py``'s sizes) under the
profiler fills the phase table in the step's stream order, one sample a
block, with losses bitwise those of a run without it, which opens no span
and adds nothing to the table; the reconstruction's step marks its
encoder and decoder in both directions; ``opt_shape``'s step its own
phases, each marked once, its hard evaluation one phase.  The benchmark's shared readers of these: ``phase_ms.py`` reads
nothing from an empty table, ``span_idle.py`` puts each idle gap on the
innermost ``gendr.*`` span of a nested trace; a recorder's counts fill
the counter table, which ``counter_share.py`` reads as a share.

On the card (``cuda`` marker; skips without one): marks captured into a
CUDA graph around one kernel read that kernel's time as events outside a
graph of it do; a chained ``opt_camera`` run replays its marked copy of
the step only for a traced block's last step, with losses bitwise those
of an untraced run.

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_profiling.py -k card
"""

import importlib.util
import json
import os
import statistics
import types

import numpy as np
import pytest
import torch

from gendr_tpu_torch import data, utils
from gendr_tpu_torch.experiments import common
from gendr_tpu_torch.experiments import opt_camera as OC
from gendr_tpu_torch.experiments import opt_shape as OS
from gendr_tpu_torch.experiments import train_reconstruction as TR
from gendr_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
CHAIN = 3
CAMERA_PHASES = ['geometry', 'render', 'loss', 'loss.bwd', 'render.bwd',
                 'geometry.bwd', 'adam']


@pytest.fixture(autouse=True)
def empty_table():
    profiling.reset_phases()
    yield
    profiling.reset_phases()


def _module(rel):
    spec = importlib.util.spec_from_file_location(
        'bench_' + rel.replace('/', '_').replace('.', '_'),
        os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _annotations(log_dir):
    with open(os.path.join(log_dir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    return [e['name'] for e in events if e.get('cat') == 'user_annotation']


def test_span_is_a_shared_no_op_without_a_profiler(tmp_path):
    assert not profiling.active()
    assert profiling.span('a') is profiling.span('b')
    with profiling.span('a'):
        pass
    with utils.trace(str(tmp_path)):
        assert profiling.active()
        with profiling.span('probe'):
            torch.ones(3).add_(1)
    assert not profiling.active()
    assert 'gendr.probe' in _annotations(tmp_path)


def test_grad_mark_is_the_tensor_without_a_recorder_and_bitwise_with():
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    assert profiling.grad_mark(x, 'a') is x
    w = torch.arange(7.0)

    def grad(rec):
        x.grad = None
        with profiling.recording(rec):
            y = profiling.grad_mark(x * 3, 'a')
            (torch.sin(y) * w).sum().backward()
        return x.grad.clone()

    plain = grad(None)
    rec = profiling.Recorder('cpu')
    marked = grad(rec)
    assert torch.equal(marked, plain)
    assert [name for name, _ in rec.marks] == ['a']
    profiling.mark('b')   # outside recording: nothing kept
    assert len(rec.marks) == 1


def _camera_run(device='cpu'):
    args = OC.parse_args(['--device', str(device), '-is', '16', '-bs', '4',
                          '-ni', str(STEPS), '--model_obj', 'proc_cube.obj',
                          '--chain', str(CHAIN)])
    exp = OC.CameraExperiment(args, device)
    return exp.run(OC.initial_poses(4, 15, 35)), exp


def test_camera_chain_fills_the_table_in_stream_order(tmp_path,
                                                      monkeypatch):
    with utils.trace(str(tmp_path)):
        traced, _ = _camera_run()
    table = profiling.phase_table()
    assert list(table) == CAMERA_PHASES
    # 4 steps in blocks of 3 and 1: a sample a block
    assert {v['samples'] for v in table.values()} == {2}
    assert all(v['ms'] >= 0 for v in table.values())
    names = _annotations(tmp_path)
    assert {'gendr.chain.inputs', 'gendr.chain.step',
            'gendr.chain.fetch'} <= set(names)
    assert names.count('gendr.chain.step') == STEPS
    # no profiler: no span opened, nothing in the table, the same losses
    profiling.reset_phases()

    def no_span(*a, **k):
        raise AssertionError('a span opened without a profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', no_span)
    plain, _ = _camera_run()
    assert profiling.phase_table() == {}
    assert traced['losses'] == plain['losses']
    np.testing.assert_array_equal(traced['poses'], plain['poses'])


def _small_reconstruction():
    torch.manual_seed(0)
    v, f = data.icosphere(2)
    encoder = TR.Encoder(dim1=4, dim2=16, dim_out=8, image_size=16)
    decoder = TR.Decoder(v, dim_in=8, width=8)
    args = TR.parse_args(['--image_size', '16', '--batch_size', '2',
                          '--device', 'cpu'])
    return TR.Reconstruction(args, encoder, decoder, f, 'cpu')


def test_reconstruction_step_marks_encoder_and_decoder(tmp_path):
    exp = _small_reconstruction()
    opt = common.make_adam(exp.parameters(), 1e-4)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.rand(2, 2, 4, 16, 16).astype(np.float32))
    eyes = torch.tensor([[0.0, 0.0, -2.732]]).expand(2, 2, 3).contiguous()
    inputs = dict(par=exp.par)

    def step():
        loss, ok = exp.step(opt, images[0], images[1], eyes[0], eyes[1])
        return torch.stack([loss, ok.to(loss.dtype)])

    chain = common.StepChain(step, inputs)
    row = exp.renderer.params_vector(dist_scale=10 ** -1.5)
    with utils.trace(str(tmp_path)):
        res = chain.run({'par': row[None].repeat(2, 1)})
    assert bool(res[:, 1].all())
    assert list(profiling.phase_table()) == [
        'encoder', 'decoder', 'geometry', 'render', 'loss', 'loss.bwd',
        'render.bwd', 'geometry.bwd', 'decoder.bwd', 'encoder.bwd',
        'finite', 'adam']


def test_shape_step_marks_its_phases(tmp_path):
    args = OS.parse_args(['-is', '16', '--device', 'cpu', '--chain', '2'])
    args.num_vertices = 162
    exp = OS.ShapeExperiment(args, 'cpu')
    eyes = torch.tensor([[0.0, 0.0, -2.7]] * 2)
    targets = torch.zeros((2, 16, 16))
    with utils.trace(str(tmp_path)):
        exp.run(10 ** -1.5, 3e-2, eyes, targets, 2)
    phases = ['geometry', 'render', 'loss', 'loss.bwd', 'render.bwd',
              'geometry.bwd', 'finite', 'adam', 'eval']
    assert list(profiling.phase_table()) == phases
    # the hard evaluation's render after Adam is the one phase 'eval': its
    # render marks nothing of its own
    assert [n for n, _ in exp.steps.recorder.marks] == phases + ['end']


def test_dataset_draw_is_a_span(tmp_path):
    d = tmp_path / 'mesh_reconstruction'
    d.mkdir()
    np.savez(d / '02691156_train_images.npz',
             np.zeros((1, 24, 4, 64, 64), np.uint8))
    np.savez(d / '02691156_train_voxels.npz',
             np.zeros((1, 32, 32, 32), np.uint8))
    ds = TR.ShapeNet(str(tmp_path), ['02691156'], 'train')
    plain = ds.get_random_batch_ids(np.random.RandomState(3), 4)
    with utils.trace(str(tmp_path / 'trace')):
        traced = ds.get_random_batch_ids(np.random.RandomState(3), 4)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    assert 'gendr.data.draw' in _annotations(tmp_path / 'trace')


def _run(trace, steps=1):
    return types.SimpleNamespace(trace=trace, traced_steps=steps)


def test_phase_reader_reads_nothing_from_an_empty_table():
    Trace = _module('benchmark/trace.py').Trace
    kernel = dict(ph='X', cat='kernel', name='k', ts=0.0, dur=5.0)
    read = _module('benchmark/metrics/phase_ms.py').phase_ms('adam')
    assert read(_run(Trace([kernel]))) is None
    rec = profiling.Recorder('cpu')
    rec.marks = [('loss', 0.0), ('adam', 1.0), ('end', 1.004)]
    profiling.add_phases(rec)
    profiling.add_phases(rec)
    assert profiling.phase_table()['adam']['samples'] == 2
    assert read(_run(Trace([kernel]))) == pytest.approx(4.0)
    # a trace with no device operation is not a device reading
    assert read(_run(Trace([]))) is None
    both = _module('benchmark/metrics/phase_ms.py').phase_ms('adam', 'x')
    assert both(_run(Trace([kernel]))) is None


def test_counts_are_kept_by_a_recorder_and_read_as_a_share():
    profiling.count('a', torch.tensor(3))   # no recorder: nothing kept
    rec = profiling.Recorder('cpu')
    with profiling.recording(rec):
        profiling.count('a', torch.tensor(3))
        profiling.count('a', 2)
        # a tensor of counts is summed when read
        profiling.count('b', torch.tensor([[4, 1], [5, 0]],
                                          dtype=torch.int32))
    assert rec.counts() == {'a': 5.0, 'b': 10.0}
    share = _module('benchmark/metrics/counter_share.py').counter_share
    assert share('a', 'b')(None) is None    # an empty table
    profiling.add_phases(rec)
    profiling.add_phases(rec)
    assert profiling.counter_table() == {'a': dict(sum=10.0, samples=2),
                                         'b': dict(sum=20.0, samples=2)}
    assert share('a', 'b')(None) == pytest.approx(50.0)
    assert share('a', 'c')(None) is None
    profiling.reset_phases()
    assert profiling.counter_table() == {}


def test_span_idle_puts_gaps_on_the_innermost_program_span():
    Trace = _module('benchmark/trace.py').Trace
    idle_us = _module('benchmark/metrics/span_idle.py').idle_us

    def ev(cat, name, ts, dur):
        return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur)
    host = [ev('user_annotation', 'bench.block', 0, 200),
            ev('user_annotation', 'gendr.chain.step', 10, 20),
            ev('cuda_runtime', 'cudaGraphLaunch', 12, 6),
            ev('user_annotation', 'gendr.chain.fetch', 50, 20),
            ev('user_annotation', 'gendr.data.draw', 75, 30),
            ev('cpu_op', 'aten::mul', 80, 5),
            ev('user_annotation', 'gendr.chain.step', 120, 10),
            ev('user_annotation', 'gendr.outer', 140, 40),
            ev('user_annotation', 'gendr.chain.step', 150, 15)]
    # the gaps and the span innermost at their midpoints: [10, 20] the
    # step (cudaGraphLaunch inside it is no program span), [25, 40]
    # bench.block alone, [45, 60] the fetch, [65, 100] the draw (aten::mul
    # inside it), [105, 150] the second step, [155, 170] the step nested
    # in gendr.outer
    device = [ev('kernel', 'k', ts, dur) for ts, dur in
              [(0, 10), (20, 5), (40, 5), (60, 5), (100, 5), (150, 5),
               (170, 5)]]
    trace = Trace(host + device)
    assert idle_us(trace, 'gendr.chain.step') == 10 + 45 + 15
    assert idle_us(trace, 'gendr.chain.fetch') == 15
    assert idle_us(trace, 'gendr.data.draw') == 35
    assert idle_us(trace, 'gendr.outer') == 0
    read = _module('benchmark/metrics/span_idle.py').span_idle(
        'gendr.data.draw')
    assert read(_run(trace, 5)) == pytest.approx(35e-3 / 5)
    assert idle_us(Trace(device), 'gendr.data.draw') is None
    assert idle_us(Trace(host), 'gendr.data.draw') is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_card_captured_marks_time_a_kernel(cuda):
    """A graph of marks around one spinning kernel against events around
    the replay of a graph of that kernel alone: medians of 7 within 2 %."""
    cycles = 10_000_000   # about 5 ms at the card's clock
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    marked, bare = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    rec = profiling.Recorder(cuda)
    with torch.cuda.graph(marked), profiling.recording(rec):
        profiling.mark('sleep')
        torch.cuda._sleep(cycles)
        profiling.mark('end')
    with torch.cuda.graph(bare):
        torch.cuda._sleep(cycles)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    inside, outside = [], []
    for _ in range(7):
        marked.replay()
        torch.cuda.synchronize()
        inside.append(rec.phases()['sleep'])
        a.record()
        bare.replay()
        b.record()
        torch.cuda.synchronize()
        outside.append(a.elapsed_time(b))
    print(f'captured marks {inside} ms; events around the replay '
          f'{outside} ms')
    assert statistics.median(inside) == pytest.approx(
        statistics.median(outside), rel=0.02)


@pytest.mark.cuda
def test_card_chain_marks_only_a_traced_block_s_last_step(cuda, tmp_path):
    """Captured, the chain's untraced run adds nothing to the table; its
    traced run a sample a block, the prepass and K1 marked too; the
    losses and poses of both bitwise equal: the marked copy of the step
    computes what the plain graph does."""
    plain, exp = _camera_run(cuda)
    steps = exp.chains['iou']
    assert steps.graph is not None and steps.marked[0] is not steps.graph
    assert profiling.phase_table() == {}
    with utils.trace(str(tmp_path)):
        traced, exp = _camera_run(cuda)
    table = profiling.phase_table()
    assert list(table) == ['geometry', 'render', 'prepass', 'raster',
                           'loss', 'loss.bwd', 'render.bwd', 'geometry.bwd',
                           'adam']
    assert {v['samples'] for v in table.values()} == {2}
    assert exp.chains['iou'].replays == STEPS
    assert traced['losses'] == plain['losses']
    np.testing.assert_array_equal(traced['poses'], plain['poses'])
