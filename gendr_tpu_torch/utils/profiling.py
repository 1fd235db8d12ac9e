"""torch.profiler integration: traces, host spans and a step's phases.

Port of ``gendr_tpu/utils/profiling.py``: wrap any region in
``trace('/tmp/trace')`` and open the Chrome trace it writes
(``<log_dir>/trace.json``) in Perfetto or chrome://tracing.  The profiler
records host activity everywhere and the card's where CUDA is available.

Beyond the JAX package's module, the program marks its own work for a
profiler, and only while one records (``active()``):

- ``span(name)``: a host range ``gendr.<name>`` in the trace, beside the
  card's kernels on the trace's clock; otherwise one shared no-op context.
- ``mark(name)``: the start of phase ``name`` of a training step.  A
  ``Recorder`` made active by ``recording`` keeps the marks: on the card a
  timing event recorded on the current stream (captured into a CUDA graph
  as an event-record node, so every replay records it again), on the CPU,
  whose ops are synchronous, the host clock.  A phase runs on the stream
  from its mark to the next.  Without an active recorder a mark does
  nothing.
- ``grad_mark(x, name)``: x, through an identity whose backward marks
  ``name`` when x's gradient is complete (a mark inside autograd's
  backward); x itself without an active recorder.
- ``count(name, value)``: a count of the step being recorded (a device
  scalar, or a number), kept by the active recorder beside its marks and
  read once the step has finished; nothing without an active recorder
  (``recorder()`` is None: a caller computes a count only where it is
  not).

``experiments.common.StepChain`` records the marks of a block's last step
while a profiler records (on the card it replays there a second graph of
the step, captured with its marks, so no other replay carries them) and,
after the block's fetch, adds that step's phases and counts to the
process's tables: ``phase_table()`` then gives each phase's summed
milliseconds and its samples (one a block), ``counter_table()`` each
count's sum and its samples; ``reset_phases()`` clears both.

    with trace('/tmp/t'):
        steps.run(xs)
    phase_table()     # {'geometry': {'ms': ..., 'samples': ...}, ...}
    counter_table()   # {'compact.tiles_hit': {'sum': ..., 'samples': ...}}
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_OFF = contextlib.nullcontext()
# the recorder that marks go to: set by ``recording`` around a step, read
# by marks from any thread (autograd's backward runs on its own)
_recorder = None
# phase -> [milliseconds summed over samples, samples]
_phases = {}
# count -> [sum over samples, samples]
_counters = {}


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the enclosed region into log_dir/trace.json; yields the
    ``torch.profiler.profile`` object (None when not enabled), whose
    ``key_averages()`` hold the totals once the region has ended."""
    if not enabled:
        yield None
        return
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def active():
    """Whether a torch profiler records in this process."""
    return torch._C._autograd._profiler_enabled()


def span(name):
    """The host range ``gendr.<name>`` while a profiler records, else a
    shared no-op context."""
    if not active():
        return _OFF
    return torch.profiler.record_function('gendr.' + name)


class Recorder:
    """The phase marks and counts of a step on ``device``, in stream order.
    Under CUDA graph capture the events and the counts' tensors are made
    once and written by every replay of that graph; ``phases()`` and
    ``counts()`` then read the last replay's."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.marks = []
        self.counters = []

    def mark(self, name):
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True, external=True)
            stamp.record()
        else:
            stamp = time.perf_counter()
        self.marks.append((name, stamp))

    def phases(self):
        """{phase: milliseconds} from each mark to the next (a phase marked
        twice in the step summed), of the step recorded last, which must
        have finished."""
        out = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
            out[name] = out.get(name, 0.0) + ms
        return out

    def count(self, name, value):
        self.counters.append((name, value))

    def counts(self):
        """{count: value} of the step recorded last, which must have
        finished (a name counted twice summed)."""
        out = {}
        for name, value in self.counters:
            # a tensor is copied and summed on the host: no device kernel
            out[name] = out.get(name, 0.0) + float(
                value.cpu().sum() if torch.is_tensor(value) else value)
        return out


@contextlib.contextmanager
def recording(recorder):
    """Marks go to ``recorder`` while the region runs (None: nowhere)."""
    global _recorder
    previous, _recorder = _recorder, recorder
    try:
        yield recorder
    finally:
        _recorder = previous


def recorder():
    """The recorder that marks go to now, or None."""
    return _recorder


def mark(name):
    """Phase ``name`` of the step being recorded starts here."""
    if _recorder is not None:
        _recorder.mark(name)


def count(name, value):
    """Add ``value`` (a number, or a device tensor summed on the host when
    the counts are read) to count ``name`` of the step being recorded."""
    if _recorder is not None:
        _recorder.count(name, value)


class _GradMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mark(ctx.name)
        return grad, None


def grad_mark(x, name):
    """x; while a step is recorded, through an identity whose backward
    marks ``name`` once x's gradient is complete."""
    if _recorder is None:
        return x
    return _GradMark.apply(x, name)


def add_phases(recorder):
    """The recorder's last step into the phase and counter tables: one
    sample."""
    for table, values in ((_phases, recorder.phases()),
                          (_counters, recorder.counts())):
        for name, v in values.items():
            entry = table.setdefault(name, [0.0, 0])
            entry[0] += v
            entry[1] += 1


def phase_table():
    """{phase: {'ms': milliseconds summed over samples, 'samples': n}}, in
    the order the phases were first seen."""
    return {k: dict(ms=ms, samples=n) for k, (ms, n) in _phases.items()}


def counter_table():
    """{count: {'sum': its values summed over samples, 'samples': n}}, in
    the order the counts were first seen."""
    return {k: dict(sum=v, samples=n) for k, (v, n) in _counters.items()}


def reset_phases():
    """Empty the phase and counter tables."""
    _phases.clear()
    _counters.clear()
