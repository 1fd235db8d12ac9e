"""Device milliseconds a step in named phases of the program's training
step, from the program's own phase table
(``gendr_tpu_torch.utils.profiling.phase_table()``): while the traced
stretch's profiler records, the step's phase marks (timing events captured
into its CUDA graph) give each phase's time from its mark to the next on
the card's stream, read from each block's last step.  The reading is the
sum over the named phases of each one's mean over its samples; the whole
table is printed to standard error.  A trace with no device operation
(a run off the card, whose marks are the host's clock), a program without
the table, or a table without every named phase, reads nothing.
``phase_ms(*phases)`` makes the reader of the metrics that alias it."""

import sys


def table():
    try:
        from gendr_tpu_torch.utils import profiling
        return profiling.phase_table()
    except (ImportError, AttributeError):
        return {}


def phase_ms(*phases):
    def read(run):
        if not run.trace.device:
            return None
        t = table()
        print('phase_ms: ms a sample (samples): ' + ('; '.join(
            f'{k} {v["ms"] / v["samples"]:.4f} ({v["samples"]})'
            for k, v in t.items()) or 'no phase table'), file=sys.stderr)
        if not all(t.get(p, {}).get('samples') for p in phases):
            return None
        return sum(t[p]['ms'] / t[p]['samples'] for p in phases)
    return read
