"""Device idle milliseconds a traced step under one of the program's host
spans: every idle gap of the traced stretch between device operations
(``run.trace.gaps()``) whose midpoint falls, among the host spans named
``gendr.*`` (``gendr_tpu_torch.utils.profiling.span``), innermost in the
named one, summed over the stretch and divided by its steps.  A trace with
no device operation, or with no such span (a program that opens none),
reads nothing.
``span_idle(name)`` makes the reader of the metrics that alias it."""


def idle_us(trace, name):
    """Microseconds of the trace's gaps under span ``name``, or None
    without a device operation or a gendr.* span."""
    if not trace.device:
        return None
    spans = sorted((ts, ts + dur, n) for n, _, ts, dur in trace.host
                   if n.startswith('gendr.'))
    if not spans:
        return None
    total, k, live = 0.0, 0, []
    for start, length in trace.gaps():
        t = start + length / 2
        while k < len(spans) and spans[k][0] <= t:
            live.append(spans[k])
            k += 1
        live = [s for s in live if s[1] >= t]
        # the span that started last among those running is the innermost
        if live and live[-1][2] == name:
            total += length
    return total


def span_idle(name):
    def read(run):
        us = idle_us(run.trace, name)
        return None if us is None else 1e-3 * us / run.traced_steps
    return read
