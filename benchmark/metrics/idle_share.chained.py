"""The device's idle share of the traced stretch: 1 - the union of its
kernels', copies' and fills' intervals over the stretch's host-clock
length, in percent.  The profiler slows what it traces, most where a step
is many small kernels, so this reads above the untraced loop's."""


def read(run):
    if not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.traced_s)
