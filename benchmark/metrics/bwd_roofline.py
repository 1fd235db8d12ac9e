"""The backward render kernel's share of its roofline: its least time
(benchmark/problem.py) over the device time a step of its launches, the
slice, reduce and slab launches together (the union of their intervals,
so the slab launch that overlaps the slices' counts once), in percent."""

from benchmark import problem

KERNELS = ('rasterize_bwd',)


def read(run):
    k = run.trace.kernels(*KERNELS)
    if not k:
        return None
    t = run.trace.busy_s(k) / run.traced_steps
    return 100.0 * problem.bound_s(run.work['bwd_flops'],
                                   run.work['bwd_bytes']) / t
