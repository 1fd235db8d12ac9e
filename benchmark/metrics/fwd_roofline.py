"""The forward render kernel's share of its roofline: the least time the
card could take for one render (the gated pairs' operations over the
float32 peak, or the bytes of its inputs and output over HBM bandwidth,
the larger; benchmark/problem.py, counted from the problem) over the
device time a step of the kernel's launches (the union of their
intervals), in percent."""

from benchmark import problem

KERNELS = ('rasterize_fwd',)


def read(run):
    k = run.trace.kernels(*KERNELS)
    if not k:
        return None
    t = run.trace.busy_s(k) / run.traced_steps
    return 100.0 * problem.bound_s(run.work['fwd_flops'],
                                   run.work['fwd_bytes']) / t
