"""Device kernels a step in the traced stretch of the chained loop: every
kernel the profiler records (a replay launches the graph's kernels, so
the count repeats exactly), over the steps.  The prepass's and autograd's
small kernels are most of them."""


def read(run):
    k = run.trace.kernels()
    return len(k) / run.traced_steps if k else None
