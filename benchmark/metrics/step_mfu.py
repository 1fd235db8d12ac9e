"""The whole step's share of the card's float32 peak (67 TFLOP/s): the
step's operations counted from the problem (the render's gated pairs;
for the reconstruction also the network's layer shapes,
benchmark/problem.py) over the traced stretch's step time (host clock),
in percent.  The profiler slows the stretch, so this reads low."""

from benchmark import problem


def read(run):
    step_s = run.traced_s / run.traced_steps
    return 100.0 * run.work['step_flops'] / step_s / problem.FP32_FLOPS
