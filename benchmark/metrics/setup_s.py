"""Set-up time: from the process's start to the first timed step (import,
CUDA context, kernels from the build cache, mesh or dataset, weights from
the seed, the first three steps with the warm-up and capture), host
clock."""


def read(run):
    return run.setup_s
