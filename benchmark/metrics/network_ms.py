"""Device milliseconds a step of the reconstruction network's convolution
and matrix-product kernels (cuDNN, cuBLAS, CUTLASS), matched by name, the
union of their intervals over the traced steps.  The unmatched kernels
with the most time are printed to standard error, so the list can be
checked."""

import sys
from collections import defaultdict

PATTERNS = ('conv', 'Conv', 'gemm', 'Gemm', 'GEMM', 'cudnn', 'cutlass',
            'cublas', 'xmma', 'wgrad', 'dgrad', 'fprop', 'implicit_convolve',
            'nhwc', 'nchw')


def read(run):
    k = run.trace.kernels(*PATTERNS)
    rest = defaultdict(float)
    for name, cat, _, dur in run.trace.device:
        if cat == 'kernel' and not any(p in name for p in PATTERNS):
            rest[name[:100]] += dur * 1e-3 / run.traced_steps
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:8]
    print('network_ms: unmatched kernels, ms a step: '
          + '; '.join(f'{n} {t:.4f}' for n, t in top), file=sys.stderr)
    if not k:
        return None
    return 1e3 * run.trace.busy_s(k) / run.traced_steps
