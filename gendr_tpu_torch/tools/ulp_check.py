"""nvcc-vs-torch bitwise parity of the function zoo, elementwise.

Port of ``tools/ulp_check.py``.  A kernel equals its plain PyTorch version
only as far as each distribution's ``cdf`` and ``pdf`` and each t-conorm's
``fold_step`` and ``aggregate_backward`` round alike in nvcc's build of
``csrc/pairmath.cuh`` and in PyTorch's ops: the max t-conorm's backward
finds its winner by exact float equality, and frank's 1e-6 saturation guard
turns one ulp of coverage into O(1) gradient error.  This tool evaluates
each function on the same inputs through the probe kernel
``ulp_elementwise`` (every case in one launch) and through torch, on the
card and on the CPU, counts the elements whose bits differ and prints the
worst inputs.

    python -m gendr_tpu_torch.tools.ulp_check [distribution ...]

It needs the card and exits 1 without one.
"""

from __future__ import annotations

import sys

from gendr_tpu_torch.tools import _ulp


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith('-')] or _ulp.ALL_DISTS
    return _ulp.main('ulp_check', _ulp.check_cases(names),
                     'ulp_elementwise')


if __name__ == '__main__':
    sys.exit(main())
