"""Bisect which primitive operation chains round differently under nvcc
and under torch.

Port of ``tools/ulp_bisect.py``: divisions, ``exp``, ``tanh``, ``rsqrt``,
``log``, ``pow``, multiply-add shapes, division chains, the wigner, gamma
(Kummer series) and frank chains, with their parameters as constants and
as a second input, each through the probe kernel ``ulp_elementwise`` (every
case in one launch) and through torch on the card and on the CPU.

    python -m gendr_tpu_torch.tools.ulp_bisect

It needs the card and exits 1 without one.
"""

from __future__ import annotations

import sys

from gendr_tpu_torch.tools import _ulp


def main(argv=None):
    return _ulp.main('ulp_bisect', _ulp.bisect_cases(), 'ulp_elementwise')


if __name__ == '__main__':
    sys.exit(main())
