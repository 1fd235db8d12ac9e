"""nvcc-vs-torch bitwise parity with the render kernels' parameter
plumbing.

Port of ``tools/ulp_smem.py``.  The render kernels read ``dist_scale``,
``dist_shape`` and the t-conorm's p from a parameter vector in device
memory, where ``ulp_check`` and ``ulp_bisect`` pass them by value.  This
tool runs the scale chains, the arcsine's parts and frank's fold and its
parts through the probe kernel ``ulp_param_vector`` (every case in one
launch), which reads the parameters from such a vector inside the kernel (on the TPU they were
scalar-prefetched into SMEM, hence the name), against torch reading the
same vector.

    python -m gendr_tpu_torch.tools.ulp_smem

It needs the card and exits 1 without one.
"""

from __future__ import annotations

import sys

from gendr_tpu_torch.tools import _ulp


def main(argv=None):
    return _ulp.main('ulp_smem', _ulp.smem_cases(), 'ulp_param_vector')


if __name__ == '__main__':
    sys.exit(main())
