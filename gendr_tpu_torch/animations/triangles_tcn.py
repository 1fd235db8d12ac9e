"""Single-triangle t-conorm sweep.

Port of ``animations/triangles_tcn.py``: ``panda_tcn`` with ``--triangle``.

    python -m gendr_tpu_torch.animations.triangles_tcn --quick
"""

from __future__ import annotations

import sys

from gendr_tpu_torch.animations import panda_tcn


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return panda_tcn.main(['--triangle'] + argv)


if __name__ == '__main__':
    main()
