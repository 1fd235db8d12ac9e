"""Textured-mesh t-conorm parameter-p sweep.

Port of ``animations/panda_tcn_p.py``: ``panda_tcn`` with ``--sweep-p``.

    python -m gendr_tpu_torch.animations.panda_tcn_p --quick
"""

from __future__ import annotations

import sys

from gendr_tpu_torch.animations import panda_tcn


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return panda_tcn.main(['--sweep-p'] + argv)


if __name__ == '__main__':
    main()
