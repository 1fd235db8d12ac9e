"""idle_share in the cells whose end-to-end metric is step_ms.recon: the
reading of idle_share.chained.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'idle_share.chained.py'))['read']
