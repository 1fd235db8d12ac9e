"""step_mfu in the cells whose end-to-end metric is step_ms.recon: the
reading of step_mfu.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'step_mfu.py'))['read']
