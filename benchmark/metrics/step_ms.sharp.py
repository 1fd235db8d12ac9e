"""step_ms in a cell of many small kernels a step, whose card runs the
same replays at one of two speeds in a run (PERF.md, Open questions), so
its runs spread more than a cell of long kernels and it carries a bound of
its own: the reading of step_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'step_ms.py'))['read']
