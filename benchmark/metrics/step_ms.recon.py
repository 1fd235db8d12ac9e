"""step_ms in a cell whose host draws each block's batches between
blocks (the card idles meanwhile), so its runs spread with the host's
speed and it carries a bound of its own: the reading of step_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'step_ms.py'))['read']
