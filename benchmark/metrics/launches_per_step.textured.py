"""launches_per_step in the textured fit's cell: the reading of
launches_per_step.chained.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'launches_per_step.chained.py'))['read']
