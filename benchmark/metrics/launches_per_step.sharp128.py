"""launches_per_step in the camera's compacted 128x128 cell, whose
end-to-end metric is step_ms.sharp: the reading of
launches_per_step.chained.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'launches_per_step.chained.py'))['read']
