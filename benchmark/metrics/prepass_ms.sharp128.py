"""Device ms a step of the step's ``prepass`` phase, in a cell whose
render is compacted: the prepass without its compaction plan, which is
the ``compact`` phase; the reading of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms']('prepass')
