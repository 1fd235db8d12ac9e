"""Device ms a step of the step's ``compact`` phase (the compaction plan,
``pack.compact_plan``, alone), in the cells whose end-to-end metric is
step_ms.sharp: the reading of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms']('compact')
