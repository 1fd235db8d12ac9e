"""Device ms a step of the compacted prepass in the textured fit's cell:
the phases ``compact`` (the plan) and ``prepass`` (the sort and the pack
of faces and slots, texel rows included); the reading of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms']('compact',
                                                               'prepass')
