"""Device ms a step of the step's ``render.bwd`` phase (from the render's
output's gradient to its inputs': the pixel columns, the backward kernel
and the gradients' un-permute and slot fold) in the textured fit's cell:
the reading of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms']('render.bwd')
