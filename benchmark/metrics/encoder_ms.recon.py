"""Device ms a step of the reconstruction's encoder, forward and backward
(the step's ``encoder`` and ``encoder.bwd`` phases; the forward phase
holds the batch's concatenation too, the backward one the encoder's
weight gradients): the reading of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms'](
    'encoder', 'encoder.bwd')
