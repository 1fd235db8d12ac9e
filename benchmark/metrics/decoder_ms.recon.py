"""Device ms a step of the reconstruction's decoder, forward and backward
(the step's ``decoder`` and ``decoder.bwd`` phases): the reading of
phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms'](
    'decoder', 'decoder.bwd')
