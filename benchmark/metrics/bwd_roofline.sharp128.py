"""bwd_roofline in the camera's compacted 128x128 cell, whose
end-to-end metric is step_ms.sharp: the reading of
bwd_roofline.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'bwd_roofline.py'))['read']
