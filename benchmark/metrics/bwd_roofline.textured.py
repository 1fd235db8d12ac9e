"""bwd_roofline in the textured fit's cell (softmax RGB over 25-texel
surface textures, whose flops a pair the driver counts): the reading of
bwd_roofline.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'bwd_roofline.py'))['read']
