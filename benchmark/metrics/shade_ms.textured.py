"""Device ms a step of the textures' shading and the anti-aliasing pool,
both ways, in the textured fit's cell: the phases ``shade`` (the
texture's sigmoid, the lighting and the repeat over the views), ``aa``
(the 2x2 pool), ``aa.bwd`` (the pool's backward) and ``shade.bwd`` (the
texture chain's backward into the texture and the normals); the reading
of phase_ms.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'phase_ms.py'))['phase_ms'](
                                       'shade', 'shade.bwd', 'aa', 'aa.bwd')
