"""The share of compaction's slab slots that hold a valid face
('compact.slots_used' of 'compact.slots'): the lanes of the slab kernel,
rasterize_bwd_slab, that have a face to sum, the reading of
counter_share.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'counter_share.py'))['counter_share'](
    'compact.slots_used', 'compact.slots')
