"""The share of the tiles that any octet of faces hits which compaction
serves with its slabs ('compact.tiles_slab' of 'compact.tiles_hit'); the
rest overflow to the sorted chunks' lists: the reading of
counter_share.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'counter_share.py'))['counter_share'](
    'compact.tiles_slab', 'compact.tiles_hit')
