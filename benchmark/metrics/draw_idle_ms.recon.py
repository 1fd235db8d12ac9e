"""Device idle ms a traced step while the host is in the program's span
``gendr.data.draw`` (the dataset drawing a batch's image ids and
viewpoints): the reading of span_idle.py."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   'span_idle.py'))['span_idle'](
    'gendr.data.draw')
