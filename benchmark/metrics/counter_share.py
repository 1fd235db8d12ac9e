"""A share, in percent, of two counts of the program's training step, from
the program's own counter table
(``gendr_tpu_torch.utils.profiling.counter_table()``): while the traced
stretch's profiler records, each block's last step counts what its
compaction plan did, and the table sums those counts over the blocks.  The
reading is 100 times the first count's sum over the second's; the whole
table is printed to standard error.  A program without the table, or a
table without both counts, reads nothing.  ``counter_share(part, whole)``
makes the reader of the metrics that alias it."""

import sys


def table():
    try:
        from gendr_tpu_torch.utils import profiling
        return profiling.counter_table()
    except (ImportError, AttributeError):
        return {}


def counter_share(part, whole):
    def read(run):
        t = table()
        print('counter_share: sum (samples): ' + ('; '.join(
            f'{k} {v["sum"]:.0f} ({v["samples"]})' for k, v in t.items())
            or 'no counter table'), file=sys.stderr)
        if not t.get(part, {}).get('samples') \
                or not t.get(whole, {}).get('sum'):
            return None
        return 100.0 * t[part]['sum'] / t[whole]['sum']
    return read
