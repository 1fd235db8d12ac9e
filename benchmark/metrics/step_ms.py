"""A chained training step: the window's elapsed time, from its start to
the last block's fetch, over the steps completed (host clock).  The
per-block host work (batch draws, copies, fetches) is inside it."""


def read(run):
    return 1e3 * run.window_s / run.window_steps
