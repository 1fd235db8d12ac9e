"""One intra-op torch thread for a port test module.

Tier-1 runs the tests in several xdist workers on the machine's cores, and
torch starts one intra-op thread per core in each of them by default: the
workers' threads then outnumber the cores manyfold, and torch's many small
CPU ops (the kernels' plain versions, the experiments' steps) slow down by
up to two orders of magnitude.  Every ``tests/test_torch_*.py`` imports the
fixture below, which holds torch to one thread while its module runs and
restores the count after it.  One thread changes only the order of some
CPU sums, never what a test computes.  It does not switch on
``torch.use_deterministic_algorithms``: the tests that need it ask for it.

    from torch_threads import one_torch_thread  # noqa: F401

(pytest puts ``tests/`` on ``sys.path``.  On the card's machine
``tests.torch_threads`` is not found: ``tests`` resolves to another
package there.)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
