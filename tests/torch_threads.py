"""The port's CPU tests run torch on one intra-op thread.

The tier-1 run has six test workers on eight cores. On torch's default of
one intra-op thread a core, six workers start 48 threads between them,
and files of many small ops run several times slower than on one thread
each. A ``tests/test_torch_*.py`` that runs torch ops on the CPU imports
the fixture, and pytest applies it to each of its tests::

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread through the test; the count before is restored
    after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
