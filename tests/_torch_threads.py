"""One intra-op thread for the port's CPU tests.

The port's tests run batch-1 solves and small batches on tiny tensors,
where torch's intra-op thread pool costs more than it gives; under
pytest-xdist every worker would start a pool as wide as the machine, and
the workers' pools then fight over the same cores. A test module takes
the fixture by importing it::

    from _torch_threads import one_torch_thread  # noqa: F401

It sets one thread for the module and restores the previous count after
it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
