"""One intra-op thread for a port test module: its shapes are tiny, so more
threads gain nothing alone, and beside the suite's other workers (and the
ranks some of them spawn, one thread each) they oversubscribe the cores and
spin. A module opts in by importing the fixture:
``from tests.torch_one_thread import one_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
