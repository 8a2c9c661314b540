"""The benchmark's CPU tests run torch on one thread, so the rest of the
suite, running beside them on the same cores, keeps its timings."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
