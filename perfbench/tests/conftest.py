"""One intra-op thread for the benchmark's CPU tests: the suite runs in
parallel workers, where many threads a worker make the small ops of a
cell at a small size (the enhancers' training steps above all) wait on
each other."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
