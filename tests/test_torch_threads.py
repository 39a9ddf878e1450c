"""One torch thread for the port's tests.

Every `tests/test_torch_*.py` module imports `one_torch_thread`, which
pins torch to one intra-op thread while the module runs and restores the
count after. The tests' tensors are small (resize 32 and 64), and under
the suite's six xdist workers on eight cores, torch's OpenMP threads of
one worker (as many as cores by default, spinning between operations)
take the cores that the same worker's XLA thread pool and the other
workers need, and the port's tests ran several times longer on them than
on one thread, with the same results (CHANGES.md records the sums).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_the_port_tests_run_on_one_torch_thread():
    assert torch.get_num_threads() == 1
