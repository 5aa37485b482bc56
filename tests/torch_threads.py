"""A module fixture for the port's CPU tests: torch's intra-op threads
capped, while a test module runs, at this process's share of the cores
it may run on (restored after).

The tests run in several worker processes at once (pytest-xdist sets
`PYTEST_XDIST_WORKER_COUNT` in each), and torch starts an intra-op thread
a core in every one of them: six workers on eight cores run 48 threads
that spin-wait for each other, which made one smoke model's step twenty
times slower than alone.  A test module opts in by importing
`shared_cores` into its namespace."""

import os

import pytest
import torch


def cores_a_worker() -> int:
    """The cores this process may run on, shared among the workers."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True, scope="module")
def shared_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, cores_a_worker()))
    yield
    torch.set_num_threads(before)
