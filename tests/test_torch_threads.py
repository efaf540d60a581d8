"""CPU threads of the port's tests under pytest-xdist, and a test of the rule.

Every worker's torch starts one intra-op thread a core, so six workers on
eight cores run some forty threads, and the port's tests (many small tensor
ops, each ending in a barrier of its threads) slow down by 10-100x when
their threads are descheduled. Every port test module imports
``share_cores``: for the module's run torch gets its share of the cores
that this process may use, split evenly over the workers (all of them
without xdist), and the count it had comes back afterwards.
"""

import os

import pytest
import torch


def worker_threads() -> int:
    """This worker's share of the usable cores, at least one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True, scope="module")
def share_cores():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, worker_threads()))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("workers,cores,share", [(None, 8, 8), (1, 8, 8), (6, 8, 1),
                                                 (4, 8, 2), (16, 8, 1), (6, 64, 10)])
def test_worker_share_of_the_cores(monkeypatch, workers, cores, share):
    """Workers split the usable cores evenly, one thread at least; the
    fixture has set this module's torch to that share (or less)."""
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert worker_threads() == share
    monkeypatch.undo()
    assert torch.get_num_threads() <= worker_threads()
