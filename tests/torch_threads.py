"""ATen's thread count for the port's test modules, each of which
imports :func:`share_cores_among_workers` (an autouse fixture)."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def share_cores_among_workers():
    """ATen's threads for a module's tests: the machine's cores divided
    among the pytest-xdist workers that share them. Left at one a core
    in each worker, the workers' spinning OpenMP threads slow every
    test on the machine."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
