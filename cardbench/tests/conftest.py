"""The benchmark's own tests: CPU tests at toy sizes, and tests marked
``card`` that need an NVIDIA card and skip without one (decided inside a
fixture, never when a module is imported). Run them from the root of the
repository: ``python -m pytest cardbench/tests -q``."""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips on the CPU)")
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        # parallel workers share the cores: one thread set each, so a toy
        # run's window still reaches every frame it checks
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda", 0)

