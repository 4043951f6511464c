"""Shared fixtures of the benchmark's tests. Tests that need the card take
the ``cuda`` fixture, which skips them where there is none: the decision
is made when the test runs, never when a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")


def small(config, traffic):
    """The tests' size: 600 x 800 photos (6 tiles of 400 px), batches of
    at most 2, pools of 2 calls, a call or two per phase."""
    config["photo"].update(height=600, width=800)
    traffic.update(batch=min(traffic["batch"], 2), pool_calls_min=2,
                   pool_bytes_min=0, warmup_calls=1, check_calls=2,
                   host_calls=2, trace_calls=1)
