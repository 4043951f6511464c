"""Shared fixtures of the benchmark's tests. Tests that need the card take
the ``cuda`` fixture, which skips them where there is none: the decision
is made when the test runs, never when a module is imported."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: entries of ``BENCHMARK.json`` for the configurations under
#: ``benchmark/configs`` that it does not list yet: a cell whose runs on the
#: card spread too widely for the bounds (PERF.md), tested as it would run
UNLISTED = {
    "configs": [
        {"name": "demo700k",
         "source": "https://github.com/teboli/polyblur/blob/main/README.md#L43-L45",
         "file": "benchmark/configs/demo700k.json", "reduced": [],
         "why": "the upstream demo: a 700 x 500 RGB photo restored whole "
                "through polyblur_deblurring (N 3, alpha 6, beta 1) in "
                "float32"}],
    "workloads": [
        {"name": "demo700k.single", "config": "demo700k", "traffic": "single",
         "chips": 1,
         "why": "one web-sized photo a call through the functional API, "
                "closed loop, pool of 65: the whole-image blocked route in "
                "f32; host-bound, so the host's cost shows"}]}
#: the per-layer metrics whose ``workloads`` the cells of :data:`UNLISTED`
#: would join
UNLISTED_METRICS = {name: ["demo700k.single"] for name in (
    "host_ms_per_call", "launches_per_call", "idle_share", "peak_mem_gib")}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs an NVIDIA card; skips without one")


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout's root whose ``BENCHMARK.json`` lists the cells of
    :data:`UNLISTED` too, in the metrics of :data:`UNLISTED_METRICS`, with
    the benchmark's folder linked in."""
    path = tmp_path_factory.mktemp("root")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in UNLISTED.items():
        bench[key] += entries
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + UNLISTED_METRICS.get(m["name"], [])
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    (path / "benchmark").symlink_to(ROOT / "benchmark")
    return path


@pytest.fixture
def one_thread():
    """One CPU thread: the CPU's FFTs and sums then run in one order (with
    several, their order can follow the load of the machine)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")


def small(config, traffic):
    """The tests' size: 600 x 800 photos (6 tiles of 400 px), batches of
    at most 2, pools of 2 calls, a call or two per phase; a training
    traffic's two checked steps are its two warm-up steps."""
    config["photo"].update(height=600, width=800)
    traffic.update(batch=min(traffic["batch"], 2), pool_calls_min=2,
                   pool_bytes_min=0, warmup_calls=1, check_calls=2,
                   host_calls=2, trace_calls=1)
    if traffic.get("job") == "train":
        traffic.update(warmup_calls=2)
