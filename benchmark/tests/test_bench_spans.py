"""The readers of the program's spans: the device's idle time inside the
patch layer (``patches_idle_ms``) and inside the stage loop
(``pipeline_idle_ms``), on hand-built traces and in one run on the
CPU."""

import importlib.util
import json
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark import trace as tracing
from benchmark.tests.conftest import small
from benchmark.trace import Trace

PATCHES = harness.reader(harness.ROOT, "patches_idle_ms")
PIPELINE = harness.reader(harness.ROOT, "pipeline_idle_ms")


def _read(device, host, window=(0.0, 100.0), calls=1):
    rec = SimpleNamespace(trace=Trace(device, host, window, calls))
    return PATCHES(rec), PIPELINE(rec)


def test_nested_spans_split_the_idle_by_the_innermost():
    host = [("bench.call", 0.0, 100.0),
            ("pb.deblur_patches", 10.0, 90.0),
            ("pb.plan", 10.0, 20.0),
            ("pb.restore_tiles", 30.0, 80.0),
            ("pb.estimate", 30.0, 50.0),
            ("pb.polynomial", 55.0, 80.0),
            ("cudaLaunchKernel", 60.5, 61.5)]
    device = [("k0", 0.0, 12.0), ("k1", 18.0, 40.0), ("k2", 45.0, 60.0),
              ("k3", 62.0, 95.0)]
    # idle: [12, 18) in pb.plan, [40, 45) in pb.estimate, [60, 62) in
    # pb.polynomial under a launch it nests, [95, 100) outside pb.*
    patches, pipeline = _read(device, host, calls=2)
    assert patches == pytest.approx(6.0 / 2 / 1e3)
    assert pipeline == pytest.approx(7.0 / 2 / 1e3)


def test_a_gap_across_the_stage_loop_start_is_split_there():
    host = [("pb.deblur_patches", 0.0, 100.0),
            ("pb.plan", 0.0, 10.0),
            ("pb.restore_tiles", 25.0, 90.0)]
    device = [("k0", 0.0, 20.0), ("k1", 40.0, 100.0)]
    # the gap [20, 40): 5 us before pb.restore_tiles opens, 15 after
    patches, pipeline = _read(device, host)
    assert patches == pytest.approx(5e-3)
    assert pipeline == pytest.approx(15e-3)


def test_idle_outside_every_program_span_counts_in_neither():
    host = [("bench.call", 0.0, 60.0), ("bench.sync", 60.0, 100.0),
            ("pb.deblur_patches", 5.0, 50.0),
            ("pb.restore_tiles", 10.0, 40.0)]
    device = [("k0", 0.0, 100.0)]
    assert _read(device, host) == (0.0, 0.0)
    device = [("k0", 5.0, 50.0)]
    # idle [0, 5) in bench.call and [50, 100) in the harness only
    assert _read(device, host) == (0.0, 0.0)


def test_no_program_span_or_no_device_reads_nothing():
    host = [("bench.call", 0.0, 100.0), ("aten::empty", 1.0, 2.0)]
    assert _read([("k0", 0.0, 10.0)], host) == (None, None)
    host.append(("pb.deblur_patches", 0.0, 90.0))
    assert _read([], host) == (None, None)
    assert PATCHES(SimpleNamespace(trace=None)) is None


def test_a_traced_run_reports_both(monkeypatch, capsys):
    """One traced run on the CPU, where no device operation runs: the
    host's aten operators stand in for the device's, so the readers see
    the program's spans through the harness as they would on the card."""
    real = tracing.of_profile

    def with_host_ops(prof, calls):
        tr = real(prof, calls)
        ops = [s for s in tr.host if s[0].startswith("aten::")]
        return tr._replace(device=ops)

    monkeypatch.setattr(tracing, "of_profile", with_host_ops)
    # run.py keeps its bytecode under the checkout's build/
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    spec = importlib.util.spec_from_file_location(
        "bench_run", harness.ROOT / "benchmark" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.report("photo12mp_bf16.single", 2 ** 31 + 22, 0.1, True,
                    device="cpu", shrink=small)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["patches_idle_ms"]["unit"] == "ms"
    assert metrics["pipeline_idle_ms"]["unit"] == "ms"
    assert metrics["patches_idle_ms"]["value"] > 0
    assert metrics["pipeline_idle_ms"]["value"] > 0
    assert any(name.startswith("pb.")
               for name, _ in line["breakdown"]["idle_gaps"])


def test_idle_gaps_go_to_the_innermost_span_as_a_scan_of_all_finds():
    """The sweep that names the host span at each gap's middle against a
    scan of every span, on nested, overlapping and equal spans."""
    import random

    rng = random.Random(5)
    host = []
    for k in range(400):
        s = rng.uniform(0.0, 1000.0)
        host.append((f"h{k % 7}", s, s + rng.choice([0.5, 3.0, 3.0, 40.0])))
    host += [("outer", 0.0, 1000.0), ("twin", 500.0, 503.0),
             ("twin2", 500.0, 503.0)]
    device = [("k", t, t + 0.7) for t in range(0, 1000, 2)]
    tr = Trace(device, host, (0.0, 1000.0), 1)

    def scan(t):
        best = None
        for name, s, e in host:
            if s <= t < e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "python"

    times = sorted(rng.uniform(-5.0, 1005.0) for _ in range(2000))
    times += [500.0, 502.9, 503.0]
    times.sort()
    assert tracing.hosts_at(tr, times) == [scan(t) for t in times]
    by = {}
    for s, e in tracing.idle_gaps(tr):
        n = scan(0.5 * (s + e))
        by[n] = by.get(n, 0.0) + (e - s)
    want = [[n, v / 1e6] for n, v in sorted(by.items(), key=lambda kv: -kv[1])]
    assert tracing.top_idle_gaps(tr) == want[:10]
