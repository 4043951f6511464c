"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``benchmark/configs/<config>.json``: the photo, the program's entry and
its call) under a traffic mix (``benchmark/traffic/<traffic>.json``: the
batch, the pool, the photos' content, the sample sizes). Each metric is a
reader of its own, ``benchmark/metrics/<name>.py``, whose ``read(record)``
returns a number or None (nothing to read: the metric is left out). The
harness finds all of them by the names in ``BENCHMARK.json``; adding a
configuration, a mix or a metric adds files and entries, no code here.

A training traffic (``"job": "train"``) makes each call one step of the
program's training path on a (blurry, sharp) pair instead
(``benchmark.train``): the configuration's call gives the layer's grid,
dtypes and starting scalars, the traffic Adam's hyperparameters.

A configuration's ``layout`` says how the program takes a photo. With
``"tiles"`` (the default) the entry is the patch engine: its call names
the tile grid and the work and output dtypes, which go in as dtypes, and
``cast_input`` says whether the batch is cast to the work dtype before the
call. With ``"whole"`` each photo is restored as one piece (the
functional API's and the module's default): the call goes to the entry as
it stands, with only ``device`` added, and the batch is cast to the work
dtype of the file's ``precision`` (``{"work_dtype", "out_dtype"}``); the
reference then restores each photo whole too, and the work counts give
the megapixels alone.

The window is a closed loop with one caller: each call takes the next
batch of the pool and ends in a synchronize. With ``trace`` the run
instead times the host side of a few calls, counts their launches, and
profiles a fixed number more. Either way a sample of the calls' outputs,
drawn from the seed, is kept and, once the window has closed and the
device memory's peak has been read, held against the plain reference
(``benchmark.reference``) by ``benchmark.compare``; a training cell's
check follows its first steps instead (``benchmark.train``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import compare, grid, photos, train
from . import trace as tracing
from .reference import polyblur_ref
from .work import shapes

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "polyblur_tpu")


class HarnessError(RuntimeError):
    """A run that cannot report: the caller prints no result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, workload: str):
    """(benchmark, workload entry, configuration, traffic) of a cell."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{entry['traffic']}.json")
    return bench, entry, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """[(name, unit)] the cell reports in a run with or without trace."""
    return [(m["name"], m["unit"])
            for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def reader(root: Path, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def entry_point(config: dict, device):
    """The program's entry bound to the configuration's call: a function
    of one (B, C, H, W) batch."""
    module, name = config["entry"].split(":")
    fn = getattr(importlib.import_module(module), name)
    kw = dict(config["call"])
    if grid.whole(config):
        work = polyblur_ref.DTYPES[config["precision"]["work_dtype"]]
        return lambda x: fn(x.to(work), device=device, **kw)
    work = polyblur_ref.DTYPES[kw["work_dtype"]]
    kw["out_dtype"] = polyblur_ref.DTYPES[kw["out_dtype"]]
    if kw.pop("cast_input"):
        del kw["work_dtype"]
        return lambda x: fn(x.to(work), device=device, **kw)
    kw["work_dtype"] = work
    return lambda x: fn(x, device=device, **kw)


def control(config: dict):
    """The reference in the program's place, storing in the precision
    below the configuration's (``control_dtype``)."""
    import torch

    work = polyblur_ref.DTYPES[config["control_dtype"]]
    return lambda x: polyblur_ref.restore(x, config, work).to(torch.float32)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Sample:
    """A uniform sample of ``k`` of the window's outputs, drawn from the
    seed (reservoir sampling): [(call index, pool index, output)]."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept = []

    def offer(self, i: int, pool_index: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((i, pool_index, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, pool_index, out)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path = ROOT, device: str = "cuda",
             sut=None, shrink=None):
    """One run of ``workload``: (the result line's object, what the line
    before it reports: the routes the calls took and the card).

    :param t_start: the host clock (``time.perf_counter``) at the process's
        start: set-up is counted from it
    :param device: ``"cuda"`` for a measurement; ``"cpu"`` runs the
        program's plain path (tests)
    :param sut: None for the program; ``"control"`` for the reference in
        the lower precision; or a function ``f(program_call) -> call``
        that wraps the timed call (the faults of the tests; for a training
        cell it takes and returns the step object, ``train.Program``)
    :param shrink: optional function ``f(config, traffic)`` that edits the
        loaded files in place (the tests' tiny sizes)
    """
    import torch

    bench, _, config, traffic = cell(root, workload)
    if shrink is not None:
        shrink(config, traffic)
    cuda = device == "cuda"
    dev = torch.device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    import polyblur_torch
    from polyblur_torch.ops.cuda import _build
    from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

    if not Path(polyblur_torch.__file__).resolve().is_relative_to(ROOT):
        raise HarnessError(f"polyblur_torch loaded from "
                           f"{polyblur_torch.__file__}, not the checkout")
    if cuda:
        _build.build()      # every source at once where the checkout has none

    training = photos.training(traffic)
    if training:
        program = (train.control if sut == "control" else train.Program)(
            config, traffic, dev)
    else:
        program = control(config) if sut == "control" else entry_point(
            config, dev)
    fn = program if sut is None or sut == "control" else sut(program)
    pool = photos.make_pool(config, traffic, seed, dev)
    for i in range(traffic["warmup_calls"]):
        fn(pool[i % len(pool)])
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_dispatch_log()
    # a training cell's check reads its step object's first steps instead
    sample = Sample(0 if training else traffic["check_calls"], seed)
    rec = SimpleNamespace(shapes=shapes.of_cell(config, traffic),
                          setup_s=setup_s, calls=0, window_s=None,
                          latencies_s=[], host_s=[], launches=[],
                          call_peak_bytes=[], trace=None)
    failed, peak = 0, setup_peak

    def one(i, timed_host=False):
        nonlocal failed, peak
        x = pool[i % len(pool)]
        _build.reset_launches()
        if timed_host and cuda:
            # the call's own peak: above what the pool and the kept
            # outputs hold when it begins
            peak = max(peak, torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        try:
            out = fn(x)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"call {i} failed: {e}", file=sys.stderr)
            return
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        if timed_host:
            rec.host_s.append(t1 - t0)
            rec.launches.append(sum(_build.launches.values()))
            if cuda:
                rec.call_peak_bytes.append(
                    torch.cuda.max_memory_allocated(dev) - held)
        else:
            rec.latencies_s.append(t2 - t0)
        sample.offer(i, i % len(pool), out)
        return t2

    sync()
    if not trace:
        w0 = time.perf_counter()
        i = 0
        while True:
            t = one(i) or time.perf_counter()
            i += 1
            if t - w0 >= seconds:
                break
        rec.window_s = time.perf_counter() - w0
        rec.calls = len(rec.latencies_s)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        n_host, n_traced = traffic["host_calls"], traffic["trace_calls"]
        for i in range(n_host):
            one(i, timed_host=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                for i in range(n_host, n_host + n_traced):
                    with record_function(tracing.CALL):
                        out = fn(pool[i % len(pool)])
                    with record_function(tracing.SYNC):
                        sync()
                    sample.offer(i, i % len(pool), out)
                del out
        rec.trace = tracing.of_profile(prof, n_traced)
        rec.calls = n_host + n_traced
    memory_peak = max(peak, torch.cuda.max_memory_allocated(dev)) if cuda else 0
    route = dispatch_log()

    metrics = {}
    for name, unit in metrics_of(bench, workload, trace):
        v = reader(root, name)(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": unit}

    # the check: after the window, the peak read and the caches let go
    if cuda:
        torch.cuda.empty_cache()
    if training:
        correct, checks = compare.judge(
            train.check(fn, config, traffic),
            dict(config["limits"], **config["train_limits"]))
    else:
        readings, ref_of, ref = [], None, None
        with torch.no_grad():
            for _, p, out in sorted(sample.kept, key=lambda t: t[1]):
                if p != ref_of:          # one photo's reference at a time
                    ref_of, ref = p, polyblur_ref.restore(pool[p], config)
                h, w = ref.shape[-2:]
                readings.append(compare.errors(out, ref,
                                               pool[p][..., :h, :w]))
        del ref
        sample.kept.clear()
        correct, checks = (compare.judge(compare.worst(readings),
                                         config["limits"])
                           if readings else (False, {}))
    correct = correct and failed == 0
    result = {"correct": bool(correct), "attempted": rec.calls + failed,
              "failed": failed, "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(dev),
                            "count": 1, "memory_peak_bytes": int(memory_peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if rec.trace is not None:
        w0, w1 = rec.trace.window
        result["device"]["busy_s"] = tracing.busy_us(rec.trace) / 1e6
        result["device"]["window_s"] = (w1 - w0) / 1e6
        result["breakdown"] = {
            "device_ops": tracing.top_device_ops(rec.trace),
            "idle_gaps": tracing.top_idle_gaps(rec.trace)}
    result["checks"] = checks
    info = {"route": {f"{site}:{backend}": n
                      for (site, backend), n in sorted(route.items())},
            "card": card_line() if cuda else "cpu"}
    # last, after every reader and the check have been loaded and run
    found = forbidden_modules()
    if found:
        raise HarnessError(f"forbidden modules loaded: {found}")
    return result, info
