"""Reduction of a profiler trace to what the per-layer metrics read.

The traced calls run under ``torch.profiler`` with the host and the
device recorded. This module keeps only plain tuples of the trace: the
device operations (kernels, copies, sets) and the host spans, each
``(name, start_us, end_us)`` on the profiler's one clock, the window's own
span, and for each device operation the start of the runtime call that
launched it (the profiler's correlation), so that a metric's reader needs
no profiler object.
"""

from __future__ import annotations

import bisect
import heapq
import re
from typing import NamedTuple

WINDOW = "bench.window"      # the span around the traced calls
CALL = "bench.call"          # the span around one call of the program
SYNC = "bench.sync"          # the span around the synchronize that ends it


class Trace(NamedTuple):
    device: list             # [(name, start_us, end_us)] device operations
    host: list               # [(name, start_us, end_us)] host spans
    window: tuple            # (start_us, end_us) of the traced calls
    calls: int               # calls traced
    #: [start_us or None] of the runtime call that launched each device
    #: operation, in the order of ``device``
    launched: list = ()


def of_profile(prof, calls: int) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # a device operation shares its correlation id with the runtime call
    # (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that launched it
    runtime = {e.id: float(e.time_range.start) for e in events
               if e.device_type != DeviceType.CUDA and e.name.startswith("cu")}
    device, launched, host, window = [], [], [], None
    for e in events:
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a host span's copy on the device's timeline is no operation
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in (WINDOW, CALL, SYNC)):
                device.append(span)
                launched.append(runtime.get(e.id))
        elif e.name == WINDOW:
            window = span[1:]
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(device, host, window, calls, launched)


def short(name: str) -> str:
    """A device operation's name without its return type, namespace and
    argument list: ``gemm_kernel<2, __nv_bfloat16, 0>``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def busy_intervals(spans) -> list:
    """The union of the spans' [start, end) intervals, sorted."""
    out = []
    for _, s, e in sorted(spans, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(tr: Trace) -> float:
    """Microseconds of the window in which some device operation ran."""
    w0, w1 = tr.window
    return sum(max(0.0, min(e, w1) - max(s, w0))
               for s, e in busy_intervals(tr.device))


def device_us(tr: Trace, patterns) -> float:
    """Summed device time of the operations whose full name matches any of
    the regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    return sum(e - s for name, s, e in tr.device
               if any(r.search(name) for r in rx))


def launched_in(tr: Trace, inside) -> float | None:
    """Summed device time of the operations launched while a host span
    whose name satisfies ``inside`` was open; None where the trace links
    no device operation to its launch."""
    if not any(t is not None for t in tr.launched):
        return None
    spans = busy_intervals([s for s in tr.host if inside(s[0])])
    starts = [s for s, _ in spans]
    total = 0.0
    for (_, s, e), t in zip(tr.device, tr.launched):
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t < spans[k][1]:
            total += e - s
    return total


def top_device_ops(tr: Trace, k: int = 10) -> list:
    """[[short name, seconds]] of the ``k`` device operations that took
    most time in the window, summed by name."""
    by = {}
    for name, s, e in tr.device:
        n = short(name)
        by[n] = by.get(n, 0.0) + (e - s)
    return [[n, t / 1e6] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
            [:k]]


def idle_gaps(tr: Trace) -> list:
    """[(start_us, end_us)] of the window in which no device operation
    ran."""
    w0, w1 = tr.window
    gaps, cur = [], w0
    for s, e in busy_intervals(tr.device):
        if s > cur:
            gaps.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        gaps.append((cur, w1))
    return [g for g in gaps if g[1] > g[0]]


def hosts_at(tr: Trace, times) -> list:
    """The innermost host span running at each of the ascending ``times``
    (the shortest that holds it; of equal ones the first in ``tr.host``),
    or ``python`` where none does. One sweep over the spans by start, with
    a heap of those begun by their length: a trace of some hundred
    operations a call holds thousands of gaps and spans."""
    order = sorted(range(len(tr.host)), key=lambda i: tr.host[i][1])
    heap, j, out = [], 0, []
    for t in times:
        while j < len(order) and tr.host[order[j]][1] <= t:
            _, s, e = tr.host[order[j]]
            heapq.heappush(heap, (e - s, order[j]))
            j += 1
        # a span ended by t has ended for every later time too
        while heap and tr.host[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        out.append(tr.host[heap[0][1]][0] if heap else "python")
    return out


def top_idle_gaps(tr: Trace, k: int = 10) -> list:
    """[[host span, seconds]]: the window's idle time summed by what the
    host was running at the middle of each gap, the ``k`` largest."""
    by = {}
    gaps = idle_gaps(tr)
    for (s, e), n in zip(gaps, hosts_at(tr, [0.5 * (s + e) for s, e in gaps])):
        by[n] = by.get(n, 0.0) + (e - s)
    return [[n, t / 1e6] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
            [:k]]
