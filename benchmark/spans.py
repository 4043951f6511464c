"""The device's idle time attributed to the program's spans.

The program opens ``pb.*`` spans at its layer boundaries
(``polyblur_torch.utils.profiling.span``) while a torch profiler runs, so
they share the profiler's clock with the device operations. Every
microsecond of the traced window in which no device operation runs
(``trace.idle_gaps``) belongs to the innermost ``pb.*`` span open on the
host at that instant; a gap that crosses a span's edge is split there.
Since the stage loop's spans nest in ``pb.restore_tiles`` and the patch
layer's in ``pb.deblur_patches``, a layer's share is the idle time inside
its outer span and outside the spans of the layers it calls. Idle time
outside every ``pb.*`` span (the harness's own, between calls) is no
layer's.
"""

from __future__ import annotations

from benchmark.trace import Trace, busy_intervals, idle_gaps

PREFIX = "pb."


def _minus(a: list, b: list) -> list:
    """The sorted disjoint intervals ``a`` less the sorted disjoint
    intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def _overlap_us(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_call(tr: Trace | None, inside, outside=()) -> float | None:
    """The idle ms per traced call that falls inside the spans named in
    ``inside`` and outside those named in ``outside``; None where the trace
    holds no device operation or no ``pb.*`` span (a program without
    spans)."""
    if tr is None or not tr.device:
        return None
    spans = [s for s in tr.host if s[0].startswith(PREFIX)]
    if not spans:
        return None
    region = _minus(busy_intervals([s for s in spans if s[0] in inside]),
                    busy_intervals([s for s in spans if s[0] in outside]))
    idle_us = _overlap_us([list(g) for g in idle_gaps(tr)], region)
    return idle_us / tr.calls / 1e3
