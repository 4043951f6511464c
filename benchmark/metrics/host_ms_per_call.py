"""The host's time per call, from entering the program's entry until it
returns, before the synchronize: the median over the traced run's calls
that the profiler does not cover (host clock). Layers patches and
pipeline."""

import statistics


def read(rec):
    if not rec.host_s:
        return None
    return statistics.median(rec.host_s) * 1e3
