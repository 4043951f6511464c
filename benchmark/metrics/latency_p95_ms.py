"""The 95th percentile of one call's wall time over every call of the
window, from the call until the synchronize that ends it (host clock)."""

import statistics


def read(rec):
    if len(rec.latencies_s) < 20:
        return None
    return statistics.quantiles(rec.latencies_s, n=20,
                                method="inclusive")[18] * 1e3
