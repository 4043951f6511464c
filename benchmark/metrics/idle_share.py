"""Share of the traced window in which no operation ran on the device: 1
less the union of the device operations' intervals over the window's
wall time, in %. Layer device."""

from benchmark.trace import busy_us


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    w0, w1 = rec.trace.window
    return 100.0 * (1.0 - busy_us(rec.trace) / (w1 - w0))
