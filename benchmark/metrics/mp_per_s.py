"""Megapixels restored per second: the input megapixels of every call
whose output was complete within the window, over the window's wall time
(host clock; each call ends in a synchronize)."""


def read(rec):
    if rec.window_s is None:
        return None
    return rec.calls * rec.shapes.megapixels / rec.window_s
