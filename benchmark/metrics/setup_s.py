"""Seconds from the harness's start to the window's: imports, the card's
context, the kernels' libraries (built where the checkout has none), the
photos made on the device and the warm-up calls (host clock)."""


def read(rec):
    return rec.setup_s
