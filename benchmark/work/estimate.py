"""Work of the estimation layer in one call: per iteration, every tile's
directional maxima (chip_smoke's ``tile_estimate`` bound): the tiles read
once in the work dtype, the (n, 8) estimate rows written once, the
maxima's flops at the f32 peak."""

from __future__ import annotations

from .counts import bound_ms, maxima_flops
from .shapes import Call


def per_call_ms(s: Call) -> float:
    """Least device time in ms of the estimates of one call."""
    one = bound_ms(s.tile_el * s.esz + s.n * 8 * 4,
                   s.n * maxima_flops(s.c, s.p, s.p), "f32")
    return s.n_iter * one
