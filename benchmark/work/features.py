"""Work of the features layer in one call: the edgetaper's weights, the
prefilter and the halo mask (chip_smoke's counts at config 2's shapes).

* taper weights, per iteration: the estimate rows read, (av, ah) written;
  two 25 x 25 tap grids and their projections' autocorrelations;
* the domain-transform prefilter, per iteration: its input read once (the
  canvas in the first iteration, the stored tiles after), the smooth part
  and the noise written once in f32; ~26 flops per pixel for the maps, 6
  per element for each of the two passes, 1 for the noise;
* the halo, per call: the canvas read once, each iteration's restored
  planes, the planes it started from and the prefilter's noise read once and the
  tiles written once in the work dtype; the gradient pair of the input
  planes once and of each iteration's output, and 20 flops per element
  for the mask. The input gradients are an intermediate.
"""

from __future__ import annotations

from .counts import bound_ms, gradient_flops
from .shapes import HALF, Call

_TAPS = 2 * HALF + 1
TAPER_FLOPS = 2 * _TAPS * _TAPS * 10 + 2 * _TAPS * _TAPS * 2


def per_call_ms(s: Call) -> float | None:
    """Least device time in ms of the features of one call; None when the
    configuration runs none."""
    if not (s.taper or s.halo or s.prefilter):
        return None
    total = 0.0
    if s.taper:
        total += s.n_iter * bound_ms(s.n * (8 + 2 * s.h) * 4,
                                     s.n * TAPER_FLOPS, "f32")
    if s.prefilter:
        out = 2 * s.tile_el * 4
        flops = 26.0 * s.n * s.p * s.p + 13.0 * s.tile_el
        total += bound_ms(s.canvas_el * s.esz + out, flops, "f32")
        total += (s.n_iter - 1) * bound_ms(s.tile_el * s.esz + out, flops,
                                           "f32")
    if s.halo:
        noise = 4 if s.prefilter else 0
        total += bound_ms(s.canvas_el * s.esz
                          + s.n_iter * s.tile_el * (4 + 4 + noise + s.esz),
                          s.planes * gradient_flops(s.p, s.p) * (1 + s.n_iter)
                          + s.n_iter * 20.0 * s.tile_el, "f32")
    return total
