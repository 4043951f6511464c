"""Work of the pad and blend layer in one call (chip_smoke's
``edge_pad_cast`` and ``blend_overlap_add`` bounds): the f32 photo read
and the canvas written in the work dtype; the tiles read in the work
dtype, the f32 output and the f32 reciprocal window sum of the canvas
read or written once."""

from __future__ import annotations

from .counts import bound_ms
from .shapes import Call


def pad_ms(s: Call) -> float:
    photo = s.batch * s.c * s.photo[0] * s.photo[1]
    return bound_ms(photo * 4 + s.canvas_el * s.esz, 0.0, "f32")


def blend_ms(s: Call) -> float:
    out = s.batch * s.c * (s.photo[0] - s.photo[0] % 2) * (
        s.photo[1] - s.photo[1] % 2)
    return bound_ms(s.tile_el * s.esz + out * 4
                    + s.canvas[0] * s.canvas[1] * 4, 0.0, "f32")
