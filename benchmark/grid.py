"""The tile grid of the patch path, worked out from the photo size alone.

The upstream's patch decomposition (teboli/polyblur ``deblurring.py``
``deblur_patches``): the photo is cropped to even sizes, replicate-padded
so that whole tiles at a fixed step cover it, and cut into square tiles.
The step is ``int(patch * (1 - overlap))``, truncated. Both the reference
and the work counts read the grid from here, never from the program. A
configuration whose ``layout`` is ``"whole"`` has no grid: each photo is
restored as one piece (:func:`whole`).
"""

from __future__ import annotations

import math
from typing import NamedTuple


class Grid(NamedTuple):
    crop: tuple        # (h, w): the photo cropped to even sizes
    canvas: tuple      # (Hc, Wc): the padded canvas the tiles cover
    patch: int         # tile edge
    step: int          # distance between tile origins
    rows: int          # tiles down
    cols: int          # tiles across
    pad: tuple         # (top, bottom, left, right) replicate pad

    @property
    def tiles(self) -> int:
        return self.rows * self.cols

    def origins(self):
        """Tile origins (i0, j0), row by row: the order the tiles are
        blended in."""
        return [(r * self.step, c * self.step)
                for r in range(self.rows) for c in range(self.cols)]


def plan(height: int, width: int, patch: int, overlap: float) -> Grid:
    """The grid of square ``patch`` tiles at ``overlap`` over a photo of
    ``height`` x ``width`` pixels."""
    h, w = height - height % 2, width - width % 2
    step = int(patch * (1.0 - overlap))
    hc = int(math.ceil(max(h - patch, 0) / step) * step) + patch
    wc = int(math.ceil(max(w - patch, 0) / step) * step) + patch
    top, left = (hc - h) // 2, (wc - w) // 2
    return Grid((h, w), (hc, wc), patch, step, (hc - patch) // step + 1,
                (wc - patch) // step + 1,
                (top, hc - h - top, left, wc - w - left))


#: a configuration's ``layout``: cut into the tile grid (the default), or
#: each photo restored as one piece
LAYOUTS = ("tiles", "whole")


def whole(config: dict) -> bool:
    """Whether the configuration restores each photo whole, with no tile
    grid."""
    layout = config.get("layout", "tiles")
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    return layout == "whole"
