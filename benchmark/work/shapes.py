"""The sizes of one call of a cell, worked out from its configuration and
traffic files: what the work counts multiply. A configuration restored
whole has no tiles: its call has the photos' sizes alone (:class:`Whole`),
and no reader of tile work reads it."""

from __future__ import annotations

from typing import NamedTuple

from ..grid import plan, whole

HALF = 12                  # the kernel's half-support: tiles padded by it
_ESZ = {"bfloat16": 2, "float32": 4}


class Call(NamedTuple):
    batch: int             # photos per call
    c: int                 # channels
    photo: tuple           # (H, W)
    canvas: tuple          # (Hc, Wc) of the tile grid
    n: int                 # tiles of the call: grid tiles x batch
    p: int                 # tile edge
    h: int                 # padded tile canvas edge: p + 2 HALF
    esz: int               # bytes of an element in the work dtype
    kind: str              # the work dtype's name in the configuration
    n_iter: int
    taper: bool
    halo: bool
    prefilter: bool        # the domain-transform prefilter

    @property
    def planes(self) -> int:
        return self.n * self.c

    @property
    def tile_el(self) -> int:
        """Elements of all tiles' planes."""
        return self.planes * self.p * self.p

    @property
    def canvas_el(self) -> int:
        return self.batch * self.c * self.canvas[0] * self.canvas[1]

    @property
    def megapixels(self) -> float:
        return self.batch * self.photo[0] * self.photo[1] / 1e6


class Whole(NamedTuple):
    batch: int             # photos per call
    c: int                 # channels
    photo: tuple           # (H, W)

    @property
    def megapixels(self) -> float:
        return self.batch * self.photo[0] * self.photo[1] / 1e6


def of_cell(config: dict, traffic: dict) -> Call | Whole:
    ph = config["photo"]
    if whole(config):
        return Whole(traffic["batch"], ph["channels"],
                     (ph["height"], ph["width"]))
    call = config["call"]
    g = plan(ph["height"], ph["width"], call["patch_size"], call["overlap"])
    prefilter = bool(call.get("prefiltering"))
    if prefilter and call.get("smoother") != "domain_transform":
        raise ValueError("work is counted for the domain-transform "
                         "prefilter only")
    b = traffic["batch"]
    return Call(b, ph["channels"], (ph["height"], ph["width"]), g.canvas,
                g.tiles * b, g.patch, g.patch + 2 * HALF,
                _ESZ[call["work_dtype"]], call["work_dtype"], call["n_iter"],
                bool(call.get("edgetaping")), bool(call.get("remove_halo")),
                prefilter)
