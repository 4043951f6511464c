"""Routing constants of the whole-image and auto-tiled routes.

These are the JAX package's routing constants (``polyblur_tpu/envelopes.py``),
copied so that both packages route the same input alike: the same image
takes the tiles route, the fused or blocked polynomial, the fused
directional maxima, or the patch engine in both. They were fitted to a
TPU's memory envelope and speed; they are NOT measured on the H100 and are
no speed target for the port (re-planning the routes for the H100 is
ROADMAP B.2 item 9).
"""

from __future__ import annotations

__all__ = ["MEGA_MAX_TILE", "MEGA_MAX_TILE_DT", "FUSED_MAX_CANVAS",
           "BLOCK_COST_CONST", "BLOCKED_COST_MACS_PX", "TILE_FIXED_MACS",
           "AUTO_TILE_MIN_AREA"]

#: Largest image edge of the tiles route (whole image as one tile) and of
#: the fused directional-maxima reduction.
MEGA_MAX_TILE: int = 640

#: The tiles-route cap when the domain-transform prefilter runs.
MEGA_MAX_TILE_DT: int = 512

#: Largest (replicate-padded) canvas edge of the single-canvas fused
#: polynomial; larger canvases take the overlap-save block grid.
FUSED_MAX_CANVAS: int = MEGA_MAX_TILE + 24

#: Per-pixel non-DFT cost of a block in the block-grid planner.
BLOCK_COST_CONST: float = 200.0

#: Modeled MACs per output pixel charged to the blocked route by
#: ``method='auto'``'s tiling decision.
BLOCKED_COST_MACS_PX: float = 11000.0

#: Modeled fixed cost of one tile of the patch engine, in MACs.
TILE_FIXED_MACS: float = 1.4e8

#: ``method='auto'`` keeps whole-image semantics below this area.
AUTO_TILE_MIN_AREA: int = 4_000_000
