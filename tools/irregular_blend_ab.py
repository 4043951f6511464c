#!/usr/bin/env python3
"""Time the irregular grid's blend on the card, two ways.

    python3 tools/irregular_blend_ab.py

On the 12 MP image's 448 px / overlap 0.6 grid (336 tiles, step 179) it
restores the tiles once (bf16, the tiles route), then times

* ``loop``: ``patches.overlap_add`` as shipped: 336 slice-adds in the
  grid's coordinate order (the JAX package's ``.at[].add`` chain);
* ``classes``: the tiles of one residue class of the tile index per axis
  (mod ceil(448 / 179) = 3) do not overlap, so 3 x 3 in-place adds into
  strided views of the canvas cover the grid; each pixel then sums its
  tiles in class order, not in coordinate order (not bit-equal).

Each: host ms (median of 10 calls between synchronizes), device ms of one
call (``torch.profiler`` kernel time) and the largest difference from
the loop. Prints the card line first. Needs one CUDA device.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def blend_by_classes(patches, grid, batch, window_type="kaiser",
                     out_dtype=None):
    """The irregular blend with the 336 slice-adds replaced by one
    in-place add per residue class of the tile index (f32 blend)."""
    import torch

    from polyblur_torch.patches import _blend_constants

    ph, pw = grid.patch_size
    H, W = grid.padded_size
    rows = sorted({i for i, _ in grid.coords})
    cols = sorted({j for _, j in grid.coords})
    sh, sw = rows[1] - rows[0], cols[1] - cols[0]
    kh, kw = -(-ph // sh), -(-pw // sw)
    window, inv_wsum = _blend_constants(grid, window_type, patches.device)
    c = patches.shape[1]
    tiles = (patches.float() * window).reshape(len(rows), len(cols), batch,
                                               c, ph, pw)
    out = tiles.new_zeros((batch, c, H, W))
    for a in range(kh):
        for b in range(kw):
            sel = tiles[a::kh, b::kw]
            mr, mc = sel.shape[:2]
            view = out.as_strided(
                (batch, c, mr, ph, mc, pw),
                (c * H * W, H * W, kh * sh * W, W, kw * sw, 1),
                out.storage_offset() + a * sh * W + b * sw)
            view.add_(sel.permute(2, 3, 0, 4, 1, 5))
    out = (out * inv_wsum).clamp(0.0, 1.0)
    if out_dtype is not None:
        out = out.to(out_dtype)
    pt, _, pl, _ = grid.pad
    h, w = grid.orig_size
    return out[..., pt:pt + h, pl:pl + w]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity

    import chip_smoke
    import polyblur_torch
    from polyblur_torch.patches import (extract_patches, overlap_add,
                                        plan_patch_grid)

    if not torch.cuda.is_available():
        print("irregular_blend_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(chip_smoke.card_line())
    img = torch.as_tensor(chip_smoke.make_12mp_image(
        np.random.default_rng(0)), device=dev)
    grid = plan_patch_grid(img.shape[-2], img.shape[-1], 448, 0.6)
    tiles = extract_patches(img.to(torch.bfloat16), grid)
    restored = polyblur_torch.pipeline.polyblur_core(
        tiles, device=dev, method="direct_separable", **chip_smoke.PATH_KW)
    del tiles
    f32 = torch.float32
    calls = {
        "loop": lambda: overlap_add(restored, grid, 1, out_dtype=f32),
        "classes": lambda: blend_by_classes(restored, grid, 1, out_dtype=f32),
    }
    ref = calls["loop"]()
    for name, fn in calls.items():
        diff = float((fn() - ref).abs().max())
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time for e in kernels) / 1e3
        print(f"blend[{name}, {len(grid.coords)} tiles of 448, 12 MP, bf16 "
              f"tiles -> f32]: host {statistics.median(times) * 1e3:.3f} ms "
              f"(median of 10), device {dev_ms:.3f} ms in {len(kernels)} "
              f"kernels, max |diff| from loop {diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
