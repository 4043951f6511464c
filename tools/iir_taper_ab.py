#!/usr/bin/env python3
"""Times of the IIR passes and of the edgetaper stage on one NVIDIA GPU, at
the shapes BASELINE config 2 gives them, for the polyblur_torch tree in the
current directory.

Run from the root of a checkout: ``python3 tools/iir_taper_ab.py``. Run
from another tree's root (``cd build/parent && python3
../../tools/iir_taper_ab.py``) it times that tree's kernels with the same
inputs, so an A/B of two trees in one call runs parent, change, change,
parent. The inputs are config 2's: the peacock tiled to 1200 x 1600 RGB;
448 px tiles at step 384 on the bf16 canvas (12 tiles).

Prints the card line, then one line per kernel and shape: CUDA-event ms
(the median of three runs of 10 back-to-back calls) and the device time of
the same calls queued behind a device-side sleep (the host's time between
launches excluded):

* the IIR row pass and column pass on the whole 1 x 3 x 1200 x 1600 image
  (config 2c's recursive filter) and on the 12 x 3 x 448^2 tiles (config
  2's dt stage, the column pass writing the noise too);
* the taper stage of one iteration: its weights, then three blurs of the
  smooth planes, each followed by its blend (in the blur's last product
  where the tree folds it, ``spectral_poly(..., taper=)``; else a launch
  of its own); the weights alone; ``spectral_gemm``'s mode 4 on the f32
  canvas alone, with and (where folded) without the blend.

Imports no JAX.
"""

from __future__ import annotations

import inspect
import math
import os
import sys

import numpy as np

# the timing helpers of this tool's own tree, so that every tree is timed
# alike; then the tree under test, the current directory, ahead of it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (card_line, cuda_ms, device_ms,  # noqa: E402
                        make_config2_image)

sys.path.insert(0, os.getcwd())


def show(what: str, fn) -> None:
    print(f"{what}: {cuda_ms(fn):.4f} ms, device {device_ms(fn):.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("iir_taper_ab: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops.cuda import features
    from polyblur_torch.ops.cuda import polyblur_fused as pf
    from polyblur_torch.ops.cuda.iir import (dt_coeffs_plain, scan_cols,
                                             scan_rows)
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.domain_transform import (
        _domain_transform_derivatives)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack, _unit_horner

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    print(f"tree {os.getcwd()}; card {card_line()}")
    img = make_config2_image().transpose(2, 0, 1)[None]
    img = torch.as_tensor(np.ascontiguousarray(img), device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)

    # -- IIR: the whole image (config 2c, sigma_s 2, sigma_r 0.8)
    dh, dv = _domain_transform_derivatives(img, 2.0, 0.8)
    a = math.exp(-math.sqrt(2.0) / 2.0)
    v_h = (a ** dh.double()).float()
    v_v = (a ** dv.double()).float()
    whole = pf.TileView.of_tiles(img)
    rows = scan_rows(whole, v_h)
    show("iir rows 1x3x1200x1600", lambda: scan_rows(whole, v_h))
    show("iir columns 1x3x1200x1600", lambda: scan_cols(rows, v_v))

    # -- IIR: config 2's tiles, the dt stage
    grid = plan_patch_grid(1200, 1600, 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)
    view = pf.TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    vh, vv = dt_coeffs_plain(view, coeffs)
    rows_t = scan_rows(view, vh)
    show(f"iir rows {view.n}x3x448^2 bf16 tiles",
         lambda: scan_rows(view, vh))
    show(f"iir columns {view.n}x3x448^2 + noise",
         lambda: scan_cols(rows_t, vv, src=view))
    smooth, _ = scan_cols(scan_rows(view, vh), vv, src=view)

    # -- taper: weights + 3 blurs, each with its blend
    folded = "taper" in inspect.signature(pf.spectral_poly).parameters
    est = pf.tile_estimate(view, coeffs)
    tabs = pf.stage_tables(448, 448, bf16, str(dev))
    h = wc = tabs.h
    khat2 = pf.kernel_spectrum(est, _unit_horner(str(dev)), tabs)
    su = pf.TileView.of_tiles(smooth)
    xc = torch.empty((view.n, 3, h, wc), dtype=f32, device=dev)

    def blur_blend(u, pad, av, ah):
        if folded:
            pf.spectral_poly(u, khat2, tabs, xc, pad=pad, crop=0, clip=False,
                             out_dtype=f32, taper=(av, ah))
        else:
            ku = pf.spectral_poly(u, khat2, tabs, pad=pad, crop=0,
                                  clip=False, out_dtype=f32)
            features.taper_blend(u, pad, av, ah, ku, xc)

    def stage():
        av, ah = features.taper_weights(est, h, wc)
        u, pad = su, pf.HALF
        for _ in range(3):
            blur_blend(u, pad, av, ah)
            u, pad = pf.TileView.of_tiles(xc), 0

    form = "folded" if folded else "blend launches"
    show(f"taper stage ({form}) {view.n} tiles, weights + 3 blurs + 3 "
         f"blends", stage)
    show("taper weights", lambda: features.taper_weights(est, h, wc))
    av, ah = features.taper_weights(est, h, wc)
    stage()
    cv = pf.TileView.of_tiles(xc)
    show(f"one blur + blend on the canvas ({form})",
         lambda: blur_blend(cv, 0, av, ah))
    mode4 = pf.spectral_gemm_launches(cv, khat2, tabs, None, False,
                                      "mode4_timing", pad=0, crop=0,
                                      out_dtype=f32)[1]
    for run in mode4:
        run()
    show("spectral_gemm mode 4, f32 canvas out", mode4[3])
    if folded:
        mode4t = pf.spectral_gemm_launches(cv, khat2, tabs, xc, False,
                                           "mode4_timing", pad=0, crop=0,
                                           out_dtype=f32,
                                           taper=(av, ah))[1]
        for run in mode4t:
            run()
        show("spectral_gemm mode 4 + taper blend, in place", mode4t[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
