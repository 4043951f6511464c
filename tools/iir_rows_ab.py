#!/usr/bin/env python3
"""Times of the IIR row pass and of the domain-transform prefilter stage on
one NVIDIA GPU, for the polyblur_torch tree in the current directory.

Run from the root of a checkout: ``python3 tools/iir_rows_ab.py [OUT
[REF]]``. Run from another tree's root (``cd build/parent && python3
../../tools/iir_rows_ab.py``) it times that tree's kernels with the same
inputs, so an A/B of two trees in one call runs parent, change, change,
parent. ``OUT`` (a path from the current directory) receives the stage's
outputs at config 2's tiles; with ``REF``, another run's file, the column
map ``v_v`` is compared bit for bit and the row pass's output by its
largest difference.

Shapes (BASELINE config 2's photo: the peacock tiled to 1200 x 1600 RGB):

* ``2mp``: the row pass on the whole 1 x 3 x 1200 x 1600 f32 image with
  one map per image (config 2c's recursive filter, sigma_s 2, sigma_r 0.8);
* ``tiles12``: config 2's 12 x 3 x 448^2 tiles read from the bf16 canvas
  (448 px at step 384): the row pass alone (its map from
  ``dt_coeffs_plain``), the dt maps and the row pass (where the tree has
  ``dt_scan_rows``, its one launch; else ``dt_coeffs`` then
  ``scan_rows``, and ``dt_coeffs`` alone), and the whole stage (maps,
  rows, then the column pass with the noise);
* ``tiles480x512``: the tiles route's dt stage on a 1 x 3 x 480 x 512 f32
  crop of the photo (the route's cap), the same items.

Each line prints CUDA-event ms (the median of three runs of 10
back-to-back calls), the device time of the same calls queued behind a
device-side sleep (the host's time between launches excluded), the byte
bound (each input read once, each output written once, at 3.35 TB/s)
and the largest difference from the tree's plain version. Imports no JAX.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

# the timing helpers of this tool's own tree, so that every tree is timed
# alike; then the tree under test, the current directory, ahead of it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (PEAK_BYTES, card_line, cuda_ms,  # noqa: E402
                        device_ms, make_config2_image)

sys.path.insert(0, os.getcwd())


def show(what: str, fn, nbytes: float, err: float) -> None:
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"{what}: {cuda_ms(fn):.4f} ms, device {device_ms(fn):.4f} ms, "
          f"bound {bound:.4f} ms (bytes), max_abs_err vs plain {err:.3e}")


def maxdiff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("iir_rows_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 3:
        print(__doc__, file=sys.stderr)
        return 2
    from polyblur_torch.ops.cuda import iir
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import TileView
    from polyblur_torch.ops.domain_transform import (
        _domain_transform_derivatives)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    dev = torch.device("cuda")
    fused = hasattr(iir, "dt_scan_rows")
    print(f"tree {os.getcwd()}; card {card_line()}; dt maps "
          f"{'folded into the row pass' if fused else 'a launch of their own'}")
    img = make_config2_image().transpose(2, 0, 1)[None]
    img = torch.as_tensor(np.ascontiguousarray(img), device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)

    # -- the row pass on the whole image, one map for the three channels
    dh, _ = _domain_transform_derivatives(img, 2.0, 0.8)
    v_h = (math.exp(-math.sqrt(2.0) / 2.0) ** dh.double()).float()
    whole = TileView.of_tiles(img)
    err = maxdiff(iir.scan_rows(whole, v_h), iir.scan_rows_plain(whole, v_h))
    show(f"2mp rows {tuple(img.shape)} f32",
         lambda: iir.scan_rows(whole, v_h),
         (2 * img.numel() + v_h.numel()) * 4, err)

    grid = plan_patch_grid(1200, 1600, 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, torch.bfloat16)
    crop = img[..., :480, :512].contiguous()
    saved = {}
    for tag, view, src_bytes in (
            ("tiles12", TileView(canvas, 1, 0, th * tw, tw, (sh, sw),
                                 (448, 448)), canvas.numel() * 2),
            ("tiles480x512", TileView.of_tiles(crop), crop.numel() * 4)):
        n, c = view.n, view.channels
        h, w = view.patch
        out_b, map_b = n * c * h * w * 4, n * h * w * 4
        vh_p, vv_p = iir.dt_coeffs_plain(view, coeffs)
        rows_p = iir.scan_rows_plain(view, vh_p)
        what = f"{n} x {c} x {h} x {w} {str(view.data.dtype)[6:]}"

        err = maxdiff(iir.scan_rows(view, vh_p), rows_p)
        show(f"{tag} rows {what}", lambda: iir.scan_rows(view, vh_p),
             src_bytes + map_b + out_b, err)
        if fused:
            def maps_rows():
                return iir.dt_scan_rows(view, coeffs)

            rows, vv = maps_rows()
            label = "dt_scan_rows (maps + rows, one launch)"
        else:
            vh, vv = iir.dt_coeffs(view, coeffs)
            err = max(maxdiff(vh, vh_p), maxdiff(vv, vv_p))
            show(f"{tag} dt_coeffs {what}",
                 lambda: iir.dt_coeffs(view, coeffs), src_bytes + 2 * map_b,
                 err)

            def maps_rows():
                vh, vv = iir.dt_coeffs(view, coeffs)
                return iir.scan_rows(view, vh), vv

            rows, vv = maps_rows()
            label = "dt_coeffs + scan_rows (two launches)"
        err = max(maxdiff(rows, rows_p), maxdiff(vv, vv_p))
        show(f"{tag} {label} {what}", maps_rows, src_bytes + map_b + out_b,
             err)

        def stage():
            r, v = maps_rows()
            return iir.scan_cols(r, v, src=view)

        sm_p, nz_p = iir.scan_cols_plain(rows_p, vv_p, src=view)
        sm, nz = stage()
        err = max(maxdiff(sm, sm_p), maxdiff(nz, nz_p))
        show(f"{tag} stage (maps, rows, columns + noise) {what}", stage,
             src_bytes + 2 * out_b, err)
        if tag == "tiles12":
            saved = {"v_v": vv.cpu(), "rows": rows.cpu()}

    if len(sys.argv) > 1:
        torch.save(saved, sys.argv[1])
    if len(sys.argv) > 2:
        ref = torch.load(sys.argv[2])
        same = torch.equal(saved["v_v"], ref["v_v"])
        print(f"vs {sys.argv[2]}: v_v bit-equal {same}; rows max diff "
              f"{maxdiff(saved['rows'], ref['rows']):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
