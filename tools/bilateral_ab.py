#!/usr/bin/env python3
"""Times and outputs of the bilateral kernel on one NVIDIA GPU, for the
polyblur_torch tree in the current directory.

Run from the root of a checkout: ``python3 tools/bilateral_ab.py OUT
[REF]``. Run from another tree's root (``cd build/parent && python3
../../tools/bilateral_ab.py OUT [REF]``) it times that tree's kernel with
the same inputs, so an A/B of two trees in one call runs parent, change,
change, parent. ``OUT`` (a path from the current directory) receives the
kernel's outputs; with ``REF``, another run's file, each output is
compared with the same output there bit for bit.

Shapes, with the bilateral prefilter's arguments (5 x 5, sigma_s 5,
sigma_c 0.1):

* ``2mp``: the whole 1 x 3 x 1200 x 1600 f32 image (the peacock tiled, as
  BASELINE config 2), f32 out: the scan route's prefilter;
* ``tiles12``: config 2's 12 x 3 x 448^2 tiles read from the bf16 canvas
  (448 px at step 384), f32 smooth and noise: the staged route's stage;
* ``tiles88``: the 12 MP main path's 88 x 3 x 448^2 tiles (bench.py's
  image, seed 0, 448 px at step 384) from the bf16 canvas, f32 smooth and
  noise: the stage of the 12 MP path with the default prefilter.

Each prints CUDA-event ms (the median of three runs of 10 back-to-back
calls) and the device time of the same calls queued behind a device-side
sleep. The outputs compared bit for bit are those three shapes' and, on seeded uniform
inputs, planes of 1 x 1, 2 x 3, 5 x 5, 7 x 33 and 301 x 419 in f32 and
bf16 (f32 out, with the noise). Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# the timing helpers of this tool's own tree, so that every tree is timed
# alike; then the tree under test, the current directory, ahead of it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (card_line, cuda_ms, device_ms,  # noqa: E402
                        make_12mp_image, make_config2_image)

sys.path.insert(0, os.getcwd())

SMALL = ((1, 1), (2, 3), (5, 5), (7, 33), (301, 419))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bilateral_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    from polyblur_torch.ops.cuda.bilateral import bilateral
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import TileView
    from polyblur_torch.patches import _grid_steps, plan_patch_grid

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    print(f"tree {os.getcwd()}; card {card_line()}")

    def tiles(img, overlap):
        h, w = img.shape[-2:]
        grid = plan_patch_grid(h, w, 448, overlap)
        th, tw, sh, sw = _grid_steps(grid)
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)
        return TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))

    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    img12 = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                            device=dev)
    cases = {"2mp": (TileView.of_tiles(img2), {}),
             "tiles12": (tiles(img2, 1.0 / 7.0),
                         dict(out_dtype=f32, with_noise=True)),
             "tiles88": (tiles(img12, 64.0 / 448.0),
                         dict(out_dtype=f32, with_noise=True))}
    del img12
    outs = {}
    for name, (view, kw) in cases.items():
        def call(kw=kw, view=view):
            return bilateral(view, **kw)

        got = call()
        outs[name] = got if isinstance(got, tuple) else (got,)
        what = (f"{view.n} x {view.channels} x {view.patch[0]} x "
                f"{view.patch[1]} {str(view.data.dtype)[6:]}")
        print(f"bilateral {name} [{what}]: {cuda_ms(call):.4f} ms, "
              f"device {device_ms(call):.4f} ms")
    rng = np.random.default_rng(12)
    for h, w in SMALL:
        x = rng.uniform(0.0, 1.0, (2, 3, h, w)).astype(np.float32)
        for dt in (f32, bf16):
            t = torch.as_tensor(x, device=dev).to(dt)
            outs[f"rand {h}x{w} {str(dt)[6:]}"] = bilateral(
                TileView.of_tiles(t), out_dtype=f32, with_noise=True)
    torch.cuda.synchronize()
    outs = {k: tuple(t.cpu() for t in v) for k, v in outs.items()}
    os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
    torch.save(outs, sys.argv[1])
    if len(sys.argv) == 3:
        ref = torch.load(sys.argv[2])
        for k, v in outs.items():
            r = ref[k]
            same = all(torch.equal(a.view(torch.int32) if a.dtype == f32
                                   else a, b.view(torch.int32)
                                   if b.dtype == f32 else b)
                       for a, b in zip(v, r))
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(v, r))
            print(f"  {k}: bit-equal to {sys.argv[2]}'s: {same} "
                  f"(max abs diff {diff:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
