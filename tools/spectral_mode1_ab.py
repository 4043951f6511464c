#!/usr/bin/env python3
"""A/B of ``spectral_gemm``'s first product (``csrc/spectral.cu`` mode 1)
on one NVIDIA GPU in a bf16 work dtype: the tree's feed of the tiles
against the parent tree's, at the benchmark's shapes (upstream's 400 px
grid at step 300).

One tree, one process, from the tree's root::

    python3 tools/spectral_mode1_ab.py OUT

Run from another tree's root (``cd build/parent && python3
../../tools/spectral_mode1_ab.py OUT``) it times that tree's kernels with
the same inputs and this tool's helpers. Per item it prints each product's
device time (CUDA events around 10 launches queued behind a device-side
sleep, median of three runs), its TFLOP/s as the dense GEMM the kernel
runs and its share of the 989 TFLOP/s bf16 peak, and mode 1's feed as the
tree counts it (``_build.feeds``, ``none`` where the tree has no such
counter); then writes ``OUT`` (a torch file): each product's output (RS,
PS, ZZ: the columns written; the application's output) and their sha256.

* ``12mp.canvas``: the 12 MP photo's 130 tiles x 3 channels cut from its
  bf16 canvas (3100 x 4000) at their grid origins, the first iteration's
  application;
* ``12mp.iterate``: the same tiles as the iterate's planes (130, 3, 400,
  400) bf16, the later iterations';
* ``pad0.pitch848``, ``pad0.pitch896``: those planes replicate-padded to
  424 x 424 as the canvas itself (pad 0), rows 848 bytes apart, and 896
  (each box row one whole 128-byte line);
* ``flags.smooth``, ``batch8.smooth``: the flags cells' f32 tiles (20 and
  160 of 400 px: the prefilter's smooth part) padded by 12, as the taper's
  first application reads them, f32 out;
* ``flags.taper``, ``batch8.taper``: the taper's later applications, the
  f32 (n, 3, 424, 424) canvas at pad 0, blended in mode 4's epilogue;
* ``flags.taper_bf16``, ``batch8.taper_bf16`` (in a tree whose
  ``spectral_gemm_launches`` takes ``view1``): the same as the pipeline
  runs them, the first product reading the canvas's bf16 copy and the
  last writing one besides.

Both trees from the change's root, in turns::

    python3 tools/spectral_mode1_ab.py --ab build/parent [ROUNDS]

runs this tool in ``build/parent`` and in ``.`` as parent, change,
change, parent, ROUNDS times (default 2), writing under
``build/mode1_ab/``; prints each item's median per tree, and whether every
output of every process is sha256-equal to the parent's first (the
largest difference where not). Imports no JAX.
"""

from __future__ import annotations

import inspect
import os
import re
import sys

import numpy as np

# the helpers of this tool's own tree, so that every tree is timed alike;
# then the tree under test, the current directory, ahead of it
TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)
from chip_smoke import (PEAK_FLOPS, card_line, device_ms,  # noqa: E402
                        make_12mp_image, make_config2_image)
from est_highest_ab import ab_trees, line, sha  # noqa: E402
from spectral_highest_ab import destination, mode_macs  # noqa: E402

sys.path.insert(0, os.getcwd())

PRODUCTS = ("RS", "PS", "ZZ", "out")  # each mode's destination
COEFFS = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)


def feeds_now() -> dict:
    from polyblur_torch.ops.cuda import _build

    return dict(getattr(_build, "feeds", {}))


def application_items(key: str, view, q2, tabs, outs: dict, pad: int,
                      crop: int, out_dtype, taper=None, out=None,
                      **kw) -> None:
    """One application's products: their outputs and device times (``kw``:
    further keywords of ``spectral_gemm_launches``)."""
    import torch

    from polyblur_torch.ops.cuda.polyblur_fused import (
        pad64, spectral_gemm_launches)

    f0 = feeds_now()
    out, runs = spectral_gemm_launches(view, q2, tabs, out, False,
                                       "mode1_ab", pad, crop, None,
                                       out_dtype, taper, **kw)
    h, wc, kp = tabs.h, tabs.wc, tabs.er.shape[1]
    planes = view.n * view.channels
    shapes = ((planes, kp, pad64(2 * h)), (planes, kp, pad64(2 * h)),
              (planes, h, 2 * kp), None)
    for name, run, shape in zip(PRODUCTS, runs, shapes):
        run()
        torch.cuda.synchronize()
        d = destination(run)
        if shape is not None:  # the columns the product writes
            d = d[:planes * shape[1] * shape[2]].view(shape)
            d = d[..., :2 * h] if name != "ZZ" else d
        outs[f"{key}.{name}"] = d.clone()
    f1 = feeds_now()
    feed = ",".join(k for k in sorted(f1) if f1[k] > f0.get(k, 0)) or "none"
    oh, ow = h - 2 * crop, wc - 2 * crop
    macs = mode_macs(h, wc, kp, oh, ow)
    total = 0.0
    for i, (run, m) in enumerate(zip(runs, macs), 1):
        ms = device_ms(run)
        total += ms
        tf = 2e-9 * m * planes / ms
        line(f"{key} mode {i}", ms,
             f", {tf:.1f} TFLOP/s, {100e12 * tf / PEAK_FLOPS['bf16']:.1f}% "
             f"of the bf16 peak" + (f"; feed {feed}" if i == 1 else ""))
    line(f"{key} sum of products", total, f" ({planes} planes)")


def photo12mp_items(dev, outs: dict) -> None:
    import torch

    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, kernel_spectrum, stage_tables, tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    coeffs = _mega_pack(*COEFFS, device=dev)
    grid = plan_patch_grid(3000, 4000, 400, 0.25)
    th, tw, sh, sw = _grid_steps(grid)
    bf16 = torch.bfloat16
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (400, 400))
    tabs = stage_tables(400, 400, bf16, str(dev))
    q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs, tabs)
    application_items("12mp.canvas", view, q2, tabs, outs, 12, 12, bf16)
    planes = view.tiles().contiguous()
    application_items("12mp.iterate", TileView.of_tiles(planes), q2, tabs,
                      outs, 12, 12, bf16)
    # the same planes padded onto their canvas (pad 0), rows 848 bytes
    # apart, and 896 (whole 128-byte lines: every box row one line)
    tabs0 = stage_tables(424, 424, bf16, str(dev), 0)
    canvas = torch.nn.functional.pad(planes, (12,) * 4, mode="replicate")
    wide = torch.zeros(canvas.shape[:3] + (448,), dtype=bf16, device=dev)
    wide[..., :424] = canvas
    for key, src in (("pad0.pitch848", canvas.contiguous()),
                     ("pad0.pitch896", wide[..., :424])):
        application_items(key, TileView.of_tiles(src), q2, tabs0, outs, 0,
                          0, bf16)


def flags_items(dev, outs: dict, photos: int) -> None:
    """The flags cells' f32 sources of mode 1, ``photos`` photos of 20
    tiles."""
    import torch

    from polyblur_torch.ops.cuda.features import taper_weights
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        HALF, TileView, kernel_spectrum, stage_tables, tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack, _unit_horner

    img = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                          .copy(), device=dev).repeat(photos, 1, 1, 1)
    coeffs = _mega_pack(*COEFFS, device=dev)
    grid = plan_patch_grid(1200, 1600, 400, 0.25)
    th, tw, sh, sw = _grid_steps(grid)
    bf16, f32 = torch.bfloat16, torch.float32
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)
    view = TileView(canvas, photos, 0, th * tw * photos, tw, (sh, sw),
                    (400, 400))
    tabs = stage_tables(400, 400, bf16, str(dev))
    est = tile_estimate(view, coeffs)
    khat2 = kernel_spectrum(est, _unit_horner(str(dev)), tabs)
    h = wc = 400 + 2 * HALF
    av, ah = taper_weights(est, h, wc)
    smooth = view.tiles().float().contiguous()
    key = "flags" if photos == 1 else f"batch{photos}"
    xc = torch.empty((view.n, 3, h, wc), dtype=f32, device=dev)
    application_items(f"{key}.smooth", TileView.of_tiles(smooth), khat2,
                      tabs, outs, HALF, 0, f32, (av, ah), xc)
    application_items(f"{key}.taper", TileView.of_tiles(xc.clone()), khat2,
                      tabs, outs, 0, 0, f32, (av, ah))
    # the pipeline's taper from its second application on, where the tree
    # has it: the first product reads the canvas's bf16 copy, the last
    # writes one
    from polyblur_torch.ops.cuda.polyblur_fused import spectral_gemm_launches
    if "view1" in inspect.signature(spectral_gemm_launches).parameters:
        own: dict = {}
        application_items(f"{key}.taper_bf16", TileView.of_tiles(xc.clone()),
                          khat2, tabs, own, 0, 0, f32, (av, ah),
                          rounded=torch.empty_like(xc, dtype=bf16),
                          view1=TileView.of_tiles(xc.to(bf16)))
        same = all(torch.equal(v, outs[k.replace("taper_bf16", "taper")])
                   for k, v in own.items())
        print(f"  {key}.taper_bf16: every product's output equal to "
              f"{key}.taper's: {same}", flush=True)


def one_tree(out_path: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("spectral_mode1_ab: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops import cuda as pcuda

    logs = pcuda.build()
    for name, log in logs.items():  # ptxas' report of a fresh build
        for ln in log.splitlines():
            if name == "spectral" and re.search(
                    r"Compiling entry|registers|spill|warning|C75", ln):
                print(f"  ptxas {name}: {ln.strip()}")
    dev = torch.device("cuda")
    print(f"tree {os.getcwd()}; card {card_line()}; torch "
          f"{torch.__version__}", flush=True)
    outs: dict = {}
    photo12mp_items(dev, outs)
    torch.cuda.empty_cache()
    flags_items(dev, outs, 1)
    flags_items(dev, outs, 8)
    digests = {k: sha(v) for k, v in outs.items()}
    for k, d in digests.items():
        print(f"  sha256 {k}: {d[:16]}")
    # the outputs themselves where small enough to keep beside their
    # digests (the difference where a digest differs)
    torch.save({"sha": digests, "out": {
        k: v.cpu() for k, v in outs.items()
        if v.numel() * v.element_size() < 64 << 20}}, out_path)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--ab":
        rounds = int(args[2]) if len(args) > 2 else 2
        return ab_trees(os.path.abspath(__file__), "build/mode1_ab", args[1],
                        rounds, 0)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    return one_tree(args[0])


if __name__ == "__main__":
    sys.exit(main())
