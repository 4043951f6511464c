#!/usr/bin/env python3
"""A/B of ``spectral_gemm`` (``csrc/spectral.cu``) on one NVIDIA GPU: its
f32 dot mode ``'highest'`` kernel against the parent tree's, with the
``'compensated'`` (3xTF32) and bf16 instantiations beside it.

One tree, one process, from the tree's root::

    python3 tools/spectral_highest_ab.py OUT [MODES]

Run from another tree's root (``cd build/parent && python3
../../tools/spectral_highest_ab.py OUT``) it times that tree's kernels with
the same inputs and this tool's timing helpers. It prints, per
instantiation, each product's device time (CUDA events around 10 launches
queued behind a device-side sleep, median of three runs) and its share of
the ``'highest'`` bound (six tf32 products per MAC at the TF32 peak), the
SM clock and power ``nvidia-smi`` reads while the application runs back
to back, and writes ``OUT`` (a torch file): the outputs and their sha256.
``MODES`` (default ``highest,compensated,bf16``) picks the instantiations.

* one application on the 12 MP path's planes (88 tiles x 3 channels of
  448 px at step 384, bench.py's image, on the f32 or bf16 canvas):
  each product's destination (RS, PS, ZZ: the columns the products
  write; the output), then mode 4 with the prefilter's noise;
* the taper's three applications at config 2's 12 tiles (the 1200 x 1600
  photo in the work dtype, config 2b's f32 path in ``'highest'``): the
  canvas after each;
* ``fused_polynomial`` on the 2 MP photo's 180 overlap-save blocks of
  280 x 240 (pad 0: the blocked route) in f32 and bf16, its output and
  its products' times.

Both trees from the change's root, in turns::

    python3 tools/spectral_highest_ab.py --ab build/parent [ROUNDS] [MAIN]

runs this tool in ``build/parent`` and in ``.`` as parent, change,
change, parent, ROUNDS times (default 2: 4 processes a side), writing
under ``build/spectral_ab/``; prints each item's median per tree, and
whether every output of every process is sha256-equal to the parent's
first (the largest difference where not); then ``tools/main_path_ab.py 1
main`` in each tree, MAIN rounds of parent, change, change, parent
(default 5: 10 processes a side), with the median and spread of the 12 MP
bf16 main path's MP/s and its output's sha256. Imports no JAX.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys

import numpy as np

# the timing helpers of this tool's own tree, so that every tree is timed
# alike; then the tree under test, the current directory, ahead of it
TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
from chip_smoke import (PEAK_FLOPS, card_line, device_ms,  # noqa: E402
                        load_png, make_12mp_image, make_config2_image)
from est_highest_ab import ab_trees, line, sha  # noqa: E402

sys.path.insert(0, os.getcwd())

MODES = ("highest", "compensated", "bf16")
PRODUCTS = ("RS", "PS", "ZZ", "out")  # each mode's destination


def smi_under_load(fn, ms: float) -> str:
    """``nvidia-smi``'s power draw and SM clock 1 s into ~2.5 s of ``fn``
    back to back (``ms`` a call)."""
    import torch

    smi = subprocess.Popen(
        ["bash", "-c", "sleep 1; nvidia-smi --query-gpu=power.draw,clocks.sm"
         " --format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    for _ in range(max(10, int(2500 / ms))):
        fn()
    torch.cuda.synchronize()
    return smi.communicate()[0].strip()


def destination(run):
    """The tensor launch ``run`` of ``spectral_gemm_launches`` writes."""
    cells = dict(zip(run.__code__.co_freevars, run.__closure__))
    return cells["dst"].cell_contents


def mode_macs(h: int, wc: int, kp: int, oh: int, ow: int) -> tuple:
    """MACs per plane of the four products as the dense GEMMs the kernels
    run."""
    return (2 * kp * h * wc, kp * 2 * h * 2 * h, 2 * h * kp * 2 * h,
            oh * ow * 2 * kp)


def application_items(key: str, view, q2, tabs, outs: dict, mode: str,
                      clip: bool = True) -> None:
    """One application's products: their outputs, device times, shares of
    the 'highest' bound, and the power under load."""
    import torch

    from polyblur_torch.ops.cuda.polyblur_fused import (
        pad64, spectral_gemm_launches)

    out, runs = spectral_gemm_launches(view, q2, tabs, None, clip,
                                       "spectral_ab")
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
        outs[f"{key}[{mode}].{name}"] = d.clone()
    macs = mode_macs(h, wc, kp, h - 2 * tabs.pad, wc - 2 * tabs.pad)
    total = 0.0
    for i, (run, m) in enumerate(zip(runs, macs), 1):
        ms = device_ms(run)
        total += ms
        bound = 12.0 * m * planes / PEAK_FLOPS["tf32"] * 1e3
        line(f"{key}[{mode}] mode {i}", ms,
             f", {2e-9 * m * planes / ms:.1f} TFLOP/s as dense f32; "
             f"'highest' bound {bound:.4f} ms: {100 * bound / ms:.1f}%")

    def application():
        for run in runs:
            run()

    ms = device_ms(application)
    bound = 12.0 * sum(macs) * planes / PEAK_FLOPS["tf32"] * 1e3
    line(f"{key}[{mode}] application", ms,
         f"; 'highest' bound {bound:.4f} ms: {100 * bound / ms:.1f}%; sum of "
         f"products {total:.4f} ms")
    print(f"  {key}[{mode}] back to back, nvidia-smi power.draw, clocks.sm:"
          f" {smi_under_load(application, ms)}", flush=True)


def spectral_items(dev, outs: dict, modes) -> None:
    """One application on the 12 MP path's 264 planes, and mode 4 with
    noise."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, kernel_spectrum, spectral_poly, stage_tables,
        tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(img.shape[-2], img.shape[-1], 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    f32 = torch.float32
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, f32)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs,
                         stage_tables(448, 448, f32, str(dev)))
    rng = np.random.default_rng(1)
    noise = torch.tensor(rng.standard_normal((view.n, 3, 448, 448)).astype(
        np.float32) * 0.01, device=dev)
    for mode in modes:
        wd = torch.bfloat16 if mode == "bf16" else f32
        cv = canvas if wd == f32 else edge_pad_cast(img, grid.orig_size,
                                                    grid.pad, wd)
        v = TileView(cv, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        tabs = stage_tables(448, 448, wd, str(dev))
        with f32_dot_mode_scope("compensated" if mode == "bf16" else mode):
            application_items("spectral_gemm", v, q2, tabs, outs, mode)
            o = spectral_poly(v, q2, tabs, noise=noise, out_dtype=f32)
            torch.cuda.synchronize()
            outs[f"spectral_gemm[{mode}].out+noise"] = o.clone()
        del cv, v, o
        torch.cuda.empty_cache()


def taper_items(dev, outs: dict, modes) -> None:
    """The taper's three applications at config 2's 12 tiles, each blended
    in its mode 4's epilogue."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.features import taper_weights
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        HALF, TileView, kernel_spectrum, spectral_poly, stage_tables,
        tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack, _unit_horner

    img = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                          .copy(), device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(1200, 1600, 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    f32 = torch.float32
    h = wc = 448 + 2 * HALF
    for mode in modes:
        wd = torch.bfloat16 if mode == "bf16" else f32
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, wd)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        tabs = stage_tables(448, 448, wd, str(dev))
        with f32_dot_mode_scope("compensated" if mode == "bf16" else mode):
            est = tile_estimate(view, coeffs)
            khat2 = kernel_spectrum(est, _unit_horner(str(dev)), tabs)
            av, ah = taper_weights(est, h, wc)
            xc = torch.empty((view.n, 3, h, wc), dtype=f32, device=dev)

            def taper(record=False):
                u, pad = view, HALF
                for k in range(3):
                    spectral_poly(u, khat2, tabs, xc, pad=pad, crop=0,
                                  clip=False, out_dtype=f32, taper=(av, ah))
                    if record:
                        torch.cuda.synchronize()
                        outs[f"taper[{mode}].xc{k}"] = xc.clone()
                    u, pad = TileView.of_tiles(xc), 0

            taper(True)
            line(f"taper[{mode}] three applications", device_ms(taper))
        del canvas, view, xc
        torch.cuda.empty_cache()


def blocked_items(dev, outs: dict, modes) -> None:
    """fused_polynomial on the 2 MP photo's overlap-save blocks."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.estimation import gaussian_blur_estimation
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.polyblur_fused import (spectrum_plain,
                                                        stage_tables)
    from polyblur_torch.ops.cuda.sep_poly_fused import fused_polynomial
    from polyblur_torch.pipeline import _mega_pack

    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    photo = torch.as_tensor(load_png("tests/data/corpus_hr/peacock_tiled.png")
                            .transpose(2, 0, 1)[None].copy(), device=dev)
    sig, rho, theta = gaussian_blur_estimation(photo, c=0.362, b=0.468,
                                               return_2d_filters=False)
    qf = sep_poly.gaussian_quadratic_coeffs(sig[:, 0], rho[:, 0], theta[:, 0])
    for mode in modes:
        wd = torch.bfloat16 if mode == "bf16" else torch.float32
        view, (th, _, tw, _, _) = sep_poly._block_view(photo[0].to(wd), 12)
        params = torch.stack(qf, -1).repeat(3, 1).repeat(th * tw, 1)
        bh, bw = view.patch
        tabs = stage_tables(bh, bw, wd, str(dev), 0)
        q2 = spectrum_plain(params[:, 0], params[:, 1], params[:, 2], coeffs,
                            tabs)
        with f32_dot_mode_scope("compensated" if mode == "bf16" else mode):
            out = fused_polynomial(view, params, coeffs)
            torch.cuda.synchronize()
            outs[f"fused_polynomial[{mode}]"] = out.clone()
            line(f"fused_polynomial[{mode}] call",
                 device_ms(lambda: fused_polynomial(view, params, coeffs)),
                 f" ({view.n} blocks {bh}x{bw}, pad 0)")
            application_items("blocks", view, q2, tabs, outs, mode,
                              clip=False)
        del view, out
        torch.cuda.empty_cache()


def one_tree(out_path: str, modes=MODES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("spectral_highest_ab: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops import cuda as pcuda

    logs = pcuda.build()
    for name, log in logs.items():  # ptxas' report of a fresh build
        for ln in log.splitlines():
            if name == "spectral" and re.search(
                    r"Compiling entry|registers|spill|warning|C75", ln):
                print(f"  ptxas {name}: {ln.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"tree {os.getcwd()}; card {card_line()}; torch "
          f"{torch.__version__}", flush=True)
    outs: dict = {}
    spectral_items(dev, outs, modes)
    taper_items(dev, outs, modes)
    blocked_items(dev, outs, modes)
    digests = {k: sha(v) for k, v in outs.items()}
    for k, d in digests.items():
        print(f"  sha256 {k}: {d[:16]}")
    torch.save({"sha": digests, "out": {k: v.cpu() for k, v in
                                         outs.items()}}, out_path)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--ab":
        rounds = int(args[2]) if len(args) > 2 else 2
        mains = int(args[3]) if len(args) > 3 else 5
        return ab_trees(os.path.abspath(__file__), "build/spectral_ab",
                        args[1], rounds, mains)
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    return one_tree(args[0], args[1].split(",") if len(args) > 1 else MODES)


if __name__ == "__main__":
    sys.exit(main())
