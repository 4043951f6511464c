#!/usr/bin/env python3
"""A/B of the estimate's derivative GEMM (``csrc/estimate.cu``) on one
NVIDIA GPU: its f32 dot mode ``'highest'`` case against the parent tree's,
with the ``'compensated'`` and bf16 instantiations beside it.

One tree, one process, from the tree's root::

    python3 tools/est_highest_ab.py OUT

Run from another tree's root (``cd build/parent && python3
../../tools/est_highest_ab.py OUT``) it times that tree's kernels with the
same inputs and this tool's timing helpers. It prints, per instantiation,
each launch's device time (CUDA events around 10 calls queued behind a
device-side sleep, median of three runs) and writes ``OUT`` (a torch file):
the outputs and their sha256.

* ``tile_estimate`` on the 12 MP path's tiles (88 x 3 x 448^2, 448 px at
  step 384 on the f32 or bf16 canvas of bench.py's image): its four
  launches (gray min/max, normalize, GEMM, final), the call, the GEMM's
  share of its ``'highest'`` bound (six tf32 products per MAC at the TF32
  peak); outputs ``est`` (all 8 columns) and ``maxima``;
* the halo at BASELINE config 2's tiles (12 x 3 x 448^2 of the 1200 x
  1600 photo): the gradients (epilogue 1) and one mask (epilogue 2) of
  the bilateral set's restored planes; outputs ``gx``, ``gy``, ``part``,
  ``mask``;
* ``directional_maxima`` (mode-free) on a 1 x 3 x 480 x 640 crop of the
  photo, f32 and bf16.

Both trees from the change's root, in turns::

    python3 tools/est_highest_ab.py --ab build/parent [ROUNDS] [MAIN]

runs this tool in ``build/parent`` and in ``.`` as parent, change,
change, parent, ROUNDS times (default 2: 4 processes a side), writing
under ``build/est_ab/``; prints each item's median per tree and whether
every output of every process is sha256-equal to the parent's first (the
largest difference where not); then ``tools/main_path_ab.py 1 main`` in
each tree, MAIN rounds of parent, change, change, parent (default 5: 10
processes a side), with the median and spread of the 12 MP bf16 main
path's MP/s and its output's sha256.
Imports no JAX.
"""

from __future__ import annotations

import hashlib
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
from chip_smoke import (PEAK_BYTES, PEAK_FLOPS, card_line,  # noqa: E402
                        cuda_ms, device_ms, gemm_pair_library_ms,
                        make_12mp_image, make_config2_image)

sys.path.insert(0, os.getcwd())

STAGES = ("minmax", "normalize", "gemm", "final")
MODES = ("highest", "compensated", "bf16")


def sha(t) -> str:
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def line(key: str, ms: float, extra: str = "") -> None:
    print(f"[{key}] {ms:.4f} ms{extra}", flush=True)


def estimate_items(dev, outs: dict) -> None:
    """tile_estimate's launches on the 12 MP path's 88 tiles."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, _gray_norm_plain, estimate_launches, tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(img.shape[-2], img.shape[-1], 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    for mode in MODES:
        wd = torch.bfloat16 if mode == "bf16" else torch.float32
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, wd)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        with f32_dot_mode_scope("compensated" if mode == "bf16" else mode):
            maxima, est, runs = estimate_launches(view, "est_ab", coeffs)
            for run in runs:
                run()
            torch.cuda.synchronize()
            outs[f"tile_estimate[{mode}].est"] = est.clone()
            outs[f"tile_estimate[{mode}].maxima"] = maxima.clone()
            ms = {k: device_ms(run) for k, run in zip(STAGES, runs)}
            call = cuda_ms(lambda: tile_estimate(view, coeffs))
        n = view.n
        macs = n * 448 * 448 * (448 + 448)
        # the GEMM reads g and g^T (one f32 plane each for 'highest', hi
        # and lo otherwise) once; six (three) tf32 products per MAC
        pieces = 1 if mode == "highest" else 2
        bound_b = 2 * pieces * n * 448 * 448 * 4 / PEAK_BYTES * 1e3
        bound_o = (12.0 if mode == "highest" else 6.0) * macs / \
            PEAK_FLOPS["tf32"] * 1e3
        bound = max(bound_b, bound_o)
        for k in STAGES:
            extra = ""
            if k == "gemm":
                extra = (f", {2e-9 * macs / ms[k]:.1f} TFLOP/s as dense f32,"
                         f" bound {bound:.4f} ms "
                         f"({'operations' if bound_o >= bound_b else 'bytes'}"
                         f"): {100 * bound / ms[k]:.1f}% of it")
            line(f"tile_estimate[{mode}] {k}", ms[k], extra)
        line(f"tile_estimate[{mode}] sum of launches", sum(ms.values()))
        line(f"tile_estimate[{mode}] call", call,
             " (CUDA events, 10 calls back to back)")
        if mode == "highest":
            line("tile_estimate library", gemm_pair_library_ms(
                _gray_norm_plain(view)), " (torch.matmul of the f32 pair)")
        del canvas, view, maxima, est, runs
        torch.cuda.empty_cache()


def halo_items(dev, outs: dict) -> None:
    """The halo's two epilogues at config 2's 12 tiles."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.bilateral import bilateral
    from polyblur_torch.ops.cuda.features import halo_grads, halo_mask
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, kernel_spectrum, spectral_poly, stage_tables,
        tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    img = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                          .copy(), device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(1200, 1600, 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    f32 = torch.float32
    for mode in MODES:
        wd = torch.bfloat16 if mode == "bf16" else f32
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, wd)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        with f32_dot_mode_scope("compensated" if mode == "bf16" else mode):
            smooth, nz = bilateral(view, out_dtype=wd, with_noise=True)
            sv = TileView.of_tiles(smooth)
            tabs = stage_tables(448, 448, wd, str(dev))
            q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs, tabs)
            o = spectral_poly(sv, q2, tabs, clip=False, out_dtype=f32)
            grads = halo_grads(view)
            out = torch.empty_like(o, dtype=wd)
            halo_mask(o, grads, sv, nz, out)
            torch.cuda.synchronize()
            for k in ("gx", "gy", "part"):
                outs[f"halo[{mode}].{k}"] = getattr(grads, k).clone()
            outs[f"halo[{mode}].mask"] = out.clone()
            g_ms = device_ms(lambda: halo_grads(view))
            m_ms = device_ms(lambda: halo_mask(o, grads, sv, nz, out))
        line(f"halo[{mode}] gradients", g_ms)
        line(f"halo[{mode}] mask", m_ms)
        line(f"halo[{mode}] gradients + mask", g_ms + m_ms)
        if mode == "highest":
            line("halo library", gemm_pair_library_ms(view.tiles().float())
                 + gemm_pair_library_ms(o), " (torch.matmul of the f32 "
                 "pairs on the input planes and on o)")
        del canvas, view, smooth, nz, sv, o, grads, out
        torch.cuda.empty_cache()


def maxima_items(dev, outs: dict) -> None:
    """directional_maxima (mode-free) on a 480 x 640 crop."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.est_fused import directional_maxima

    crop = torch.as_tensor(make_config2_image()[:480, :640]
                           .transpose(2, 0, 1)[None].copy(), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        x = crop.to(dt)
        tag = str(dt)[6:]
        for mode in ("highest", "compensated"):
            with f32_dot_mode_scope(mode):
                outs[f"directional_maxima[{tag}, {mode}]"] = \
                    directional_maxima(x).clone()
        line(f"directional_maxima[{tag}] call",
             device_ms(lambda: directional_maxima(x)))


def one_tree(out_path: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("est_highest_ab: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops import cuda as pcuda

    logs = pcuda.build()
    for name, log in logs.items():  # ptxas' report of a fresh build
        for ln in log.splitlines():
            if name == "estimate" and re.search(
                    r"Compiling entry|registers|spill|warning|C75", ln):
                print(f"  ptxas {name}: {ln.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"tree {os.getcwd()}; card {card_line()}; torch "
          f"{torch.__version__}", flush=True)
    outs: dict = {}
    estimate_items(dev, outs)
    halo_items(dev, outs)
    maxima_items(dev, outs)
    digests = {k: sha(v) for k, v in outs.items()}
    for k, d in digests.items():
        print(f"  sha256 {k}: {d[:16]}")
    torch.save({"sha": digests, "out": {k: v.cpu() for k, v in
                                         outs.items()}}, out_path)
    return 0


def run(cmd, cwd) -> str:
    res = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    sys.stdout.write(res.stdout)
    if res.returncode != 0:
        sys.stdout.write(res.stderr[-4000:])
        raise SystemExit(f"{cmd} in {cwd} exited with {res.returncode}")
    return res.stdout


def ab_trees(tool: str, outdir: str, parent: str, rounds: int,
             mains: int) -> int:
    """Run ``tool OUT`` in the parent tree and in ``.`` as parent, change,
    change, parent, ``rounds`` times, with the OUT files under ``outdir``;
    print each timed line's median per tree and the sha256 comparison of
    every output; then ``mains`` rounds of ``tools/main_path_ab.py 1
    main``. 0 when every output is sha256-equal to the parent's."""
    import torch

    outdir = os.path.abspath(outdir)
    os.makedirs(outdir, exist_ok=True)
    trees = {"parent": os.path.abspath(parent), "change": os.getcwd()}
    times = {"parent": {}, "change": {}}
    files = {"parent": [], "change": []}
    order = ("parent", "change", "change", "parent") * rounds
    for i, side in enumerate(order):
        path = os.path.join(outdir, f"{side}{i}.pt")
        print(f"== {side} (process {i + 1} of {len(order)})", flush=True)
        text = run([sys.executable, tool, path], trees[side])
        files[side].append(path)
        for key, ms in re.findall(r"^\[(.+?)\] ([0-9.]+) ms", text, re.M):
            times[side].setdefault(key, []).append(float(ms))
    print("== medians over the processes (parent -> change)")
    for key in times["change"]:
        p = statistics.median(times["parent"].get(key, [float("nan")]))
        c = statistics.median(times["change"][key])
        print(f"{key}: {p:.4f} -> {c:.4f} ms ({c / p:.3f}x; change "
              f"{min(times['change'][key]):.4f}-"
              f"{max(times['change'][key]):.4f}, parent "
              f"{min(times['parent'].get(key, [p])):.4f}-"
              f"{max(times['parent'].get(key, [p])):.4f})")
    ref = torch.load(files["parent"][0])
    runs = [torch.load(f) for f in files["parent"][1:] + files["change"]]
    equal = True
    for k in sorted(runs[-1]["sha"]):
        same = all(r["sha"].get(k) == ref["sha"].get(k) for r in runs)
        equal &= same
        diff = "" if same or k not in ref["out"] else (
            ", max abs diff " + f"{max(float((r['out'][k].float() - ref['out'][k].float()).abs().max()) for r in runs):.3e}")
        print(f"sha256 {k}: {'equal' if same else 'DIFFERS'}{diff}")
    print(f"every output sha256-equal to the parent's: {equal}")
    if mains < 1:
        return 0 if equal else 1
    main_tool = os.path.join(os.path.dirname(tool), "main_path_ab.py")
    mps = {"parent": [], "change": []}
    digests = {"parent": set(), "change": set()}
    for side in ("parent", "change", "change", "parent") * mains:
        text = run([sys.executable, main_tool, "1", "main"], trees[side])
        mps[side] += [float(v) for v in re.findall(r"= ([0-9.]+) MP/s",
                                                   text)]
        digests[side] |= set(re.findall(r"output sha256 (\w+)", text))
    for side in ("parent", "change"):
        v = mps[side]
        print(f"main path 12 MP bf16 [{side}]: median "
              f"{statistics.median(v):.2f} MP/s over {len(v)} processes "
              f"({min(v):.2f}-{max(v):.2f}); output sha256 "
              f"{sorted(digests[side])}")
    print(f"main path outputs equal: {digests['parent'] == digests['change']}"
          )
    return 0 if equal else 1


def main() -> int:
    args = sys.argv[1:]
    if len(args) >= 2 and args[0] == "--ab":
        rounds = int(args[2]) if len(args) > 2 else 2
        mains = int(args[3]) if len(args) > 3 else 5
        return ab_trees(os.path.abspath(__file__), "build/est_ab", args[1],
                        rounds, mains)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    return one_tree(args[0])


if __name__ == "__main__":
    sys.exit(main())
