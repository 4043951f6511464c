#!/usr/bin/env python3
"""Throughput of the tensor cores' tf32 ``wgmma`` at the estimate GEMM's
shapes, on one NVIDIA GPU: ``python3 tools/wgmma_tf32_probe.py`` from the
repository root.

Builds ``tools/wgmma_tf32_probe.cu`` with ``nvcc`` (the flags of
``polyblur_torch/ops/cuda/_build.py``) into ``build/probe/`` and times, for
m64n64k8 (A from shared memory or from registers) and m64n128k8, with 1, 2
or 4 independent accumulator chains per warpgroup and 1 or 2 warpgroups
per block (132 blocks), groups of 24 products per chain each waited for,
as the GEMM's K steps are, on operands of zeros and of values in [1, 2)
with hashed mantissas. Prints the CUDA-event time, TFLOP/s against the
card's 495 TFLOP/s tf32 peak and the clocks per product per warpgroup at
1.755 GHz; then, for the estimate's case (m64n64k8, one chain, 2
warpgroups) on both operand sets, the SM clock and power that
``nvidia-smi`` reads while the kernel runs back to back for ~2 s; and the
same reading while the estimate's derivative GEMM (``csrc/estimate.cu``
stage 3 on the 12 MP path's 88 f32 tiles, ``'highest'`` and
``'compensated'``) runs back to back. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2000
CASES = [(64, 1, 0), (64, 2, 0), (64, 4, 0), (64, 1, 1), (64, 2, 1),
         (128, 1, 0), (128, 2, 0)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wgmma_tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libwgmma_tf32_probe.so")
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I",
                    os.path.join(ROOT, "polyblur_torch", "csrc"), "-o",
                    lib_path, os.path.join(ROOT, "tools",
                                           "wgmma_tf32_probe.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.mb_run.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    out = torch.empty(132 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card {card}")
    runs = [(c, w, r) for r in (0, 1) for c in CASES for w in (1, 2)]
    for (n, ch, rs), wgs, rnd in runs:
        err = lib.mb_run(n, ch, rs, wgs, 10, rnd, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        lib.mb_run(n, ch, rs, wgs, ITERS, rnd, out.data_ptr(), stream)
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e)
        flops = 2.0 * 64 * n * 8 * 24 * ch * ITERS * wgs * 132
        clk = ms * 1e-3 * 1.755e9 / (24 * ch * ITERS)
        print(f"[{'hashed' if rnd else 'zeros'}] "
              f"m64n{n}k8 {'RS' if rs else 'SS'}, {ch} chain(s), {wgs} "
              f"warpgroup(s): {ms:.3f} ms, {flops / ms / 1e9:.1f} "
              f"TFLOP/s ({100 * flops / ms / 1e9 / 495:.0f}% of 495), "
              f"{clk:.1f} clk per product per warpgroup", flush=True)
    for rnd in (0, 1):
        for _ in range(5):
            lib.mb_run(64, 1, 0, 2, ITERS, rnd, out.data_ptr(), stream)
        smi = subprocess.Popen(
            ["bash", "-c", "sleep 1; nvidia-smi --query-gpu=clocks.sm,"
             "power.draw --format=csv,noheader"], stdout=subprocess.PIPE,
            text=True)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(60):
            lib.mb_run(64, 1, 0, 2, ITERS, rnd, out.data_ptr(), stream)
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / 60
        flops = 2.0 * 64 * 64 * 8 * 24 * ITERS * 2 * 132
        print(f"[{'hashed' if rnd else 'zeros'}] m64n64k8 SS, 1 chain, 2 "
              f"warpgroups, back to back: {ms:.3f} ms per launch, "
              f"{flops / ms / 1e9:.1f} TFLOP/s; nvidia-smi during the run: "
              f"{smi.communicate()[0].strip()}", flush=True)
    estimate_under_load(torch)
    return 0


def estimate_under_load(torch) -> None:
    """The estimate GEMM back to back with the clock and power read."""
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import make_12mp_image
    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (TileView,
                                                        estimate_launches)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid

    dev = torch.device("cuda")
    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    grid = plan_patch_grid(3000, 4000, 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, torch.float32)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    for mode in ("highest", "compensated"):
        with f32_dot_mode_scope(mode):
            _, _, runs = estimate_launches(view, "probe")
            for run in runs[:3]:
                run()
            torch.cuda.synchronize()
            smi = subprocess.Popen(
                ["bash", "-c", "sleep 1; nvidia-smi --query-gpu=clocks.sm,"
                 "power.draw --format=csv,noheader"], stdout=subprocess.PIPE,
                text=True)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(3000):
                runs[2]()
            e.record()
            e.synchronize()
        print(f"estimate GEMM [{mode}], 88 x 3 x 448^2 f32, back to back: "
              f"{s.elapsed_time(e) / 3000:.4f} ms per launch; nvidia-smi "
              f"during the run: {smi.communicate()[0].strip()}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
