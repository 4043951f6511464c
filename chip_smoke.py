#!/usr/bin/env python3
"""Chip smoke test of polyblur_torch on one NVIDIA GPU (written for the H100).

Runs from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds every CUDA kernel from ``polyblur_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints the build time and register report;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (the 12 MP bench image, 448 px tiles, C = 3) in bf16
   and f32, and times kernel, plain version and — where one PyTorch call
   computes the same function — that call;
4. drives the main path once through ``polyblur_torch.deblur_patches``
   (bench.py's image and arguments: 448/384 tiles, bf16 work dtype, f32
   output, 3 iterations) with every launch counter zeroed just before and
   read just after, then compares the path with the plain path on the card
   (bf16 >= 40 dB, f32 >= 60 dB) and, on a small input, with the CPU path;
5. runs a (2, 3, 1024, 1024) batch through the same kernels;
6. prints one JSON line of kernels, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. It needs one card, the
CUDA toolkit (``nvcc``) and the repository's files; it imports no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

PSNR_BF16_DB = 40.0     # bf16 hand path vs bf16 plain path on the card
PSNR_F32_DB = 60.0      # f32 hand path vs f32 plain path on the card
# kernel vs plain version (same inputs, on the card). The kernels sum in
# another order than cuBLAS/PyTorch, so f32 results differ in the last
# bits; bf16 outputs may then round one bf16 step apart (2^-8 at 1.0).
TOL_EXACT = 0.0                 # edge_pad_cast: pure data movement
TOL_BLEND = 1e-6                # <= 4 f32 products summed, same order
TOL_REL_EST = 1e-4              # tile_estimate values, relative
TOL_REL_SPEC = 1e-5             # kernel_spectrum, relative to max |q|
TOL_SPEC_BF16 = 2.0 ** -7       # spectral_gemm application, bf16 out
TOL_SPEC_F32 = 1e-4             # spectral_gemm application, f32 out

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

DEVICE = "cuda"
NAMES = ("edge_pad_cast", "tile_estimate", "kernel_spectrum",
         "spectral_gemm", "blend_overlap_add")
SOURCES = {
    "edge_pad_cast": ("polyblur_torch/csrc/pad_cast.cu",
                      "polyblur_tpu/ops/pallas/pad_cast.py:200"),
    "tile_estimate": ("polyblur_torch/csrc/estimate.cu",
                      "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "kernel_spectrum": ("polyblur_torch/csrc/spectral.cu",
                        "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "spectral_gemm": ("polyblur_torch/csrc/spectral.cu",
                      "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "blend_overlap_add": ("polyblur_torch/csrc/blend.cu",
                          "polyblur_tpu/ops/pallas/overlap_add.py:168"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def make_12mp_image(rng) -> np.ndarray:
    """bench.py's 12 MP test image: the tiled peacock + N(0, 0.005) noise,
    clipped, as (1, 3, 3000, 4000) f32."""
    from PIL import Image

    peacock = np.asarray(Image.open("tests/data/peacock_defocus.png"))
    peacock = peacock.astype(np.float32) / 255.0  # (500, 700, 3)
    h, w = 3000, 4000
    reps = (h // peacock.shape[0] + 1, w // peacock.shape[1] + 1, 1)
    big = np.tile(peacock, reps)[:h, :w]
    big += rng.normal(0.0, 0.005, big.shape).astype(np.float32)
    return np.clip(big, 0.0, 1.0).astype(np.float32).transpose(2, 0, 1)[None]


def psnr(a, b) -> float:
    a = a.double()
    b = b.double()
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median per-call device time of ``fn`` in ms (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, kind: str):
    """(least time in ms, 'bytes' | 'operations') at the H100's peaks."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = flops / PEAK_FLOPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import polyblur_torch
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda.overlap_add import (
        blend_overlap_add, blend_overlap_add_plain)
    from polyblur_torch.ops.cuda.pad_cast import (edge_pad_cast,
                                                   edge_pad_cast_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        HALF, TileView, _directional_vals_plain, kernel_spectrum,
        kernel_spectrum_plain, spectral_poly, spectral_poly_plain,
        stage_tables, tile_estimate, tile_estimate_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)
    from polyblur_torch.pipeline import PLAIN, _mega_pack

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = pcuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(logs)} libraries")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- inputs
    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    b, c, H, W = img.shape
    grid = plan_patch_grid(H, W, 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    ph, pw = grid.patch_size
    n_tiles = len(grid.coords)
    print(f"grid: {th}x{tw} = {n_tiles} tiles of {ph}, step {sh}, canvas "
          f"{grid.padded_size}, pads {grid.pad}")
    path_kw = dict(n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0,
                   method="direct_separable")
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    h, wc = ph + 2 * HALF, pw + 2 * HALF
    report = {}

    # ---------------------------------------------------------- kernels
    for wd, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        esz = 2 if wd == torch.bfloat16 else 4
        crop = grid.orig_size

        canvas = edge_pad_cast(img, crop, grid.pad, wd)
        ref = edge_pad_cast_plain(img, crop, grid.pad, wd)
        err = float((canvas.float() - ref.float()).abs().max())
        require(err <= TOL_EXACT, f"edge_pad_cast {tag} error {err}")
        if tag == "bf16":
            nb = img.numel() * 4 + canvas.numel() * esz
            report["edge_pad_cast"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: edge_pad_cast(img, crop, grid.pad, wd)),
                plain_ms=cuda_ms(
                    lambda: edge_pad_cast_plain(img, crop, grid.pad, wd)),
                library_ms=cuda_ms(lambda: F.pad(
                    img, (grid.pad[2], grid.pad[3], grid.pad[0],
                          grid.pad[1]), mode="replicate").to(wd)),
                bound=bound_ms(nb, 0.0, tag))
        print(f"edge_pad_cast[{tag}]: max_abs_err {err}")

        view = TileView(canvas, b, 0, n_tiles * b, tw, (sh, sw), (ph, pw))
        est = tile_estimate(view, coeffs)
        est_p = tile_estimate_plain(view, coeffs)
        same = est[:, 0] == est_p[:, 0]
        if not bool(same.all()):
            vals = _directional_vals_plain(view)
            for t in torch.nonzero(~same).flatten().tolist():
                ik, ip = int(est[t, 0]), int(est_p[t, 0])
                margin = float((vals[t, ik] - vals[t, ip]) / vals[t, ip])
                print(f"theta mismatch tile {t}: kernel idx {ik}, plain idx "
                      f"{ip}, relative tie margin {margin:.3e}")
            raise SmokeFailure(f"tile_estimate {tag}: theta index differs "
                               f"on {int((~same).sum())} tiles")
        rel = float(((est[:, 1:] - est_p[:, 1:]).abs()
                     / est_p[:, 1:].abs().clamp(min=1e-30)).max())
        require(rel <= TOL_REL_EST, f"tile_estimate {tag} rel error {rel}")
        print(f"tile_estimate[{tag}]: theta idx identical on {n_tiles} "
              f"tiles, max rel err {rel:.3e}")
        if tag == "bf16":
            macs = n_tiles * b * (ph * pw * pw + ph * ph * pw)
            report["tile_estimate"] = dict(
                max_abs_err=float((est[:, 1:] - est_p[:, 1:]).abs().max()),
                ms=cuda_ms(lambda: tile_estimate(view, coeffs)),
                plain_ms=cuda_ms(lambda: tile_estimate_plain(view, coeffs),
                                 reps=3),
                library_ms=None,
                bound=bound_ms(n_tiles * b * c * ph * pw * esz,
                               2.0 * macs, "f32"))

        tabs = stage_tables(ph, pw, wd, str(dev))
        q2 = kernel_spectrum(est, coeffs, tabs)
        q2_p = kernel_spectrum_plain(est, coeffs, tabs)
        err = float((q2 - q2_p).abs().max())
        scale = float(q2_p.abs().max())
        require(err <= TOL_REL_SPEC * scale,
                f"kernel_spectrum {tag} error {err} (scale {scale})")
        print(f"kernel_spectrum[{tag}]: max_abs_err {err:.3e} "
              f"(max |q| {scale:.3e})")
        if tag == "bf16":
            kp = q2.shape[-1] // 2
            report["kernel_spectrum"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: kernel_spectrum(est, coeffs, tabs)),
                plain_ms=cuda_ms(
                    lambda: kernel_spectrum_plain(est, coeffs, tabs)),
                library_ms=None,
                bound=bound_ms(q2.numel() * 4,
                               2.0 * n_tiles * (25 * 25 * kp * 2
                                                + h * 25 * kp * 2), "f32"))

        out = spectral_poly(view, q2, tabs)
        out_p = spectral_poly_plain(view, q2, tabs)
        err = float((out.float() - out_p.float()).abs().max())
        tol = TOL_SPEC_BF16 if tag == "bf16" else TOL_SPEC_F32
        require(err <= tol, f"spectral_gemm {tag} error {err}")
        print(f"spectral_gemm[{tag}]: max_abs_err {err:.3e} "
              f"(PSNR {psnr(out, out_p):.1f} dB)")
        if tag == "bf16":
            kp = q2.shape[-1] // 2
            macs = (h * wc * 2 * kp + 2 * h * 2 * h * 2 * kp
                    + ph * 2 * kp * pw) * n_tiles * b * c
            nb = (2 * out.numel() * esz + q2.numel() * 4
                  + (tabs.fwd.numel() + tabs.inv.numel()
                     + tabs.cysy.numel()) * esz)
            # the same function through the FFT: rfft2 -> * p(K) -> irfft2
            xpad = F.pad(view.tiles().float().reshape(-1, 1, ph, pw),
                         (HALF,) * 4, mode="replicate")[:, 0]
            K = wc // 2 + 1
            qh = (q2[:, :, :K] * h).repeat_interleave(c, 0)

            def fft_app():
                y = torch.fft.irfft2(qh * torch.fft.rfft2(xpad), s=(h, wc))
                return y[:, HALF:HALF + ph, HALF:HALF + pw].clamp(0, 1)

            ferr = float((fft_app().reshape(out.shape) - out_p.float())
                         .abs().max())
            print(f"  FFT yardstick vs plain: max_abs_err {ferr:.3e}")
            report["spectral_gemm"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: spectral_poly(view, q2, tabs)),
                plain_ms=cuda_ms(lambda: spectral_poly_plain(view, q2, tabs),
                                 reps=3),
                library_ms=cuda_ms(fft_app, reps=3),
                bound=bound_ms(nb, 2.0 * macs, tag))

        win, inv_wsum = _blend_constants(grid, "kaiser", dev)
        gi = (th, tw, sh, sw, ph, pw)
        crop4 = (grid.pad[0], grid.pad[2]) + grid.orig_size
        o = blend_overlap_add(out, win, inv_wsum, gi, b, crop4,
                              torch.float32)
        o_p = blend_overlap_add_plain(out, win, inv_wsum, gi, b, crop4,
                                      torch.float32)
        err = float((o - o_p).abs().max())
        require(err <= TOL_BLEND, f"blend_overlap_add {tag} error {err}")
        print(f"blend_overlap_add[{tag}]: max_abs_err {err:.3e}")
        if tag == "bf16":
            nb = out.numel() * esz + o.numel() * 4 + inv_wsum.numel() * 4
            report["blend_overlap_add"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: blend_overlap_add(
                    out, win, inv_wsum, gi, b, crop4, torch.float32)),
                plain_ms=cuda_ms(lambda: blend_overlap_add_plain(
                    out, win, inv_wsum, gi, b, crop4, torch.float32),
                    reps=3),
                library_ms=None,
                bound=bound_ms(nb, 0.0, tag))
        del canvas, ref, view, est, est_p, q2, q2_p, out, out_p, o, o_p
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- main path
    def path(x, wd, **kw):
        return polyblur_torch.deblur_patches(
            x, patch_size=448, overlap=64.0 / 448.0, work_dtype=wd,
            out_dtype=torch.float32, device=dev, **path_kw, **kw)

    torch.cuda.synchronize()
    pcuda.reset_launches()
    out16 = path(img, torch.bfloat16)
    torch.cuda.synchronize()
    launches = dict(pcuda.launches)
    print(f"main path launches: {launches}")
    for name in NAMES:
        require(launches.get(name, 0) > 0, f"{name} never launched on the "
                                           f"main path")
    require(out16.shape == img.shape, "path output shape")
    require(bool(torch.isfinite(out16).all()), "path output not finite")
    require(float(out16.min()) >= 0.0 and float(out16.max()) <= 1.0,
            "path output outside [0, 1]")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path(img, torch.bfloat16)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    print(f"main path 12 MP bf16: {sec * 1e3:.2f} ms median of 5 = "
          f"{H * W / 1e6 / sec:.2f} MP/s on {card}")

    plain16 = path(img, torch.bfloat16, _ops=PLAIN)
    p = psnr(out16, plain16)
    print(f"path bf16 hand vs plain: {p:.2f} dB")
    require(p >= PSNR_BF16_DB, f"bf16 path PSNR {p:.2f} < {PSNR_BF16_DB}")
    del plain16
    out32 = path(img, torch.float32)
    plain32 = path(img, torch.float32, _ops=PLAIN)
    p = psnr(out32, plain32)
    print(f"path f32 hand vs plain: {p:.2f} dB")
    require(p >= PSNR_F32_DB, f"f32 path PSNR {p:.2f} < {PSNR_F32_DB}")
    del out32, plain32, out16

    small = img[..., :200, :300].contiguous()
    got = polyblur_torch.deblur_patches(
        small, patch_size=160, overlap=32.0 / 160.0, out_dtype=torch.float32,
        device=dev, **path_kw)
    want = polyblur_torch.deblur_patches(
        small.cpu(), patch_size=160, overlap=32.0 / 160.0,
        out_dtype=torch.float32, device="cpu", **path_kw)
    p = psnr(got.cpu(), want)
    print(f"small input, CUDA kernels vs CPU path (f32): {p:.2f} dB")
    require(p >= PSNR_F32_DB, f"CUDA vs CPU PSNR {p:.2f} < {PSNR_F32_DB}")

    # ---------------------------------------------------------- batch 2
    xb = torch.as_tensor(np.random.default_rng(1).uniform(
        size=(2, 3, 1024, 1024)).astype(np.float32), device=dev)
    pcuda.reset_launches()
    ob = polyblur_torch.deblur_patches(
        xb, patch_size=448, overlap=64.0 / 448.0, work_dtype=torch.bfloat16,
        out_dtype=torch.float32, device=dev, batch_size=4, **path_kw)
    torch.cuda.synchronize()
    require(all(pcuda.launches.get(n, 0) > 0 for n in NAMES),
            "batch-2 path skipped a kernel")
    pb = polyblur_torch.deblur_patches(
        xb, patch_size=448, overlap=64.0 / 448.0, work_dtype=torch.bfloat16,
        out_dtype=torch.float32, device=dev, _ops=PLAIN, **path_kw)
    p = psnr(ob, pb)
    print(f"batch 2 (2, 3, 1024, 1024), 4-tile chunks: hand vs plain "
          f"{p:.2f} dB, launches {dict(pcuda.launches)}")
    require(p >= PSNR_BF16_DB, f"batch-2 PSNR {p:.2f} < {PSNR_BF16_DB}")

    # ---------------------------------------------------------- report
    rows = []
    for name in NAMES:
        r = report[name]
        src, replaces = SOURCES[name]
        bms, by = r["bound"]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
