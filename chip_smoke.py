#!/usr/bin/env python3
"""Chip smoke test of polyblur_torch on one NVIDIA GPU (written for the H100).

Runs from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds every CUDA kernel from ``polyblur_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and prints the build time and register report;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (the 12 MP bench image, 448 px tiles, C = 3) in bf16
   and f32, and times kernel, plain version and — where one PyTorch call
   computes the same function — that call; for the blur estimate also the
   smallest relative tie margin of the blur direction over the 88 tiles,
   each of its four launches (the gray pass's min/max and normalize, the
   derivative GEMM pair with its TFLOP/s, the final stage) at 12 MP, config
   2 and 480 x 640, and ``torch.matmul`` of the same GEMM pair as its
   yardstick; ``kernel_spectrum`` also at config 2's 12 tiles and the
   480 x 640 tiles route's one image, with its device time (the calls
   queued behind a device-side sleep) beside the CUDA-event time;
   ``blend_overlap_add`` for every tile and output dtype on the 12 MP grid
   and on an even-cropped 1198 x 1598 image (its scalar path), and its
   backward kernel at the training cell's shapes (130 tiles of 400 px at
   step 300, bf16, the 12 MP f32 output's gradient) against autograd of
   the plain blend;
4. drives the main path once through ``polyblur_torch.deblur_patches``
   (bench.py's image and arguments: 448/384 tiles, bf16 work dtype, f32
   output, 3 iterations) with every launch counter zeroed just before and
   read just after, then compares the path with the plain path on the card
   (bf16 >= 40 dB, f32 >= 60 dB) and, on a small input, with the CPU path;
5. runs a (2, 3, 1024, 1024) batch through the same kernels;
6. holds the whole-image route's kernels against their plain versions at
   its shapes — ``fused_polynomial`` on the 2 MP photo's overlap-save
   blocks and on a prepadded 480 x 640 image, ``directional_maxima`` at
   (1, 1, 480, 640) and (4, 3, 481, 637), the tiles-mode stages at
   (1, 3, 481, 637) — and drives the whole-image paths through
   ``polyblur_torch.polyblur_deblurring``, each with the counters zeroed
   just before and read just after, its route read from ``dispatch_log``
   and its result held against the same call with every kernel's plain
   version on the card: the reference demo (700 x 500 peacock, blocked
   route), the 2 MP corpus photo (blocked), a 480 x 640 crop through the
   tiles route (f32 and bf16) and through ``method='fft'``, and the 12 MP
   image through ``method='auto'`` (the 448/384 patch engine, identical to
   the explicit ``deblur_patches`` call);
7. holds the feature flags' kernels against their plain versions at
   BASELINE config 2's shapes (the 1200 x 1600 RGB photo of
   polyblur_tpu/cli/bench_suite.py:117-120; 448 px tiles at overlap 1/7,
   3 x 4 = 12 tiles on a 1216 x 1600 canvas): ``bilateral`` on the whole
   image and on the tiles, ``iir_scan_rows`` (the row and the column pass,
   each checked and timed on its own with its byte bound) on the whole
   image and on the tiles, ``dt_scan_rows`` (the dt maps folded into the
   row pass: rows and ``v_v``, then the dt stage as a whole with the
   column pass, each with its device time and byte bound), the taper (the
   weights, and the
   three blends folded into their blurs' last products, held to the same
   products unfolded followed by the plain blend) and the halo (input
   gradients and mask, each GEMM launch timed with its TFLOP/s) stages on
   the tiles;
   then drives config 2 (``deblur_patches``, bf16 work dtype, taper + dt
   prefilter + halo), 2b (the same in f32), 2c (``polyblur_core(method=
   'fft')``), ``polyblur_deblurring`` with every flag (the bilateral
   smoother on the scan route), and the tiles route with the full
   bilateral set (480 x 640) and the dt set (480 x 512), each with the
   counters zeroed just before and read just after, its route read from
   ``dispatch_log`` and its result held against the same call with every
   kernel's plain version on the card; config 2 must launch the taper
   weights once per iteration and no separate blend;
8. trains through ``polyblur_torch.PolyblurLayer`` (the kernels forward,
   autograd of their plain versions backward), each step with the launch
   counters zeroed just before its forward and read after it and after
   its backward (the backward launches no forward kernel, and the blend's
   backward kernel once per blend): (a) the main path as a
   learnable layer (12 MP, 448/384 tiles, bf16 work, f32 loss, one Adam
   step): the forward's launches equal the main path's, the blur
   direction of every tile and iteration and the four scalar gradients
   are held against the same step with every plain version; (b) BASELINE
   config 5b (12 MP bf16, 576/512 tiles, ``remat``: the composed route,
   each iteration checkpointed, ``directional_maxima`` in the forward and
   again in the recompute); (c) on the blurred binary image of
   tests/test_runtime.py:150-180, 6 Adam steps at lr 5e-3 each: that
   test's layer (2 iterations, 'fft', ``remat``), whose loss must not
   increase, and BASELINE config 5's (1024^2 gray, 3 iterations,
   ``remat``; its loss rises at step 5 in both packages) with and
   without ``remat`` (the blocked ``fused_polynomial`` route), which
   must agree; every loss within 1e-4 relative of the JAX package's
   (``tools/config5_losses.py``, on the CPU);
   (d) the tiles route (480 x 640 f32) and the batch route (2 x 3 x
   1024^2 through the patch engine), scalar gradients against the plain
   step; each with its step time (median of 3 warm steps) and peak
   memory; (e) each autograd Function alone at its main-path shapes, its
   gradients under a seeded cotangent bit-equal to autograd of its plain
   version (no plain backward accumulates with atomics), with its
   backward's time (the blend's backward kernel also on upstream's
   400 px grid at 12 MP and 2 MP); extended to the bilateral Function
   and the two IIR Functions (rows, columns) on the 1200 x 1600 photo
   (f32) and on config 2's 12 bf16 tiles, and to the flagged tiles (480
   x 640, every flag) and canvas (config 2) Functions, whose backward replays the
   scan route on all their tiles (``pipeline._ref_pipeline``, as the
   JAX package's flagged VJPs); (f) BASELINE config 2 (2b in f32) as a
   learnable layer at full size (1200 x 1600, 448 px tiles at overlap
   1/7, taper + dt prefilter + halo, one Adam step): the forward's
   launches equal the grad-free call's, the backward no forward kernel
   (the blend's backward kernel once), theta is identical kernel vs
   plain on every tile and iteration, the scalar gradients are held
   against the plain step; (g) the scan route
   through both smoothers on the 2 MP photo (config 2c, ``method='fft'``
   with dt; every flag with the bilateral smoother), each with and
   without ``remat`` (under ``remat`` the recompute launches the
   forward's kernels again), against the plain step, with both peak
   memories; (h) the tiles route with every flag (480 x 640 f32
   bilateral, 480 x 512 dt in bf16 and in f32) and the (2, 3, 1024,
   1024) bf16 batch through the patch engine with config 2's flags, each
   against the plain step; in (a), (d), (f) and (h) the kernels step's
   output is held in dB against the plain step's; every step prints its
   time (median of 3 warm steps), peak memory and the card line;
9. before the training phases, (i) drives the reference demo through
   ``method='direct'``, and with every flag and ``smoother='nc'``, then
   takes the gradients of that configuration on a 160 x 240 crop with
   cuDNN's TF32 at PyTorch's default (allowed), held against the same
   step with the plain versions, a repeat (bit-equal) and the CPU; (j)
   the 12 MP image through ``deblur_patches(method='direct')`` (the
   composed route), then with ``q=1e-4, discard_saturation=True``, with
   theta identical kernel vs plain on the 88 tiles and the peak memory;
   (k) holds ``directional_maxima`` at n_angles 4, 8, 12 and over a
   4-channel multichannel batch, and ``fused_polynomial`` at ker_size 21
   and 31 (fused and blocked) against their plain versions, and drives
   six whole-image paths that launch them; the 12 MP main path's
   launches, read before and after (i)-(l), must not change;
   (l) holds ``bilateral`` against its plain version at the 12 MP path's
   88 tiles (bf16 canvas -> f32 smooth and noise, with its device time
   and bound, and the MUFU time worked out beside it in the printed text;
   the 2 MP and 12-tile rows of 7 carry the same),
   then drives the 12 MP image through ``deblur_patches`` (448/384, bf16
   work, f32 out, 3 iterations) with ``prefiltering=True`` and the
   default smoother (the staged route's bilateral stage): >= 40 dB against
   its plain run, ``bilateral`` launched once per iteration, theta
   identical kernel vs plain on the 88 tiles of every iteration, its ms,
   MP/s and the bilateral stage's share of its device time (a
   ``torch.profiler`` trace);
10. after (i)-(l), (m) drives the 12 MP image through ``deblur_patches``
   at 448 px tiles, overlap 0.6 (an irregular grid of 336 tiles: the
   composed route, the tiles route's kernels on all tiles as one batch,
   the plain slice-add blend; bf16 work, f32 out) against its plain run
   (>= 40 dB), theta identical kernel vs plain on every iteration's tiles,
   with its MP/s, device busy time, peak memory and the blend's own time,
   then ``PolyblurDeblurring`` at that overlap on the 1200 x 1600 photo
   and one ``PolyblurLayer`` step through the 12 MP irregular grid (f32)
   against the plain step under (a)'s gates; (n) runs
   ``polyblur_deblurring(verbose=True)`` on the demo, on config 2's photo
   with every flag, on a 480 x 640 crop through ``'fft'`` and on 12 MP
   ``auto``: the stage lines printed, the
   result identical to ``verbose=False``; (o) runs ``cli.main`` on the
   peacock (the demo's flags, then the patch engine at overlap 0.6), each
   PNG equal to ``imsave_uint8`` of the API's output,
   ``cli.bench_suite --quick`` (its table) and ``cli.calibrate`` at small
   arguments; the main path's launches, read before and after (m)-(o),
   must not change;
11. after (m)-(o), (p) the f32 dot modes: the 'highest' instantiations
   of ``spectral_gemm`` and of the estimate's GEMM at the 12 MP path's
   shapes in f32 and of the halo's at config 2's, each under both modes
   against its plain version (kernel rows ``spectral_gemm[highest]``,
   ``tile_estimate[highest]``, ``halo[highest]``, bounds at six tf32
   products per MAC), with each mode's split of ``tile_estimate`` over
   its four launches and of the halo over its two epilogues, and the
   'highest' GEMM's share of its bound; the f32 paths (12 MP patches,
   config 2b, the 480 x 640 tiles route, the 2 MP photo's blocked
   ``fused_polynomial``, training (d)'s tiles-route step) under both
   modes against their plain runs:
   launches under each mode's counters, dB, largest error, theta
   identical to the plain run's on every estimate with the smallest tie
   margin, 'highest' >= 110 dB and >= 10 dB above 'compensated'; the fft
   route and the bf16 main path identical under both modes with the same
   launches; (q) the burst serving path: ``cli.burst.main`` on four 12 MP
   PNGs and the peacock in bf16 and f32, each PNG against the same CLI
   under ``plain_versions()`` (bf16 >= 40 dB, f32 within one 8-bit step),
   its steady-state MP/s, mean host decode and device ms per image, and
   ``native_available()`` with its reason; (r) ``polyblur_torch.parallel``
   at world size 1 over NCCL (the machine's one card): ``deblur_sharded``
   on the 12 MP image in bf16 at the main path's grid, its kernels'
   launches counted, equal to ``extract_patches -> polyblur_core ->
   overlap_add`` and >= 40 dB from its plain run, its ms beside
   ``deblur_patches'``; the banded reassembly >= 40 dB from it and from
   its plain run; ``data_parallel_deblur`` on 4 x 3 x 480 x 640 equal to
   ``polyblur_core``; ``training_step`` and ``make_sharded_train_step``
   on 2 x 3 x 256^2 f32 equal to the world-free steps;
12. prints the training times as one JSON line, the card line, one JSON
   line of kernels, and as its last line ``{"ok": true, "device":
   {...}}``.

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
TOL_POLY_F32 = 1e-4             # fused_polynomial, f32 (unclipped blocks)
TOL_REL_MAXIMA = 1e-4           # directional_maxima, relative
TOL_BILATERAL = 1e-5            # bilateral, f32 out (expf vs float64 exp)
# the kernels compose the recurrence in runs of 16 under a 32-lane scan
# (the row pass) and in chunks of 32 (the dt stage's rows, the columns),
# the plain versions by a Hillis-Steele scan; it contracts (v < 1), so
# they stay within a few f32 ulps
TOL_IIR = 1e-5
TOL_DT = 1e-6                   # dt_scan_rows' v_v map, in (0, 1)
# taper weights vs plain; each folded blend vs the same products unfolded
# and the plain blend (the same f32 accumulator and rounding: 0 expected)
TOL_TAPER = 1e-6
TOL_REL_GRADS = 1e-5            # halo input gradients, relative to max |g|
TOL_HALO_BF16 = 2.0 ** -7       # halo mask, bf16 out

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}

DEVICE = "cuda"
NAMES = ("edge_pad_cast", "tile_estimate", "kernel_spectrum",
         "spectral_gemm", "blend_overlap_add")
TILE_STAGES = ("tile_estimate", "kernel_spectrum", "spectral_gemm")
# kernel_spectrum at config 2's 12 tiles and the 480 x 640 tiles route's
# one image, beside the main path's 88 tiles
SPECTRUM_ROWS = ("kernel_spectrum[n=12]", "kernel_spectrum[n=1]")
FEATURES = ("bilateral", "iir_scan_rows", "dt_scan_rows", "taper", "halo")
# (k): the kernels generalized in n_angles and in the half-support
GENERALIZED = tuple(f"directional_maxima[{k}]" for k in (
    "n_angles=4", "n_angles=8", "n_angles=12", "C=4 multichannel")) + tuple(
    f"fused_polynomial[ker_size={k}, {r}]" for k in (21, 31)
    for r in ("fused", "blocked"))
DT_STAGES = ("dt_scan_rows", "iir_scan_rows", "taper", "halo")
PATH_KW = dict(n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0)
# BASELINE config 2 (polyblur_tpu/cli/bench_suite.py:121-123)
CFG2_KW = dict(PATH_KW, remove_halo=True, edgetaping=True, prefiltering=True,
               smoother="domain_transform")
FLAGS_KW = dict(remove_halo=True, edgetaping=True, prefiltering=True)
BILATERAL_FLOPS_PX = 25 * 8 + 2  # per tap: sub, 2 mul, exp, 2 mul, 2 add
# the bilateral kernel's MUFU time, printed beside its bound (which counts
# an exponential as one f32 operation): 12 ex2 per pixel at 16 per SM and
# clock, 132 SMs at 1.98 GHz; worked out, not measured
BILATERAL_EX2_PX = 12
MUFU_RATE = 16 * 132 * 1.98e9


def mufu_ms(pixels: int) -> float:
    return pixels * BILATERAL_EX2_PX / MUFU_RATE * 1e3
# (l): the 12 MP patch engine with the default prefilter (bilateral)
PREFILTER_KW = dict(PATH_KW, method="direct_separable", prefiltering=True)
LIBRARY_GEMM_PAIR = ("GEMM pair only: torch.matmul of x Dw^T and Dh x in f32, "
                     "TF32 off")
SOURCES = {
    "edge_pad_cast": ("polyblur_torch/csrc/pad_cast.cu",
                      "polyblur_tpu/ops/pallas/pad_cast.py:200"),
    "tile_estimate": ("polyblur_torch/csrc/estimate.cu",
                      "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "kernel_spectrum": ("polyblur_torch/csrc/spectral.cu",
                        "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "kernel_spectrum[n=12]": ("polyblur_torch/csrc/spectral.cu",
                              "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "kernel_spectrum[n=1]": ("polyblur_torch/csrc/spectral.cu",
                             "polyblur_tpu/ops/pallas/polyblur_fused.py:631"),
    "spectral_gemm": ("polyblur_torch/csrc/spectral.cu",
                      "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "blend_overlap_add": ("polyblur_torch/csrc/blend.cu",
                          "polyblur_tpu/ops/pallas/overlap_add.py:168"),
    "polyblur_tiles": ("polyblur_torch/csrc/estimate.cu, "
                       "polyblur_torch/csrc/spectral.cu",
                       "polyblur_tpu/ops/pallas/polyblur_fused.py:631"),
    "fused_polynomial": ("polyblur_torch/csrc/spectral.cu",
                         "polyblur_tpu/ops/pallas/sep_poly_fused.py:364"),
    "directional_maxima": ("polyblur_torch/csrc/estimate.cu",
                           "polyblur_tpu/ops/pallas/est_fused.py:95"),
    "bilateral": ("polyblur_torch/csrc/bilateral.cu",
                  "polyblur_tpu/ops/pallas/bilateral.py:89"),
    # the mega kernel's bilateral prefilter stage (polyblur_fused.py:475-478)
    "bilateral[n=88]": ("polyblur_torch/csrc/bilateral.cu",
                        "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "iir_scan_rows": ("polyblur_torch/csrc/iir.cu",
                      "polyblur_tpu/ops/pallas/iir.py:145"),
    # the mega kernel's dt state (polyblur_fused.py:436-455) and row pass
    "dt_scan_rows": ("polyblur_torch/csrc/iir.cu",
                     "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "taper": ("polyblur_torch/csrc/features.cu",
              "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
    "halo": ("polyblur_torch/csrc/estimate.cu",
             "polyblur_tpu/ops/pallas/polyblur_fused.py:776"),
}
# (p): the f32 dot mode's 'highest' instantiations (template cases of the
# same sources)
HIGHEST_ROWS = ("spectral_gemm[highest]", "tile_estimate[highest]",
                "halo[highest]")
SOURCES.update({k: SOURCES[k[:k.index("[")]]
                for k in GENERALIZED + HIGHEST_ROWS})
# the blend's backward: no TPU kernel (overlap_add.py defines no VJP)
SOURCES["blend_overlap_add_backward"] = ("polyblur_torch/csrc/blend.cu",
                                         "none")


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def make_12mp_image(rng) -> np.ndarray:
    """bench.py's 12 MP test image: the tiled peacock + N(0, 0.005) noise,
    clipped, as (1, 3, 3000, 4000) f32, dense in that layout (as bench.py's
    ``jnp.asarray`` puts it on the device; a channel-interleaved view would
    cost the patch engine a layout copy)."""
    from PIL import Image

    peacock = np.asarray(Image.open("tests/data/peacock_defocus.png"))
    peacock = peacock.astype(np.float32) / 255.0  # (500, 700, 3)
    h, w = 3000, 4000
    reps = (h // peacock.shape[0] + 1, w // peacock.shape[1] + 1, 1)
    big = np.tile(peacock, reps)[:h, :w]
    big += rng.normal(0.0, 0.005, big.shape).astype(np.float32)
    return np.ascontiguousarray(
        np.clip(big, 0.0, 1.0).astype(np.float32).transpose(2, 0, 1)[None])


def make_config2_image() -> np.ndarray:
    """bench_suite's config 2 input: the peacock tiled to 1200 x 1600,
    (1200, 1600, 3) f32 (polyblur_tpu/cli/bench_suite.py:117-120)."""
    peacock = load_png("tests/data/peacock_defocus.png")    # (500, 700, 3)
    h, w = 1200, 1600
    reps = (h // peacock.shape[0] + 1, w // peacock.shape[1] + 1, 1)
    return np.ascontiguousarray(np.tile(peacock, reps)[:h, :w])


def load_png(path: str) -> np.ndarray:
    """(H, W, 3) f32 in [0, 1]."""
    from PIL import Image

    img = np.asarray(Image.open(path))[..., :3]
    return (img.astype(np.float32) / 255.0).copy()


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` in ms, each call ending in a
    synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


# Least operation counts of the kernels' functions, for their bounds: what
# the function needs done, not what the kernel does (its DFTs are dense
# GEMMs). A real 2D FFT of N = h w points is counted as 2.5 N log2 N flops,
# half a complex FFT's 5 N log2 N, at any N.

def fft_flops(h: int, w: int) -> float:
    """Flops of one real 2D FFT (forward or inverse) of an (h, w) plane."""
    return 2.5 * h * w * math.log2(h * w)


def application_flops(h: int, w: int) -> float:
    """One p(K) application to one (h, w) canvas plane given its real
    spectrum: rfft2, the product with the spectrum, irfft2."""
    return 2.0 * fft_flops(h, w) + 2.0 * h * (w // 2 + 1)


def spectrum_flops(h: int, w: int) -> float:
    """The kernel's spectrum on an (h, w) canvas (one real FFT of the
    placed taps) and the degree-3 Horner on it."""
    return fft_flops(h, w) + 6.0 * h * (w // 2 + 1)


def maxima_flops(c: int, h: int, w: int, angles: int = 7) -> float:
    """The estimate's directional maxima of one (c, h, w) image: gray and
    range normalization, the gradient pair through one forward and two
    inverse real FFTs, ``angles`` directional derivatives with |.| and
    max."""
    return (3.0 * fft_flops(h, w) + 4.0 * h * (w // 2 + 1)
            + (c + 3 + angles * 4) * h * w)


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
    """Per-call device time of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls, the median of three such runs. Back to back, the
    device queue stays ahead of the host, so a wrapper's host time counts
    only where it exceeds its kernels' time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Per-call device time of ``fn`` in ms: CUDA events around ``reps``
    calls queued behind a device-side sleep, so that all of them are
    enqueued before the first one runs and the host's time between
    launches does not count (it does in :func:`cuda_ms` for a kernel
    shorter than its wrapper's host time). Median of three runs."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms: longer than the enqueue
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, kind: str):
    """(least time in ms, 'bytes' | 'operations') at the H100's peaks."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = flops / PEAK_FLOPS[kind] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def spectral_modes(view, q2, tabs, label: str, clip: bool = True,
                   high: bool = False) -> float:
    """Print each ``spectral_gemm`` product's CUDA-event time and achieved
    TFLOP/s of its dense-GEMM formulation (2 x MACs / time), then the whole
    application's, with ``high`` each one's share of its ``'highest'``
    bound (six tf32 products per MAC); returns the application's ms. The
    launches are counted under a name of their own, which no path check
    reads."""
    from polyblur_torch.ops.cuda.polyblur_fused import spectral_gemm_launches

    _, runs = spectral_gemm_launches(view, q2, tabs, None, clip,
                                     "spectral_gemm_timing")
    for run in runs:
        run()  # the intermediates of a real application
    h, wc, kp = tabs.h, tabs.wc, tabs.er.shape[1]
    oh, ow = h - 2 * tabs.pad, wc - 2 * tabs.pad
    planes = view.n * view.channels
    macs = (2 * kp * h * wc, kp * 2 * h * 2 * h, 2 * h * kp * 2 * h,
            oh * ow * 2 * kp)

    def share(ms, m):
        if not high:
            return ""
        bound = 12.0 * m * planes / PEAK_FLOPS["tf32"] * 1e3
        return (f"; 'highest' bound {bound:.4f} ms, {100 * bound / ms:.1f}% "
                f"of it")

    for mode, (run, m) in enumerate(zip(runs, macs), 1):
        ms = cuda_ms(run)
        print(f"  {label} mode {mode}: {ms:.4f} ms, "
              f"{2e-9 * m * planes / ms:.1f} TFLOP/s ({m * planes / 1e9:.2f} "
              f"G MACs){share(ms, m)}")

    def application():
        for run in runs:
            run()

    ms = cuda_ms(application)
    print(f"  {label} application: {ms:.4f} ms, "
          f"{2e-9 * sum(macs) * planes / ms:.1f} TFLOP/s"
          f"{share(ms, sum(macs))}")
    return ms


def gemm_pair_flops(n: int, ph: int, pw: int) -> float:
    """Flops of the derivative GEMM pair gx = g Dw^T, gy = Dh g on n
    (ph, pw) planes, as dense f32 GEMMs."""
    return 2.0 * n * ph * pw * (ph + pw)


def estimate_stages(view, coeffs, label: str) -> dict:
    """Print the CUDA-event time of each launch of the estimate kernel on
    ``view`` — the gray pass's min/max and normalize launches, the
    derivative GEMM pair (with its TFLOP/s as dense f32 GEMMs) and the
    final stage — and return them. The launches are counted under a name
    of their own, which no path check reads."""
    from polyblur_torch.ops.cuda.polyblur_fused import estimate_launches

    _, _, runs = estimate_launches(view, "estimate_timing", coeffs)
    for run in runs:
        run()  # the scratch of a real estimate
    ms = {k: cuda_ms(run) for k, run in zip(("minmax", "norm", "gemm",
                                              "final"), runs)}
    ph, pw = view.patch
    print(f"  {label}: gray pass {ms['minmax'] + ms['norm']:.4f} ms (min/max "
          f"{ms['minmax']:.4f}, normalize {ms['norm']:.4f}), GEMM pair "
          f"{ms['gemm']:.4f} ms = "
          f"{gemm_pair_flops(view.n, ph, pw) / ms['gemm'] / 1e9:.1f} TFLOP/s"
          f", final {ms['final']:.4f} ms")
    return ms


def gemm_pair_library_ms(x) -> float:
    """``torch.matmul`` of the derivative pair on the (..., ph, pw) f32
    planes ``x`` (TF32 off): the yardstick of the kernels' GEMM pair."""
    import torch

    from polyblur_torch.ops.cuda.polyblur_fused import estimate_tables

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    t = estimate_tables(x.shape[-2], x.shape[-1], str(x.device))
    dwt = t.dw.T.contiguous()
    return cuda_ms(lambda: (torch.matmul(x, dwt), torch.matmul(t.dh, x)))


def tie_margins(view):
    """Per tile, the relative gap between the second-smallest and the
    smallest interpolated directional maximum (the plain version's): how
    far the theta argmin is from a tie."""
    import torch

    from polyblur_torch.ops.cuda.polyblur_fused import _directional_vals_plain

    vals = _directional_vals_plain(view)
    srt = torch.sort(vals, -1).values
    return vals, (srt[:, 1] - srt[:, 0]) / srt[:, 0]


def redesign_checks(dev, img2) -> None:
    """The shapes the Hopper redesign of ``spectral_gemm`` (TMA boxes,
    128 x 128 x 64 tiles, stacked layouts) and of ``edge_pad_cast``
    (16-byte chunks) make risky, each against its plain version at config
    2's tile shapes: the taper's pair (the tile padded onto the whole
    canvas with f32 out, the canvas cropped back), the noise epilogue with
    f32 and work-dtype out, an output aliasing the input, bf16 blocks of
    the blocked route; ``edge_pad_cast`` with odd left pads, an odd source
    width and a source off a 16-byte boundary, in both input dtypes."""
    import torch

    from polyblur_torch.ops.cuda.pad_cast import (edge_pad_cast,
                                                   edge_pad_cast_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, kernel_spectrum, spectral_poly, spectral_poly_plain,
        spectrum_plain, stage_tables, tile_estimate)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    f32 = torch.float32
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(img2.shape[-2], img2.shape[-1], 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    for wd, tol in ((torch.bfloat16, TOL_SPEC_BF16), (f32, TOL_SPEC_F32)):
        canvas = edge_pad_cast(img2, grid.orig_size, grid.pad, wd)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        tabs = stage_tables(448, 448, wd, str(dev))
        q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs, tabs)
        errs = {}
        xc = spectral_poly(view, q2, tabs, crop=0, clip=False, out_dtype=f32)
        xc_p = spectral_poly_plain(view, q2, tabs, crop=0, clip=False,
                                   out_dtype=f32)
        errs["pad onto canvas, f32 out"] = float((xc - xc_p).abs().max())
        cv = TileView.of_tiles(xc_p)
        noise = 0.01 * torch.randn((view.n, 3, 448, 448), device=dev,
                                   generator=torch.Generator(dev)
                                   .manual_seed(5))
        for odt in (f32, wd):
            o = spectral_poly(cv, q2, tabs, pad=0, noise=noise,
                              out_dtype=odt)
            o_p = spectral_poly_plain(cv, q2, tabs, pad=0, noise=noise,
                                      out_dtype=odt)
            errs[f"crop back + noise, {odt} out"] = float(
                (o.float() - o_p.float()).abs().max())
        x = view.tiles().clone()
        ref = spectral_poly_plain(TileView.of_tiles(x), q2, tabs)
        spectral_poly(TileView.of_tiles(x), q2, tabs, out=x)
        errs["aliased out"] = float((x.float() - ref.float()).abs().max())
        for what, err in errs.items():
            require(err <= tol, f"spectral_gemm {wd} {what}: error {err}")
        print(f"spectral_gemm[{wd}, {view.n} x 3 x 448^2, risky shapes]: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    # bf16 blocks of the blocked route (M = 280, K = 240: ragged tiles)
    blocks = img2[0, :, :280, :240].contiguous().to(torch.bfloat16)
    tabs = stage_tables(280, 240, torch.bfloat16, str(dev), 0)
    params = torch.tensor([[0.3, 0.05, 0.4]] * 3, device=dev)
    q2 = spectrum_plain(params[:, 0], params[:, 1], params[:, 2], coeffs,
                        tabs)
    bv = TileView.of_tiles(blocks[:, None])
    err = float((spectral_poly(bv, q2, tabs, clip=False).float()
                 - spectral_poly_plain(bv, q2, tabs, clip=False).float())
                .abs().max())
    require(err <= TOL_SPEC_BF16, f"spectral_gemm bf16 blocks error {err}")
    print(f"spectral_gemm[bf16, 3 x 280x240 blocks, pad 0]: max_abs_err "
          f"{err:.3e}")
    # edge_pad_cast: odd pads and widths, unaligned source rows
    src = img2[..., :1199, :1599]
    cases = 0
    for x in (src.contiguous(), img2[..., 1:, 3:].contiguous()):
        for idt in (f32, torch.bfloat16):
            xi = x.to(idt)
            for pads in ((3, 4, 5, 7), (68, 69, 145, 144), (0, 1, 1, 0)):
                for odt in (f32, torch.bfloat16):
                    got = edge_pad_cast(xi, xi.shape[-2:], pads, odt)
                    want = edge_pad_cast_plain(xi, xi.shape[-2:], pads, odt)
                    require(bool(torch.equal(got, want)),
                            f"edge_pad_cast {tuple(xi.shape)} {idt} -> {odt}"
                            f" pads {pads} differs")
                    cases += 1
    off = img2.reshape(-1)[1:1 + 3 * 1199 * 1601].reshape(1, 3, 1199, 1601)
    got = edge_pad_cast(off, (1198, 1600), (5, 6, 3, 4), torch.bfloat16)
    require(bool(torch.equal(got, edge_pad_cast_plain(
        off, (1198, 1600), (5, 6, 3, 4), torch.bfloat16))),
        "edge_pad_cast from a source off a 16-byte boundary differs")
    print(f"edge_pad_cast: {cases + 1} odd-pad / odd-width / unaligned "
          "cases bit-equal")


def spectrum_row(est, coeffs, tabs, label: str) -> dict:
    """``kernel_spectrum`` on the estimate rows ``est`` against its plain
    version, with its CUDA-event and device times: the kernel row of the
    report."""
    from polyblur_torch.ops.cuda.polyblur_fused import (
        kernel_spectrum, kernel_spectrum_plain)

    def run():
        return kernel_spectrum(est, coeffs, tabs)

    want = kernel_spectrum_plain(est, coeffs, tabs)
    scale = float(want.abs().max())
    err = float((run() - want).abs().max())
    require(err <= TOL_REL_SPEC * scale,
            f"kernel_spectrum[{label}] error {err} (scale {scale})")
    n, h, kp2 = want.shape
    row = dict(
        max_abs_err=err, ms=cuda_ms(run), device_ms=device_ms(run),
        plain_ms=cuda_ms(lambda: kernel_spectrum_plain(est, coeffs, tabs)),
        library_ms=None,
        bound=bound_ms(want.numel() * 4 + est.numel() * 4,
                       n * spectrum_flops(h, tabs.wc), "f32"))
    print(f"kernel_spectrum[{label}, h {h}, kp {kp2 // 2}]: max_abs_err "
          f"{err:.3e} (max |q| {scale:.3e}); {row['ms']:.4f} ms, device "
          f"{row['device_ms']:.4f} ms")
    return row


def spectrum_planes(dev, coeffs, report: dict) -> None:
    """``kernel_spectrum`` at the other routes' plane counts: config 2's 12
    tiles of 448 px (h 472, kp 256) and the 480 x 640 tiles route's one
    image (h 504, kp 384), on random blurs; fills their report rows."""
    import torch

    from polyblur_torch.ops.cuda.polyblur_fused import stage_tables
    from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs

    g = torch.Generator().manual_seed(7)
    for name, n, (ph, pw), wd in (
            ("kernel_spectrum[n=12]", 12, (448, 448), torch.bfloat16),
            ("kernel_spectrum[n=1]", 1, (480, 640), torch.float32)):
        sigma, rho = (0.3 + 3.7 * torch.rand(n, generator=g)
                      for _ in range(2))
        theta = torch.randint(0, 30, (n,), generator=g).float() * (
            math.pi / 30)
        est = torch.zeros((n, 8))
        est[:, 5:8] = torch.stack(gaussian_quadratic_coeffs(sigma, rho,
                                                            theta), 1)
        tabs = stage_tables(ph, pw, wd, str(dev))
        report[name] = spectrum_row(est.to(dev), coeffs, tabs, f"n={n}")


def blend_geometries(dev) -> None:
    """``blend_overlap_add`` against its plain version for every tile and
    output dtype, on 448/384 tiles: the 12 MP main path's grid (the 16-byte
    path: left crop 144, width 4000) and an even-cropped 1198 x 1598 image
    (the scalar path: left crop 1, width 1598), with the latter's time."""
    import torch

    from polyblur_torch.ops.cuda.overlap_add import (
        blend_overlap_add, blend_overlap_add_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)

    for hw in ((3000, 4000), (1198, 1598)):
        grid = plan_patch_grid(*hw, 448, 64.0 / 448.0)
        th, tw, sh, sw = _grid_steps(grid)
        tiles = torch.rand((th * tw, 3, 448, 448), device=dev,
                           generator=torch.Generator(dev).manual_seed(8))
        win, inv = _blend_constants(grid, "kaiser", dev)
        args = (win, inv, (th, tw, sh, sw, 448, 448), 1,
                (grid.pad[0], grid.pad[2]) + grid.orig_size)
        errs = []
        for tdt in (torch.bfloat16, torch.float32):
            t = tiles.to(tdt)
            for odt in (torch.bfloat16, torch.float32):
                got = blend_overlap_add(t, *args, out_dtype=odt)
                want = blend_overlap_add_plain(t, *args, out_dtype=odt)
                require(got.dtype == odt and got.shape == want.shape,
                        f"blend_overlap_add {hw} dtype or shape")
                err = float((got.float() - want.float()).abs().max())
                require(err <= TOL_BLEND, f"blend_overlap_add {hw} "
                                          f"{tdt} -> {odt} error {err}")
                errs.append(f"{str(tdt)[6:]}->{str(odt)[6:]} {err:.1e}")
        t16 = tiles.to(torch.bfloat16)

        def blend():
            return blend_overlap_add(t16, *args, out_dtype=torch.float32)

        print(f"blend_overlap_add[{hw[0]}x{hw[1]}, left crop {grid.pad[2]}]: "
              f"max_abs_err {', '.join(errs)}; bf16 -> f32 {cuda_ms(blend):.4f}"
              f" ms, device {device_ms(blend):.4f} ms")


def blend_backward_row(dev, report: dict, launches: dict) -> None:
    """The blend's backward kernel (``blend_overlap_add_backward``) at the
    training cell's shapes, 130 tiles of 400 px at step 300 in bf16 and
    the 12 MP f32 output's gradient: bit-equal to autograd of the plain
    blend, its launches those of one backward through the blend's
    Function, its time against that autograd (the plain blend recomputed
    and differentiated, as the replay it replaced) and its bytes bound."""
    import torch

    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda.overlap_add import (
        blend_overlap_add, blend_overlap_add_backward,
        blend_overlap_add_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)

    grid = plan_patch_grid(3000, 4000, 400, 0.25)
    gi = _grid_steps(grid) + (400, 400)
    args = (*_blend_constants(grid, "kaiser", dev), gi, 1,
            (grid.pad[0], grid.pad[2]) + grid.orig_size)
    gen = torch.Generator(dev).manual_seed(26)
    n = gi[0] * gi[1]
    tiles = (torch.rand((n, 3, 400, 400), device=dev, generator=gen) * 1.5
             - 0.25).to(torch.bfloat16)
    g = torch.randn((1, 3, 3000, 4000), device=dev, generator=gen)
    x = tiles.clone().requires_grad_()
    out = blend_overlap_add(x, *args, torch.float32)
    torch.cuda.synchronize()
    pcuda.reset_launches()
    got = torch.autograd.grad(out, x, g)[0]
    torch.cuda.synchronize()
    launches["blend_overlap_add_backward"] = sum(
        pcuda.backward_launches.values())
    require(dict(pcuda.backward_launches) == {"blend_overlap_add": 1}
            and not pcuda.launches,
            f"blend backward launches {dict(pcuda.backward_launches)}, "
            f"forward {dict(pcuda.launches)}")

    def plain():
        xp = tiles.detach().requires_grad_()
        return torch.autograd.grad(
            blend_overlap_add_plain(xp, *args, torch.float32), xp, g)[0]

    def kernel():
        return blend_overlap_add_backward(tiles, *args, g)

    want = plain()
    require(torch.equal(got.view(torch.int16), want.view(torch.int16))
            and torch.equal(kernel().view(torch.int16),
                            want.view(torch.int16)),
            "blend backward differs from autograd of the plain blend")
    # tiles read and their gradient written, the output gradient and the
    # crop's reciprocal window sum read, each once
    nbytes = 2 * tiles.numel() * 2 + g.numel() * 4 + 3000 * 4000 * 4
    r = report["blend_overlap_add_backward"] = dict(
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=cuda_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=cuda_ms(plain, reps=3), library_ms=None,
        bound=bound_ms(nbytes, 0.0, "bf16"))
    print(f"blend_overlap_add_backward[{n} x 3 x 400^2 bf16 -> 3000x4000 "
          f"float32]: bit-equal to plain autograd, {r['ms']:.4f} ms, device "
          f"{r['device_ms']:.4f} ms ({100 * r['bound'][0] / r['device_ms']:.1f}"
          f"% of its {r['bound'][0]:.4f} ms bound by {r['bound'][1]}), plain "
          f"autograd {r['plain_ms']:.3f} ms")


def whole_image_kernels(dev, report: dict) -> None:
    """The whole-image route's kernels against their plain versions at its
    shapes, in f32 (the route's work dtype for f32 images); fills
    ``report`` with their rows."""
    import torch

    from polyblur_torch.estimation import gaussian_blur_estimation
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.est_fused import (directional_maxima,
                                                   directional_maxima_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, _gray_norm_plain, kernel_spectrum, kernel_spectrum_plain,
        spectral_poly, spectral_poly_plain, spectrum_plain, stage_tables,
        tile_estimate, tile_estimate_plain)
    from polyblur_torch.ops.cuda.sep_poly_fused import (
        fused_polynomial, fused_polynomial_plain)
    from polyblur_torch.pipeline import _mega_pack

    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    photo = torch.as_tensor(load_png("tests/data/corpus_hr/peacock_tiled.png")
                            .transpose(2, 0, 1)[None].copy(), device=dev)

    # -- fused_polynomial: the 2 MP photo's overlap-save blocks (pad 0, no
    # clip) with the photo's own estimated blur, as the blocked route runs
    sigma, rho, theta = gaussian_blur_estimation(
        photo, c=0.362, b=0.468, return_2d_filters=False)
    a, b, c = sep_poly.gaussian_quadratic_coeffs(sigma[:, 0], rho[:, 0],
                                                 theta[:, 0])
    planes = photo[0]                                        # (3, H, W)
    view, (th, b0h, tw, b0w, ap) = sep_poly._block_view(planes, 12)
    params = torch.stack([a, b, c], -1).repeat(3, 1).repeat(th * tw, 1)
    out = fused_polynomial(view, params, coeffs)
    out_p = fused_polynomial_plain(view, params, coeffs)
    err = float((out - out_p).abs().max())
    require(err <= TOL_POLY_F32, f"fused_polynomial blocks error {err}")
    bh, bw = view.patch
    tabs = stage_tables(bh, bw, torch.float32, str(dev), 0)
    kp = tabs.er.shape[1]
    print(f"fused_polynomial[blocks {view.n} x {bh}x{bw}, kp {kp}, pad 0, "
          f"no clip, f32]: max_abs_err {err:.3e}")
    blocks = view.tiles()[:, 0]
    K = bw // 2 + 1
    qh = spectrum_plain(params[:, 0], params[:, 1], params[:, 2], coeffs,
                        tabs)[..., :K] * bh

    def fft_blocks():
        return torch.fft.irfft2(qh * torch.fft.rfft2(blocks), s=(bh, bw))

    ferr = float((fft_blocks() - out[:, 0]).abs().max())
    print(f"  FFT yardstick vs kernel: max_abs_err {ferr:.3e}")
    q2b = spectrum_plain(params[:, 0], params[:, 1], params[:, 2], coeffs,
                         tabs)
    spectral_modes(view, q2b, tabs,
                   f"spectral_gemm[f32, {view.n} blocks {bh}x{bw}, pad 0]",
                   clip=False)
    flops = view.n * (spectrum_flops(bh, bw) + application_flops(bh, bw))
    report["fused_polynomial"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_polynomial(view, params, coeffs)),
        plain_ms=cuda_ms(lambda: fused_polynomial_plain(view, params,
                                                        coeffs), reps=3),
        library_ms=cuda_ms(fft_blocks),
        bound=bound_ms(view.data.numel() * 4 + out.numel() * 4
                       + params.numel() * 4, flops, "f32"))
    # the fused whole-image route: 3 planes of 480 x 640, pad 12, clip
    x3 = photo[0, :, :480, :640].contiguous()
    p3 = params[:3]
    out = fused_polynomial(x3, p3, coeffs, True, True)
    out_p = fused_polynomial_plain(x3, p3, coeffs, True, True)
    err = float((out - out_p).abs().max())
    require(err <= TOL_SPEC_F32, f"fused_polynomial prepad error {err}")
    ms = cuda_ms(lambda: fused_polynomial(x3, p3, coeffs, True, True))
    plain_ms = cuda_ms(lambda: fused_polynomial_plain(x3, p3, coeffs, True,
                                                      True), reps=3)
    print(f"fused_polynomial[3 x 480x640, pad 12, clip, f32]: max_abs_err "
          f"{err:.3e}, {ms:.3f} ms (plain {plain_ms:.3f} ms)")

    # -- directional_maxima
    for shape in ((1, 1, 480, 640), (4, 3, 481, 637)):
        xs = torch.rand(shape, generator=torch.Generator().manual_seed(3))
        xs = xs.to(dev)
        m = directional_maxima(xs)
        m_p = directional_maxima_plain(xs)
        rel = float(((m - m_p).abs() / m_p.abs().clamp(min=1e-30)).max())
        require(rel <= TOL_REL_MAXIMA,
                f"directional_maxima {shape} rel error {rel}")
        print(f"directional_maxima[{shape}]: max rel err {rel:.3e}, "
              f"{cuda_ms(lambda: directional_maxima(xs)):.3f} ms")
        if shape[0] == 1:
            _, _, hh, ww = shape
            estimate_stages(TileView.of_tiles(xs), coeffs,
                            f"directional_maxima[{shape}]")
            report["directional_maxima"] = dict(
                max_abs_err=float((m - m_p).abs().max()),
                ms=cuda_ms(lambda: directional_maxima(xs)),
                plain_ms=cuda_ms(lambda: directional_maxima_plain(xs)),
                library_ms=gemm_pair_library_ms(
                    _gray_norm_plain(TileView.of_tiles(xs))),
                library_what=LIBRARY_GEMM_PAIR,
                bound=bound_ms(xs.numel() * 4 + m.numel() * 4,
                               maxima_flops(shape[1], hh, ww), "f32"))

    # -- the estimate of the 480 x 640 tiles route (one tile, n = 1)
    estimate_stages(TileView.of_tiles(photo[:, :, :480, :640].contiguous()),
                    coeffs, "tile_estimate[f32, 1 x 3 x 480 x 640, tiles "
                    "route]")

    # -- tiles mode: one iteration's stages on an odd rectangle whose 2h is
    # not a multiple of 16 (h = 505, wc = 661, kp = 384)
    xt = photo[:, :, 100:581, 200:837].contiguous()        # (1, 3, 481, 637)
    tv = TileView.of_tiles(xt)
    ph, pw = tv.patch
    est = tile_estimate(tv, coeffs)
    est_p = tile_estimate_plain(tv, coeffs)
    require(bool(torch.equal(est[:, 0], est_p[:, 0])),
            f"tiles-mode theta index differs: {est[:, 0]} vs {est_p[:, 0]}")
    tabs = stage_tables(ph, pw, torch.float32, str(dev))
    q2 = kernel_spectrum(est, coeffs, tabs)
    q2_p = kernel_spectrum_plain(est, coeffs, tabs)
    require(float((q2 - q2_p).abs().max())
            <= TOL_REL_SPEC * float(q2_p.abs().max()), "tiles-mode spectrum")
    o = spectral_poly(tv, q2, tabs)
    o_p = spectral_poly_plain(tv, q2, tabs)
    err = float((o - o_p).abs().max())
    require(err <= TOL_SPEC_F32, f"tiles-mode application error {err}")
    kp = tabs.er.shape[1]
    h, wc = ph + 24, pw + 24
    print(f"polyblur_tiles[(1, 3, {ph}, {pw}), h {h}, wc {wc}, kp {kp}]: "
          f"theta idx identical, max_abs_err {err:.3e}")

    def one_iter(e=tile_estimate, s=kernel_spectrum, g=spectral_poly):
        return g(tv, s(e(tv, coeffs), coeffs, tabs), tabs)

    flops = (maxima_flops(3, ph, pw) + spectrum_flops(h, wc)
             + 3 * application_flops(h, wc))
    report["polyblur_tiles"] = dict(
        max_abs_err=err, ms=cuda_ms(one_iter),
        plain_ms=cuda_ms(lambda: one_iter(tile_estimate_plain,
                                          kernel_spectrum_plain,
                                          spectral_poly_plain), reps=3),
        library_ms=None,
        bound=bound_ms(2 * xt.numel() * 4, flops, "f32"))


def whole_image_paths(dev, img12, card: str, launches: dict) -> None:
    """Drive the whole-image paths through ``polyblur_deblurring``, each
    with the counters zeroed just before and read just after, and hold
    each against the same call with the plain versions on the card; record
    each kernel row's launches in ``launches``."""
    import torch

    import polyblur_torch
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, tile_estimate, tile_estimate_plain)
    from polyblur_torch.pipeline import _mega_pack
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    def run(x, **kw):
        return polyblur_torch.polyblur_deblurring(x, device=dev, **kw)

    def drive(name, x, routes, kernels, min_db, **kw):
        """One path: counted hand run, route check, timed hand runs, plain
        run; returns (hand output, launches)."""
        torch.cuda.synchronize()
        pcuda.reset_launches()
        reset_dispatch_log()
        out = run(x, **kw)
        torch.cuda.synchronize()
        counts = dict(pcuda.launches)
        log = dispatch_log()
        for route in routes:
            require(route in log, f"{name}: route {route} not taken: {log}")
        for k in kernels:
            require(counts.get(k, 0) > 0, f"{name}: {k} never launched "
                                          f"({counts})")
        out_t = torch.as_tensor(out)
        require(bool(torch.isfinite(out_t.float()).all()),
                f"{name}: output not finite")
        require(tuple(out_t.shape) == tuple(np.shape(x)),
                f"{name}: output shape")
        ms = host_ms(lambda: run(x, **kw), reps=3)
        with pcuda.plain_versions():
            ref = torch.as_tensor(run(x, **kw))
        p = psnr(out_t.float().cpu(), ref.float().cpu())
        npx = out_t.shape[-2] * out_t.shape[-1]
        if out_t.dim() == 3:  # numpy (H, W, C)
            npx = out_t.shape[0] * out_t.shape[1]
        print(f"{name}: {ms:.2f} ms = {npx / 1e6 / (ms / 1e3):.2f} MP/s on "
              f"{card}; hand vs plain {p:.2f} dB; routes {sorted(log)}; "
              f"launches {counts}")
        require(p >= min_db, f"{name}: PSNR {p:.2f} < {min_db}")
        return out_t, counts

    peacock = load_png("tests/data/peacock_defocus.png")        # (500, 700, 3)
    photo = load_png("tests/data/corpus_hr/peacock_tiled.png")  # 1200 x 1600
    scan_ds = ("polyblur_core", "scan/direct_separable")
    blocked = ("compute_polynomial_separable", "blocked")
    drive("demo 700x500 (blocked)", peacock, (scan_ds, blocked),
          ("fused_polynomial",), PSNR_F32_DB, **PATH_KW)
    _, counts = drive("2 MP photo 1600x1200 (blocked)", photo,
                      (scan_ds, blocked), ("fused_polynomial",), PSNR_F32_DB,
                      **PATH_KW)
    launches["fused_polynomial"] = counts["fused_polynomial"]

    crop = torch.as_tensor(peacock[:480, :640].transpose(2, 0, 1)[None].copy(),
                           device=dev)
    tiles = ("polyblur_core", "tiles")
    out, counts = drive("crop 480x640 tiles route f32", crop, (tiles,),
                        TILE_STAGES, PSNR_F32_DB, method="direct_separable",
                        **PATH_KW)
    launches["polyblur_tiles"] = sum(counts[k] for k in TILE_STAGES)
    launches["kernel_spectrum[n=1]"] = counts["kernel_spectrum"]
    # theta identical, kernel vs plain, on every iteration's input
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    x = crop
    for it in range(PATH_KW["n_iter"]):
        tv = TileView.of_tiles(x)
        ik = tile_estimate(tv, coeffs)[:, 0]
        ip = tile_estimate_plain(tv, coeffs)[:, 0]
        require(bool(torch.equal(ik, ip)),
                f"tiles route iteration {it + 1}: theta idx {ik} vs {ip}")
        x = run(crop, method="direct_separable", **dict(PATH_KW,
                                                         n_iter=it + 1))
    print("crop 480x640 tiles route: theta idx identical on all "
          f"{PATH_KW['n_iter']} iterations")
    drive("crop 480x640 tiles route bf16", crop.bfloat16(), (tiles,),
          TILE_STAGES, PSNR_BF16_DB, method="direct_separable", **PATH_KW)
    _, counts = drive("crop 480x640 method=fft", crop,
                      (("polyblur_core", "scan/fft"),
                       ("directional_maxima", "fused")),
                      ("directional_maxima",), PSNR_F32_DB, method="fft",
                      **PATH_KW)
    launches["directional_maxima"] = counts["directional_maxima"]

    # 12 MP, method='auto': the 448/384 patch engine, identical to the
    # explicit deblur_patches call (both f32)
    torch.cuda.synchronize()
    pcuda.reset_launches()
    reset_dispatch_log()
    auto = run(img12, method="auto", **PATH_KW)
    torch.cuda.synchronize()
    require(("polyblur_deblurring", "auto_tiled/448") in dispatch_log(),
            f"12 MP auto did not tile at 448: {dispatch_log()}")
    require(all(pcuda.launches.get(k, 0) > 0 for k in NAMES),
            "12 MP auto skipped a kernel")
    ms = host_ms(lambda: run(img12, method="auto", **PATH_KW), reps=3)
    explicit = polyblur_torch.deblur_patches(
        img12, patch_size=448, overlap=64.0 / 448.0, batch_size=0,
        device=dev, method="direct_separable", **PATH_KW)
    same = bool(torch.equal(auto, explicit))
    print(f"12 MP method='auto' f32: auto_tiled/448, {ms:.2f} ms = "
          f"{img12.shape[-2] * img12.shape[-1] / 1e6 / (ms / 1e3):.2f} MP/s; "
          f"identical to deblur_patches(448, 64/448): {same} (max diff "
          f"{float((auto - explicit).abs().max()):.3e})")
    require(same, "12 MP auto differs from the explicit deblur_patches call")


def drive_path(name, fn, shape, routes, kernels, min_db, card, npx):
    """One path: a counted hand run (the counters and the dispatch log
    zeroed just before, read just after), the route and launch checks,
    timed hand runs, and the same call with every kernel's plain version
    on the card; returns the launch counts."""
    import torch

    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    torch.cuda.synchronize()
    pcuda.reset_launches()
    reset_dispatch_log()
    out = torch.as_tensor(fn())
    torch.cuda.synchronize()
    counts = dict(pcuda.launches)
    log = dispatch_log()
    for route in routes:
        require(route in log, f"{name}: route {route} not taken: {log}")
    for k in kernels:
        require(counts.get(k, 0) > 0, f"{name}: {k} never launched "
                                      f"({counts})")
    require(bool(torch.isfinite(out.float()).all()),
            f"{name}: output not finite")
    require(tuple(out.shape) == tuple(shape), f"{name}: output shape "
                                              f"{tuple(out.shape)}")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
            f"{name}: output outside [0, 1]")
    ms = host_ms(fn, reps=3)
    with pcuda.plain_versions():
        ref = torch.as_tensor(fn())
    p = psnr(out.float().cpu(), ref.float().cpu())
    print(f"{name}: {ms:.2f} ms = {npx / 1e6 / (ms / 1e3):.2f} MP/s on "
          f"{card}; hand vs plain {p:.2f} dB; routes {sorted(log)}; "
          f"launches {counts}")
    require(p >= min_db, f"{name}: PSNR {p:.2f} < {min_db}")
    return counts


def feature_kernels(dev, img2, report: dict) -> None:
    """The feature flags' kernels against their plain versions at BASELINE
    config 2's shapes; fills ``report`` with their rows."""
    import torch

    from polyblur_torch.ops.bilateral import bilateral_filter
    from polyblur_torch.ops.cuda.bilateral import bilateral, bilateral_plain
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda.features import (
        halo_grads, halo_grads_plain, halo_mask, halo_mask_plain,
        taper_weights, taper_weights_plain)
    from polyblur_torch.ops.cuda.iir import (
        dt_coeffs_plain, dt_scan_rows, dt_scan_rows_plain, scan_cols,
        scan_cols_plain, scan_rows, scan_rows_plain)
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        HALF, TileView, kernel_spectrum, spectral_poly, stage_tables,
        taper_blend_plain, tile_estimate)
    from polyblur_torch.ops.domain_transform import (
        _domain_transform_derivatives)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack, _unit_horner

    f32, bf16 = torch.float32, torch.bfloat16
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    n_el = img2.numel()

    # -- bilateral: the whole 2 MP image (the scan route's prefilter)
    tv2 = TileView.of_tiles(img2)
    out = bilateral_filter(img2)
    err = float((out - bilateral_plain(tv2)).abs().max())
    require(err <= TOL_BILATERAL, f"bilateral 2 MP error {err}")
    report["bilateral"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: bilateral_filter(img2)),
        device_ms=device_ms(lambda: bilateral(tv2)),
        plain_ms=cuda_ms(lambda: bilateral_plain(tv2), reps=3),
        library_ms=None,
        bound=bound_ms(2 * n_el * 4, n_el * BILATERAL_FLOPS_PX, "f32"))
    r = report["bilateral"]
    print(f"bilateral[{tuple(img2.shape)} f32]: max_abs_err {err:.3e}, "
          f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; MUFU at "
          f"{BILATERAL_EX2_PX} ex2 per pixel {mufu_ms(n_el):.4f} ms)")

    # -- the config 2 tiles: 448 px at step 384 on the bf16 canvas
    grid = plan_patch_grid(img2.shape[-2], img2.shape[-1], 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img2, grid.orig_size, grid.pad, bf16)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    tiles_el = view.n * 3 * 448 * 448
    s, nz = bilateral(view, out_dtype=f32, with_noise=True)
    s_p, nz_p = bilateral_plain(view, out_dtype=f32, with_noise=True)
    err = max(float((s - s_p).abs().max()), float((nz - nz_p).abs().max()))
    require(err <= TOL_BILATERAL, f"bilateral tile stage error {err}")
    bms, by = bound_ms(canvas.numel() * 2 + tiles_el * 2 * 4,
                       tiles_el * BILATERAL_FLOPS_PX, "f32")
    stage = dict(
        shape=f"{view.n} x 3 x 448^2 bf16 tiles -> f32 smooth + noise",
        max_abs_err=err,
        ms=cuda_ms(lambda: bilateral(view, out_dtype=f32, with_noise=True)),
        device_ms=device_ms(lambda: bilateral(view, out_dtype=f32,
                                              with_noise=True)),
        plain_ms=cuda_ms(lambda: bilateral_plain(view, out_dtype=f32,
                                                 with_noise=True), reps=3),
        bound_ms=bms, bound_by=by)
    report["bilateral"]["tile_stage"] = stage
    print(f"bilateral[{stage['shape']}]: max_abs_err {err:.3e}, "
          f"{stage['ms']:.4f} ms, device {stage['device_ms']:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; MUFU {mufu_ms(tiles_el):.4f} ms)")

    # -- iir_scan_rows: one recursive-filter iteration of the 2 MP image
    # (config 2c: sigma_s 2, sigma_r 0.8), row pass then column pass; then
    # the dt stage of config 2's tiles (the column pass with the noise)
    dh, dv = _domain_transform_derivatives(img2, 2.0, 0.8)
    a = math.exp(-math.sqrt(2.0) / 2.0)
    v_h = (a ** dh.double()).float()
    v_v = (a ** dv.double()).float()
    rows = scan_rows(tv2, v_h)
    err = float((rows - scan_rows_plain(tv2, v_h)).abs().max())
    cols = scan_cols(rows.clone(), v_v)
    err_cols = float((cols - scan_cols_plain(rows, v_v)).abs().max())
    require(max(err, err_cols) <= TOL_IIR,
            f"iir_scan_rows 2 MP error rows {err}, columns {err_cols}")
    rows_t, vv = dt_scan_rows(view, coeffs)
    rows_tp, vv_p = dt_scan_rows_plain(view, coeffs)
    err_dt = float((vv - vv_p).abs().max())
    err_dr = float((rows_t - rows_tp).abs().max())
    require(err_dt <= TOL_DT, f"dt_scan_rows v_v error {err_dt}")
    require(err_dr <= TOL_IIR, f"dt_scan_rows rows error {err_dr}")
    vh = dt_coeffs_plain(view, coeffs)[0]
    err_t = float((scan_rows(view, vh) - rows_tp).abs().max())
    sm, nz = scan_cols(rows_t.clone(), vv, src=view)
    sm_p, nz_p = scan_cols_plain(rows_t, vv, src=view)
    err_ct = max(float((sm - sm_p).abs().max()),
                 float((nz - nz_p).abs().max()))
    require(max(err_t, err_ct) <= TOL_IIR,
            f"iir_scan_rows tile stage error rows {err_t}, columns {err_ct}")
    # each pass alone, with its own byte bound (each input read once, each
    # output written once; the tiles' bf16 canvas once)
    scratch, scratch_t = rows.clone(), rows_t.clone()
    plane_b, tile_b = n_el * 4, tiles_el * 4
    passes = {}
    # (name, error, kernel, plain version, bytes, elements); ~6 flops per
    # element and pass (3 forward, 3 backward)
    for key, err_k, fn, plain, nbytes, el in (
            (f"rows[{tuple(img2.shape)}]", err,
             lambda: scan_rows(tv2, v_h),
             lambda: scan_rows_plain(tv2, v_h),
             2 * plane_b + v_h.numel() * 4, n_el),
            (f"columns[{tuple(img2.shape)}]", err_cols,
             lambda: scan_cols(scratch, v_v),
             lambda: scan_cols_plain(rows, v_v),
             2 * plane_b + v_v.numel() * 4, n_el),
            (f"rows[{view.n} x 3 x 448^2 bf16 tiles]", err_t,
             lambda: scan_rows(view, vh),
             lambda: scan_rows_plain(view, vh),
             canvas.numel() * 2 + vh.numel() * 4 + tile_b, tiles_el),
            (f"columns[{view.n} x 3 x 448^2, + noise]", err_ct,
             lambda: scan_cols(scratch_t, vv, src=view),
             lambda: scan_cols_plain(rows_t, vv, src=view),
             canvas.numel() * 2 + vv.numel() * 4 + 3 * tile_b, tiles_el)):
        bms, by = bound_ms(nbytes, 6.0 * el, "f32")
        passes[key] = dict(max_abs_err=err_k, ms=cuda_ms(fn),
                           device_ms=device_ms(fn),
                           plain_ms=cuda_ms(plain, reps=3), bound_ms=bms,
                           bound_by=by)
        r = passes[key]
        print(f"iir_scan_rows {key}: max_abs_err {err_k:.3e}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), plain {r['plain_ms']:.3f} ms")
    report["iir_scan_rows"] = dict(
        max_abs_err=max(err, err_cols, err_t, err_ct),
        ms=cuda_ms(lambda: scan_cols(scan_rows(tv2, v_h), v_v)),
        plain_ms=cuda_ms(lambda: scan_cols_plain(scan_rows_plain(tv2, v_h),
                                                 v_v), reps=3),
        library_ms=None,
        bound=bound_ms((2 * n_el + v_h.numel() + v_v.numel()) * 4,
                       12.0 * n_el, "f32"),
        passes=passes)
    print(f"iir_scan_rows[{tuple(img2.shape)} rows + columns]: "
          f"{report['iir_scan_rows']['ms']:.3f} ms")

    # -- the dt stage of config 2's tiles: the maps folded into the row
    # pass (the canvas read once, rows and v_v written once; ~26 flops per
    # pixel for the maps, 6 per element for the pass), then the whole
    # stage with the column pass and the noise (the canvas read once,
    # smooth and noise written once)
    def dt_stage():
        r, v = dt_scan_rows(view, coeffs)
        return scan_cols(r, v, src=view)

    def dt_stage_plain():
        r, v = dt_scan_rows_plain(view, coeffs)
        return scan_cols_plain(r, v, src=view)

    n_px = view.n * 448 * 448
    fused_b = bound_ms(canvas.numel() * 2 + vv.numel() * 4 + tile_b,
                       26.0 * n_px + 6.0 * tiles_el, "f32")
    stage_b = bound_ms(canvas.numel() * 2 + 2 * tile_b,
                       26.0 * n_px + 12.0 * tiles_el + tiles_el, "f32")
    report["dt_scan_rows"] = dict(
        max_abs_err=max(err_dt, err_dr),
        ms=cuda_ms(lambda: dt_scan_rows(view, coeffs)),
        device_ms=device_ms(lambda: dt_scan_rows(view, coeffs)),
        plain_ms=cuda_ms(lambda: dt_scan_rows_plain(view, coeffs), reps=3),
        library_ms=None, bound=fused_b,
        stage=dict(what="dt_scan_rows + scan_cols with the noise",
                   ms=cuda_ms(dt_stage), device_ms=device_ms(dt_stage),
                   plain_ms=cuda_ms(dt_stage_plain, reps=3),
                   bound_ms=stage_b[0], bound_by=stage_b[1]))
    r = report["dt_scan_rows"]
    print(f"dt_scan_rows[{view.n} x 3 x 448^2 bf16 tiles]: v_v max_abs_err "
          f"{err_dt:.3e}, rows {err_dr:.3e}, {r['ms']:.4f} ms, device "
          f"{r['device_ms']:.4f} ms, bound {fused_b[0]:.4f} ms "
          f"({fused_b[1]}), plain {r['plain_ms']:.3f} ms")
    st = r["stage"]
    print(f"dt stage[{view.n} x 3 x 448^2 bf16 tiles, {st['what']}]: "
          f"{st['ms']:.4f} ms, device {st['device_ms']:.4f} ms, bound "
          f"{st['bound_ms']:.4f} ms ({st['bound_by']}), plain "
          f"{st['plain_ms']:.3f} ms")

    estimate_stages(view, coeffs, f"tile_estimate[bf16, {view.n} x 3 x "
                    "448^2, config 2]")

    # -- taper: the weights and the 3 blends of one iteration on the tiles
    # of the smooth planes, each blend folded into the last product of its
    # blur (K applied to the previous blend), held to the same products
    # unfolded followed by the plain blend
    est = tile_estimate(view, coeffs)
    tabs = stage_tables(448, 448, bf16, str(dev))
    h = wc = 448 + 2 * HALF
    khat2 = kernel_spectrum(est, _unit_horner(str(dev)), tabs)
    smooth = TileView.of_tiles(sm)
    av, ah = taper_weights(est, h, wc)
    av_p, ah_p = taper_weights_plain(est, h, wc)
    err = max(float((av - av_p).abs().max()), float((ah - ah_p).abs().max()))
    xc = torch.empty((view.n, 3, h, wc), dtype=f32, device=dev)
    xc_ref = torch.empty_like(xc)
    u, u_ref, pad = smooth, smooth, HALF
    err_fold = 0.0
    for _ in range(3):
        spectral_poly(u, khat2, tabs, xc, pad=pad, crop=0, clip=False,
                      out_dtype=f32, taper=(av, ah))
        ku = spectral_poly(u_ref, khat2, tabs, pad=pad, crop=0, clip=False,
                           out_dtype=f32)
        taper_blend_plain(u_ref, pad, av, ah, ku, xc_ref)
        err_fold = max(err_fold, float((xc - xc_ref).abs().max()))
        u, u_ref, pad = TileView.of_tiles(xc), TileView.of_tiles(xc_ref), 0
    require(max(err, err_fold) <= TOL_TAPER,
            f"taper error: weights {err}, folded blends {err_fold}")
    print(f"taper: weights max_abs_err {err:.3e}; folded blends vs unfolded "
          f"products + plain blend: max_abs_err {err_fold:.3e}")

    def taper(x=xc):
        a_v, a_h = taper_weights(est, h, wc)
        u, pad = smooth, HALF
        for _ in range(3):
            spectral_poly(u, khat2, tabs, x, pad=pad, crop=0, clip=False,
                          out_dtype=f32, taper=(a_v, a_h))
            u, pad = TileView.of_tiles(x), 0
        return x

    def taper_plain():
        with pcuda.plain_versions():
            return taper(xc_ref)

    amap = av[:, None, :, None] * ah[:, None, None, :]   # outside the timing
    lerp_ku = spectral_poly(smooth, khat2, tabs, pad=HALF, crop=0,
                            clip=False, out_dtype=f32)
    planes_el = view.n * 3 * h * wc
    # the stage's inputs read once (the smooth tiles, the spectrum, the
    # estimate) and its outputs written once (av, ah, xc): folded, a blend
    # moves no bytes of its own, it reads its application's u and writes
    # its xc. Operations: three applications of K at spectral_gemm's
    # yardstick for these shapes on the tensor cores, and beside them the
    # blends' 4 f32 operations per element on the CUDA cores
    stage_bytes = (tiles_el + planes_el + khat2.numel() + est.numel()
                   + av.numel() + ah.numel()) * 4
    stage_b = max(bound_ms(stage_bytes,
                           3 * view.n * 3 * application_flops(h, wc), "bf16"),
                  bound_ms(stage_bytes, 3 * 4.0 * planes_el, "f32"))
    weights_ms = device_ms(lambda: taper_weights(est, h, wc))
    stage_ms = device_ms(taper)
    report["taper"] = dict(
        max_abs_err=max(err, err_fold), ms=cuda_ms(taper),
        device_ms=stage_ms,
        plain_ms=cuda_ms(taper_plain, reps=3),
        library_ms=cuda_ms(lambda: torch.lerp(lerp_ku, xc, amap)),
        library_what="torch.lerp(Ku, u, a): one blend, the (h, wc) weight "
                     "map formed outside the timing",
        bound=stage_b,
        weights_device_ms=weights_ms)
    r = report["taper"]
    print(f"taper[{view.n} tiles, canvas {h}x{wc}, weights + 3 folded "
          f"applications]: {r['ms']:.3f} ms, device {stage_ms:.4f} ms "
          f"(weights {weights_ms:.4f} ms = {100 * weights_ms / stage_ms:.1f}"
          f"%), bound {r['bound'][0]:.4f} ms; torch.lerp blend "
          f"{r['library_ms']:.4f} ms")

    # -- halo: the input gradients (once per call) and one mask pass
    grads = halo_grads(view)
    grads_p = halo_grads_plain(view)
    gscale = float(grads_p.gx.abs().max())
    rel = max(float((grads.gx - grads_p.gx).abs().max()),
              float((grads.gy - grads_p.gy).abs().max())) / gscale
    nm, nm_p = grads.part.sum(-1), grads_p.part.sum(-1)
    rel = max(rel, float(((nm - nm_p).abs() / nm_p).max()))
    require(rel <= TOL_REL_GRADS, f"halo gradients rel error {rel}")
    q2 = kernel_spectrum(est, coeffs, tabs)
    o = spectral_poly(smooth, q2, tabs, clip=False, out_dtype=f32)
    out = torch.empty_like(o, dtype=bf16)
    halo_mask(o, grads, smooth, nz, out)
    ref = halo_mask_plain(o, grads, smooth, nz, torch.empty_like(out))
    err = float((out.float() - ref.float()).abs().max())
    require(err <= TOL_HALO_BF16, f"halo mask error {err}")

    def halo(g=halo_grads, m=halo_mask):
        return m(o, g(view), smooth, nz, out)

    pair = gemm_pair_flops(view.n * 3, 448, 448)
    for what, fn in (("input gradients (epi 1)", lambda: halo_grads(view)),
                     ("mask (epi 2)", lambda: halo_mask(o, grads, smooth, nz,
                                                        out))):
        ms = cuda_ms(fn)
        print(f"  halo GEMM pair, {what}, {view.n} x 3 x 448^2: {ms:.4f} ms "
              f"= {pair / ms / 1e9:.1f} TFLOP/s")
    xin = view.tiles().float()
    grad_flops = 3.0 * fft_flops(448, 448) + 4.0 * 448 * (448 // 2 + 1)
    report["halo"] = dict(
        max_abs_err=err, ms=cuda_ms(halo),
        plain_ms=cuda_ms(lambda: halo(halo_grads_plain, halo_mask_plain),
                         reps=3),
        # the pair on the input planes and on o
        library_ms=gemm_pair_library_ms(xin) + gemm_pair_library_ms(o),
        library_what=LIBRARY_GEMM_PAIR + ", on the input planes and on o",
        # the canvas, o, u_cmp and the noise read once, the bf16 tiles
        # written once; the gradients are intermediates
        bound=bound_ms(canvas.numel() * 2 + tiles_el * (4 + 4 + 4 + 2),
                       view.n * 3 * 2 * grad_flops + 20.0 * tiles_el,
                       "f32"))
    print(f"halo[{view.n} x 3 x 448^2, gradients + mask, bf16 out]: grads "
          f"rel err {rel:.3e}, mask max_abs_err {err:.3e}, "
          f"{report['halo']['ms']:.3f} ms")


def feature_paths(dev, img2, card: str, launches: dict) -> None:
    """BASELINE config 2, 2b, 2c and the whole-image flag paths, each held
    against its plain run on the card; records the feature kernels'
    launches in ``launches``."""
    import torch

    import polyblur_torch
    from polyblur_torch.pipeline import polyblur_core

    shape = tuple(img2.shape)
    npx = shape[-2] * shape[-1]
    staged = ("deblur_patches", "staged_tiles")

    def cfg2(wd):
        return polyblur_torch.deblur_patches(
            img2, patch_size=448, overlap=1.0 / 7.0, work_dtype=wd,
            out_dtype=torch.float32, device=dev, method="direct_separable",
            **CFG2_KW)

    counts = drive_path("config 2: 2 MP deblur_patches bf16, taper + dt + "
                        "halo", lambda: cfg2(torch.bfloat16), shape,
                        (staged,), NAMES + DT_STAGES, PSNR_BF16_DB, card, npx)
    # per iteration: the taper weights, no separate blend; rows + columns
    require(counts["taper"] == CFG2_KW["n_iter"],
            f"config 2: {counts['taper']} taper launches for "
            f"{CFG2_KW['n_iter']} iterations (weights only expected)")
    # the dt maps ride in the row pass: one dt_scan_rows and one column
    # pass per iteration
    require(counts["dt_scan_rows"] == CFG2_KW["n_iter"]
            and counts["iir_scan_rows"] == CFG2_KW["n_iter"],
            f"config 2: {counts['dt_scan_rows']} dt row passes, "
            f"{counts['iir_scan_rows']} column passes")
    print(f"config 2 launches per call: taper weights {counts['taper']}, "
          f"separate blends 0 (folded into spectral_gemm mode 4), dt maps "
          f"+ row passes {counts['dt_scan_rows']}, column passes "
          f"{counts['iir_scan_rows']}")
    for k in DT_STAGES:
        launches[k] = counts[k]
    launches["kernel_spectrum[n=12]"] = counts["kernel_spectrum"]
    drive_path("config 2b: the same in f32", lambda: cfg2(torch.float32),
               shape, (staged,), NAMES + DT_STAGES, PSNR_F32_DB, card, npx)
    drive_path("config 2c: 2 MP polyblur_core(method='fft'), taper + dt + "
               "halo", lambda: polyblur_core(img2, device=dev, method="fft",
                                             **CFG2_KW), shape,
               (("polyblur_core", "scan/fft"), ("recursive_filter", "cuda")),
               ("iir_scan_rows",), PSNR_F32_DB, card, npx)
    photo = img2[0].permute(1, 2, 0).cpu().numpy()
    counts = drive_path(
        "2 MP polyblur_deblurring, every flag (bilateral smoother), numpy",
        lambda: polyblur_torch.polyblur_deblurring(photo, device=dev,
                                                   **FLAGS_KW, **PATH_KW),
        photo.shape, (("polyblur_core", "scan/direct_separable"),
                      ("bilateral_filter", "cuda"),
                      ("compute_polynomial_separable", "blocked")),
        ("bilateral", "fused_polynomial"), PSNR_F32_DB, card, npx)
    launches["bilateral"] = counts["bilateral"]
    tiles = ("polyblur_core", "tiles")
    crop = img2[..., :480, :640].contiguous()
    drive_path("crop 480x640 tiles route, every flag (bilateral)",
               lambda: polyblur_torch.polyblur_deblurring(
                   crop, device=dev, method="direct_separable", **FLAGS_KW,
                   **PATH_KW), crop.shape, (tiles,),
               TILE_STAGES + ("bilateral", "taper", "halo"), PSNR_F32_DB,
               card, 480 * 640)
    crop = img2[..., :480, :512].contiguous()
    drive_path("crop 480x512 tiles route, every flag (dt, at its cap)",
               lambda: polyblur_core(crop, device=dev,
                                     method="direct_separable", **CFG2_KW),
               crop.shape, (tiles,), TILE_STAGES + DT_STAGES, PSNR_F32_DB,
               card, 480 * 512)


# ------------------------------------------------ direct, nc, generalized
# (i)-(k): method='direct', smoother='nc', the estimate's other branches and
# the kernels generalized in n_angles and the half-support.

# theta of the same call's estimates, kernels vs plain versions
def thetas_equal(name: str, x, **kw) -> None:
    import torch

    from polyblur_torch.estimation import gaussian_blur_estimation
    from polyblur_torch.ops import cuda as pcuda

    hand = gaussian_blur_estimation(x, return_2d_filters=False, **kw)[2]
    with pcuda.plain_versions():
        plain = gaussian_blur_estimation(x, return_2d_filters=False, **kw)[2]
    same = bool(torch.equal(hand, plain))
    print(f"{name}: theta identical, kernels vs plain, on all "
          f"{hand.numel()} estimates: {same}")
    require(same, f"{name}: theta differs on "
                  f"{int((hand != plain).sum())} of {hand.numel()} estimates")


# (i): d loss / d (image, c, b, alpha, beta, sigma_s, sigma_r) through
# method='direct' with every flag and the 'nc' smoother, in f32, on the
# card against the CPU and against the plain versions: ops/conv.py keeps
# cuDNN's TF32 off in both passes of its convolutions, so the two devices
# differ by f32 summation orders only (TF32's 10-bit mantissa would put
# ~1e-3 relative into every convolution)
TOL_REL_GRAD_DIRECT = 1e-4      # scalar gradients, relative to the largest
DB_GRAD_DIRECT = 80.0           # image gradient, relative to its max |g|


def direct_gradients(dev, card: str) -> None:
    """(i)'s gradient step: one step with the kernels, a repeat (its
    gradients bit-equal: the convolutions' backward is deterministic), the
    same step with the plain versions and on the CPU, with
    ``torch.backends.cudnn.allow_tf32`` True (PyTorch's default) around
    them; and, printed only, the step with the port's TF32 scope taken
    out, against the CPU."""
    import contextlib

    import torch
    from scipy import ndimage

    import polyblur_torch
    from polyblur_torch.ops import conv as pconv
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    crop = load_png("tests/data/peacock_defocus.png")[100:260, 150:390]
    x = np.ascontiguousarray(crop.transpose(2, 0, 1)[None])
    tgt = np.clip(2.0 * x - ndimage.gaussian_filter(x, (0, 0, 1.5, 1.5)),
                  0.0, 1.0).astype(np.float32)
    names = ("c", "b", "alpha", "beta", "sigma_s", "sigma_r")
    scalars = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    kw = dict(n_iter=2, method="direct", smoother="nc", **FLAGS_KW)

    def step(device):
        xt = torch.tensor(x, device=device, requires_grad=True)
        ps = [torch.tensor(v, device=device, requires_grad=True)
              for v in scalars]
        out = polyblur_torch.polyblur_apply(xt, device=device,
                                            **dict(zip(names, ps)), **kw)
        loss = ((out - torch.as_tensor(tgt, device=device)) ** 2).mean()
        g = torch.autograd.grad(loss, [xt] + ps, allow_unused=True)
        gs = torch.stack([torch.zeros(()) if v is None else v.cpu()
                          for v in g[1:]])
        return g[0].cpu().double(), gs.double()

    def gaps(a, b):
        rel = float((a[1] - b[1]).abs().max() / b[1].abs().max())
        err = float(((a[0] - b[0]) ** 2).mean())
        db = 10.0 * math.log10(float(b[0].abs().max()) ** 2
                               / max(err, 1e-300))
        return rel, db

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.cuda.synchronize()
        pcuda.reset_launches()
        reset_dispatch_log()
        hand = step(dev)
        torch.cuda.synchronize()
        counts, log = dict(pcuda.launches), dispatch_log()
        again = step(dev)
        with pcuda.plain_versions():
            plain = step(dev)
        require(torch.backends.cudnn.allow_tf32,
                "(i) gradients: the conv scope did not restore TF32")
        scope = pconv.full_f32_convs
        pconv.full_f32_convs = contextlib.nullcontext
        try:
            tf32 = step(dev)
        finally:
            pconv.full_f32_convs = scope
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    cpu = step("cpu")
    label = "(i) gradients, method='direct', every flag, 'nc', 160x240 f32"
    require(("polyblur_core", "scan/direct") in log, f"{label}: {log}")
    require(counts.get("directional_maxima", 0) > 0,
            f"{label}: directional_maxima never launched ({counts})")
    for t in hand:
        require(bool(torch.isfinite(t).all()), f"{label}: not finite")
    same = all(torch.equal(a, b) for a, b in zip(hand, again))
    print(f"{label} on {card}: launches {counts}; repeat bit-equal: {same}; "
          f"d loss / d ({', '.join(names)}) "
          f"{[f'{v:.6e}' for v in hand[1].tolist()]}")
    require(same, f"{label}: a repeat gave other gradients")
    for what, ref in (("plain versions", plain), ("CPU", cpu)):
        rel, db = gaps(hand, ref)
        print(f"{label}: vs {what}: scalars max rel err {rel:.3e} (tol "
              f"{TOL_REL_GRAD_DIRECT}), image gradient {db:.2f} dB (min "
              f"{DB_GRAD_DIRECT})")
        require(rel <= TOL_REL_GRAD_DIRECT and db >= DB_GRAD_DIRECT,
                f"{label}: {rel:.3e}, {db:.2f} dB from the {what}")
    rel, db = gaps(tf32, cpu)
    print(f"{label}: control, TF32 scope taken out, vs CPU: scalars max "
          f"rel err {rel:.3e}, image gradient {db:.2f} dB")


def generalized_kernels(dev, report: dict) -> None:
    """(k): ``directional_maxima`` at n_angles 4, 8 and 12 on a 1 x 3 x
    480 x 640 crop and over a 4-channel multichannel batch (its (4, 1,
    480, 640) planes), ``fused_polynomial`` at ker_size 21 and 31 on the
    prepadded 3 x 480 x 640 planes (the fused route) and on the 2 MP
    photo's overlap-save blocks (the blocked route), each against its
    plain version with its time, bound and yardstick; fills ``report``."""
    import torch
    import torch.nn.functional as F

    from polyblur_torch.estimation import gaussian_blur_estimation
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.est_fused import (directional_maxima,
                                                   directional_maxima_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, _gray_norm_plain, spectrum_plain, stage_tables)
    from polyblur_torch.ops.cuda.sep_poly_fused import (
        fused_polynomial, fused_polynomial_plain)
    from polyblur_torch.pipeline import _mega_pack

    photo = torch.as_tensor(load_png("tests/data/corpus_hr/peacock_tiled.png")
                            .transpose(2, 0, 1)[None].copy(), device=dev)
    crop = photo[..., :480, :640].contiguous()
    four = torch.cat([crop, crop.mean(1, keepdim=True)], 1)
    for label, x, na in (("n_angles=4", crop, 4), ("n_angles=8", crop, 8),
                         ("n_angles=12", crop, 12),
                         ("C=4 multichannel", four.reshape(4, 1, 480, 640),
                          6)):
        m = directional_maxima(x, na)
        m_p = directional_maxima_plain(x, na)
        rel = float(((m - m_p).abs() / m_p.abs().clamp(min=1e-30)).max())
        name = f"directional_maxima[{label}]"
        require(m.shape == (x.shape[0], na + 1), f"{name}: shape {m.shape}")
        require(rel <= TOL_REL_MAXIMA, f"{name} rel error {rel}")
        b, c, hh, ww = x.shape
        report[name] = dict(
            max_abs_err=float((m - m_p).abs().max()),
            ms=cuda_ms(lambda: directional_maxima(x, na)),
            device_ms=device_ms(lambda: directional_maxima(x, na)),
            plain_ms=cuda_ms(lambda: directional_maxima_plain(x, na)),
            library_ms=gemm_pair_library_ms(
                _gray_norm_plain(TileView.of_tiles(x))),
            library_what=LIBRARY_GEMM_PAIR,
            bound=bound_ms(x.numel() * 4 + m.numel() * 4,
                           b * maxima_flops(c, hh, ww, na + 1), "f32"))
        r = report[name]
        print(f"{name} {tuple(x.shape)}: max rel err {rel:.3e}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, GEMM pair "
              f"{r['library_ms']:.4f}, bound {r['bound'][0]:.5f})")

    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    for ks in (21, 31):
        half = ks // 2
        sigma, rho, theta = gaussian_blur_estimation(
            photo, c=0.362, b=0.468, ker_size=ks, return_2d_filters=False)
        a, b, c = sep_poly.gaussian_quadratic_coeffs(sigma[:, 0], rho[:, 0],
                                                     theta[:, 0])
        p1 = torch.stack([a, b, c], -1)
        # the fused route: 3 planes of 480 x 640, replicate pad, clip
        x3 = crop[0]
        p3 = p1.repeat(3, 1)
        out = fused_polynomial(x3, p3, coeffs, True, True, half)
        out_p = fused_polynomial_plain(x3, p3, coeffs, True, True, half)
        err = float((out - out_p).abs().max())
        name = f"fused_polynomial[ker_size={ks}, fused]"
        require(err <= TOL_SPEC_F32, f"{name} error {err}")
        h, wc = 480 + 2 * half, 640 + 2 * half
        tabs = stage_tables(480, 640, torch.float32, str(dev), half, half)
        K = wc // 2 + 1
        qh = spectrum_plain(p3[:, 0], p3[:, 1], p3[:, 2], coeffs,
                            tabs)[..., :K] * h
        xp = F.pad(x3[:, None], (half,) * 4, mode="replicate")[:, 0]

        def fft_fused():
            y = torch.fft.irfft2(qh * torch.fft.rfft2(xp), s=(h, wc))
            return y[:, half:half + 480, half:half + 640].clamp(0, 1)

        report[name] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fused_polynomial(x3, p3, coeffs, True, True,
                                                half)),
            device_ms=device_ms(lambda: fused_polynomial(x3, p3, coeffs,
                                                         True, True, half)),
            plain_ms=cuda_ms(lambda: fused_polynomial_plain(
                x3, p3, coeffs, True, True, half), reps=3),
            library_ms=cuda_ms(fft_fused),
            bound=bound_ms(2 * x3.numel() * 4 + p3.numel() * 4,
                           3 * (spectrum_flops(h, wc)
                                + application_flops(h, wc)), "f32"))
        # the blocked route: the 2 MP photo's overlap-save blocks
        view, _ = sep_poly._block_view(photo[0], half)
        pb = p1.repeat(3, 1).repeat(view.n // 3, 1)
        out = fused_polynomial(view, pb, coeffs, half=half)
        out_p = fused_polynomial_plain(view, pb, coeffs, half=half)
        err = float((out - out_p).abs().max())
        bname = f"fused_polynomial[ker_size={ks}, blocked]"
        require(err <= TOL_POLY_F32, f"{bname} error {err}")
        bh, bw = view.patch
        btabs = stage_tables(bh, bw, torch.float32, str(dev), 0, half)
        qb = spectrum_plain(pb[:, 0], pb[:, 1], pb[:, 2], coeffs,
                            btabs)[..., :bw // 2 + 1] * bh
        blocks = view.tiles()[:, 0]

        def fft_blocks():
            return torch.fft.irfft2(qb * torch.fft.rfft2(blocks), s=(bh, bw))

        report[bname] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: fused_polynomial(view, pb, coeffs, half=half)),
            device_ms=device_ms(lambda: fused_polynomial(view, pb, coeffs,
                                                         half=half)),
            plain_ms=cuda_ms(lambda: fused_polynomial_plain(
                view, pb, coeffs, half=half), reps=3),
            library_ms=cuda_ms(fft_blocks),
            bound=bound_ms(view.data.numel() * 4 + out.numel() * 4
                           + pb.numel() * 4,
                           view.n * (spectrum_flops(bh, bw)
                                     + application_flops(bh, bw)), "f32"))
        for nm, shape in ((name, "3 x 480 x 640, pad %d, clip" % half),
                          (bname, f"{view.n} blocks {bh}x{bw}, pad 0")):
            r = report[nm]
            print(f"{nm} [{shape}]: max_abs_err {r['max_abs_err']:.3e}, "
                  f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
                  f"(plain {r['plain_ms']:.4f}, "
                  f"rfft2/irfft2 {r['library_ms']:.4f}, bound "
                  f"{r['bound'][0]:.5f} by {r['bound'][1]})")


def generalized_paths(dev, card: str, launches: dict) -> None:
    """(k)'s paths: the whole-image routes that reach the generalized
    kernels, each counted and held against its plain run; records the
    launches of (k)'s rows in ``launches``."""
    import torch

    import polyblur_torch

    photo = load_png("tests/data/corpus_hr/peacock_tiled.png")   # 1200x1600
    crop = torch.as_tensor(photo[:480, :640].transpose(2, 0, 1)[None].copy(),
                           device=dev)
    small = crop[..., :400, :600].contiguous()
    four = torch.cat([crop, crop.mean(1, keepdim=True)], 1).contiguous()
    scan_ds = ("polyblur_core", "scan/direct_separable")
    fused = ("compute_polynomial_separable", "fused")
    blocked = ("compute_polynomial_separable", "blocked")
    maxima = ("directional_maxima", "fused")

    def run(x, **kw):
        return lambda: polyblur_torch.polyblur_deblurring(
            x, device=dev, **dict(PATH_KW, **kw))

    for label, x, kw, routes, kernels, rows in (
            ("crop 480x640 direct_separable, ker_size 21, n_angles 8",
             crop, dict(method="direct_separable", ker_size=21, n_angles=8),
             (scan_ds, fused, maxima), ("fused_polynomial",
                                        "directional_maxima"),
             {"fused_polynomial[ker_size=21, fused]": "fused_polynomial",
              "directional_maxima[n_angles=8]": "directional_maxima"}),
            ("crop 400x600 direct_separable, ker_size 31, n_angles 12",
             small, dict(method="direct_separable", ker_size=31,
                         n_angles=12),
             (scan_ds, fused, maxima), ("fused_polynomial",
                                        "directional_maxima"),
             {"fused_polynomial[ker_size=31, fused]": "fused_polynomial",
              "directional_maxima[n_angles=12]": "directional_maxima"}),
            ("2 MP photo direct_separable, ker_size 21 (blocked)", photo,
             dict(method="direct_separable", ker_size=21),
             (scan_ds, blocked), ("fused_polynomial",),
             {"fused_polynomial[ker_size=21, blocked]": "fused_polynomial"}),
            ("2 MP photo direct_separable, ker_size 31 (blocked)", photo,
             dict(method="direct_separable", ker_size=31),
             (scan_ds, blocked), ("fused_polynomial",),
             {"fused_polynomial[ker_size=31, blocked]": "fused_polynomial"}),
            ("crop 480x640 fft, n_angles 4", crop,
             dict(method="fft", n_angles=4), (maxima,),
             ("directional_maxima",),
             {"directional_maxima[n_angles=4]": "directional_maxima"}),
            ("1 x 4 x 480 x 640 fft, multichannel_kernel", four,
             dict(method="fft", multichannel_kernel=True), (maxima,),
             ("directional_maxima",),
             {"directional_maxima[C=4 multichannel]": "directional_maxima"})):
        shape = np.shape(x)
        npx = shape[0] * shape[1] if isinstance(x, np.ndarray) else (
            shape[-2] * shape[-1])
        counts = drive_path(label, run(x, **kw), shape, routes, kernels,
                            PSNR_F32_DB, card, npx)
        for row, k in rows.items():
            launches[row] = counts[k]
        xt = torch.as_tensor(x, device=dev)
        if xt.dim() == 3:
            xt = xt.permute(2, 0, 1)[None]
        est_kw = {k: v for k, v in kw.items() if k != "method"}
        if "multichannel_kernel" in est_kw:
            est_kw["multichannel"] = est_kw.pop("multichannel_kernel")
        thetas_equal(label, xt, **est_kw)


# (l): the bilateral kernel at the 12 MP path's 88 tiles, and the path with
# the default prefilter

def bilateral_tiles88(dev, img, report: dict) -> None:
    """The ``bilateral[n=88]`` row: the 12 MP main path's first-iteration
    tiles (448 px at step 384 on the bf16 canvas) -> f32 smooth and noise,
    against the plain version, with its device time and bound (the MUFU
    time, worked out, only in the printed line)."""
    import torch

    from polyblur_torch.ops.cuda.bilateral import bilateral, bilateral_plain
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import TileView
    from polyblur_torch.patches import _grid_steps, plan_patch_grid

    f32, bf16 = torch.float32, torch.bfloat16
    grid = plan_patch_grid(img.shape[-2], img.shape[-1], 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    tiles_el = view.n * 3 * 448 * 448

    def kernel():
        return bilateral(view, out_dtype=f32, with_noise=True)

    s, nz = kernel()
    s_p, nz_p = bilateral_plain(view, out_dtype=f32, with_noise=True)
    err = max(float((s - s_p).abs().max()), float((nz - nz_p).abs().max()))
    require(err <= TOL_BILATERAL, f"bilateral 88 tiles error {err}")
    del s, nz, s_p, nz_p
    report["bilateral[n=88]"] = r = dict(
        max_abs_err=err, ms=cuda_ms(kernel), device_ms=device_ms(kernel),
        plain_ms=cuda_ms(lambda: bilateral_plain(view, out_dtype=f32,
                                                 with_noise=True), reps=3),
        library_ms=None,
        bound=bound_ms(canvas.numel() * 2 + tiles_el * 2 * 4,
                       tiles_el * BILATERAL_FLOPS_PX, "f32"))
    print(f"bilateral[{view.n} x 3 x 448^2 bf16 tiles -> f32 smooth + "
          f"noise, 12 MP]: max_abs_err {err:.3e}, {r['ms']:.4f} ms, device "
          f"{r['device_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}; MUFU {mufu_ms(tiles_el):.4f} ms)")


def traced_kernels(fn) -> list:
    """The device kernels of one warm call of ``fn``, traced with
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the program's spans (``pb.*``) have device-side copies: no kernels
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_device_ms(kernels, key: str = "") -> float:
    """Device time in ms of the traced ``kernels`` whose name holds ``key``
    (all of them by default)."""
    return sum(e.device_time for e in kernels if key in e.name) / 1e3


def prefilter_path(dev, img, card: str, launches: dict) -> None:
    """(l): the 12 MP image through ``deblur_patches`` (448/384, bf16
    work, f32 out, ``direct_separable``, 3 iterations) with
    ``prefiltering=True`` and the default smoother (bilateral), the staged
    route: counted and held against its plain run (>= 40 dB), the
    bilateral stage launched once per iteration, theta identical kernel vs
    plain on the 88 tiles of every iteration, and the bilateral stage's
    share of the call's device time."""
    import torch

    import polyblur_torch
    from polyblur_torch import pipeline as ppipe
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda._build import plain_mode
    from polyblur_torch.patches import extract_patches, plan_patch_grid

    H, W = img.shape[-2:]
    label = ("(l) 12 MP deblur_patches 448/384 bf16, prefiltering (bilateral "
             "smoother)")

    def call():
        return polyblur_torch.deblur_patches(
            img, patch_size=448, overlap=64.0 / 448.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32, device=dev,
            **PREFILTER_KW)

    # theta of every iteration's estimate, kernel vs plain on the same tiles
    thetas = []
    estimate = ppipe.tile_estimate

    def recording(view, coeffs):
        est = estimate(view, coeffs)
        if not plain_mode():
            with pcuda.plain_versions():
                same = estimate(view, coeffs)
            thetas.append(bool(torch.equal(est[:, 0], same[:, 0])))
        return est

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = drive_path(label, call, img.shape,
                        (("deblur_patches", "staged_tiles"),),
                        NAMES + ("bilateral",), PSNR_BF16_DB, card, H * W)
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require(counts["bilateral"] == PREFILTER_KW["n_iter"],
            f"{label}: {counts['bilateral']} bilateral launches for "
            f"{PREFILTER_KW['n_iter']} iterations")
    launches["bilateral[n=88]"] = counts["bilateral"]
    ppipe.tile_estimate = recording
    try:
        call()
    finally:
        ppipe.tile_estimate = estimate
    require(len(thetas) == PREFILTER_KW["n_iter"] and all(thetas),
            f"{label}: theta kernel vs plain per iteration {thetas}")
    grid = plan_patch_grid(H, W, 448, 64.0 / 448.0)
    thetas_equal(f"{label}, first iteration's {len(grid.coords)} tiles",
                 extract_patches(img.to(torch.bfloat16), grid))
    kernels = traced_kernels(call)
    total = kernel_device_ms(kernels)
    part = kernel_device_ms(kernels, "bilateral_kernel")
    print(f"{label}: peak memory {gib:.2f} GiB; theta kernel vs plain "
          f"identical on the tiles of all {len(thetas)} iterations; device "
          f"time {total:.3f} ms, bilateral stage {part:.3f} ms = "
          f"{part / total:.3f} of it, on {card}")


def main_path_launches(dev, img, card: str, when: str) -> dict:
    """The 12 MP main path's launches per kernel (the counters zeroed just
    before one call, read just after) and its MP/s (host clock, median of
    5 calls)."""
    import torch

    import polyblur_torch
    from polyblur_torch.ops import cuda as pcuda

    H, W = img.shape[-2:]

    def main_path():
        return polyblur_torch.deblur_patches(
            img, patch_size=448, overlap=64.0 / 448.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32, device=dev,
            method="direct_separable", **PATH_KW)

    torch.cuda.synchronize()
    pcuda.reset_launches()
    main_path()
    torch.cuda.synchronize()
    counts = {k: pcuda.launches.get(k, 0) for k in NAMES}
    ms = host_ms(main_path)
    print(f"main path 12 MP bf16 {when}: {ms:.2f} ms = "
          f"{H * W / 1e6 / (ms / 1e3):.2f} MP/s on {card}; launches {counts}")
    return counts


def slice_phases(dev, card: str, launches: dict, report: dict) -> None:
    """(i) the reference demo through ``method='direct'``, and again with
    every flag and the 'nc' smoother; (j) the 12 MP patch engine with
    ``method='direct'`` (the composed route), then with q = 1e-4 and the
    saturation mask; (k) the generalized kernels and their paths; (l) the
    bilateral kernel at 88 tiles and the 12 MP path with the default
    prefilter; each path counted and held against its plain run, and the
    12 MP main path's launches and MP/s before and after, which must not
    change."""
    import torch

    import polyblur_torch
    from polyblur_torch.patches import extract_patches, plan_patch_grid

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    H, W = img.shape[-2:]
    before = main_path_launches(dev, img, card, "before (i)-(l)")
    require(before == {k: launches[k] for k in NAMES},
            f"main path launches {before} differ from the first run's")

    peacock = load_png("tests/data/peacock_defocus.png")        # (500, 700, 3)
    scan_direct = ("polyblur_core", "scan/direct")
    drive_path("(i) demo 700x500 polyblur_deblurring(method='direct')",
               lambda: polyblur_torch.polyblur_deblurring(
                   peacock, device=dev, method="direct", **PATH_KW),
               peacock.shape, (scan_direct,
                               ("inverse_filtering_rank3", "generic/direct"),
                               ("directional_maxima", "plain")),
               (), PSNR_F32_DB, card, 500 * 700)
    x = torch.as_tensor(peacock.transpose(2, 0, 1)[None].copy(), device=dev)
    drive_path("(i) demo 700x500, every flag, smoother 'nc' (polyblur_apply)",
               lambda: polyblur_torch.polyblur_apply(
                   x, method="direct", smoother="nc", device=dev,
                   **FLAGS_KW, **PATH_KW),
               x.shape, (scan_direct, ("nc_box_filter", "windowed")), (),
               PSNR_F32_DB, card, 500 * 700)
    direct_gradients(dev, card)

    grid = plan_patch_grid(H, W, 448, 64.0 / 448.0)
    tiles = extract_patches(img.to(torch.bfloat16), grid)
    composed = ("deblur_patches", "composed")
    for label, kw, routes, kernels in (
            ("(j) 12 MP deblur_patches 448/384 bf16, method='direct'", {},
             (composed, scan_direct, ("directional_maxima", "fused")),
             ("edge_pad_cast", "directional_maxima", "blend_overlap_add")),
            ("(j) the same with q=1e-4, discard_saturation",
             dict(q=1e-4, discard_saturation=True),
             (composed, scan_direct, ("directional_maxima", "plain")),
             ("edge_pad_cast", "blend_overlap_add"))):
        def call(kw=kw):
            return polyblur_torch.deblur_patches(
                img, patch_size=448, overlap=64.0 / 448.0,
                work_dtype=torch.bfloat16, out_dtype=torch.float32,
                device=dev, method="direct", **PATH_KW, **kw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = drive_path(label, call, img.shape, routes, kernels,
                            PSNR_BF16_DB, card, H * W)
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{label}: peak memory {gib:.2f} GiB on {card}; launches "
              f"{counts}")
        thetas_equal(f"{label}, first iteration's {tiles.shape[0]} tiles",
                     tiles, **kw)
    del tiles
    torch.cuda.empty_cache()
    generalized_kernels(dev, report)
    generalized_paths(dev, card, launches)
    torch.cuda.empty_cache()
    bilateral_tiles88(dev, img, report)
    torch.cuda.empty_cache()
    prefilter_path(dev, img, card, launches)
    torch.cuda.empty_cache()
    after = main_path_launches(dev, img, card, "after (i)-(l)")
    require(after == before, f"main path launches {after} after (i)-(l), "
                             f"{before} before")


# ---------------------------------------------------------- f32 dot modes
# (p): every f32 path under both f32 dot modes against its plain run; the
# 'highest' instantiations of spectral_gemm, the estimate's and the halo's
# GEMMs as kernel rows; the bf16 main path unmoved by the mode.
MODES = ("compensated", "highest")
# 'highest' against the plain f32 path on the card (~120 dB per 448 px
# application in a CPU emulation of its truncating tensor-core sums, where
# plain f32 itself is ~122 dB from exact), and its margin over
# 'compensated' on the same path
PSNR_HIGHEST_DB = 110.0
HIGHEST_GAIN_DB = 10.0
# wrappers counting a mode-free kernel under their own name: per launch of
# it, the launches of the mode's GEMM (fused_polynomial: its spectrum, then
# spectral_gemm's 4 products)
MODE_FREE_SHARE = {"fused_polynomial": 4}
TIMED_PATH_REPS = 3


def recording_thetas(records: list):
    """Within the block, record the blur direction of every estimate a
    path makes, as (index per tile or image, relative tie margin of the
    plain interpolated maxima): the tiles and patch routes'
    ``tile_estimate`` and the whole-image estimate's ``blur_direction``."""
    import contextlib

    import torch

    import polyblur_torch.estimation as estimation
    import polyblur_torch.pipeline as pipeline

    te, bd = pipeline.tile_estimate, estimation.blur_direction
    inside = []

    def tile_estimate(view, coeffs):
        inside.append(True)
        try:
            est = te(view, coeffs)
        finally:
            inside.pop()
        records.append((est[:, 0].cpu(), tie_margins(view)[1].cpu()))
        return est

    def blur_direction(interp, grid):
        res = bd(interp, grid)
        if not inside:
            srt = torch.sort(interp.float(), -1).values
            margin = (srt[..., 1] - srt[..., 0]) / srt[..., 0]
            records.append((res[0].flatten().cpu(), margin.flatten().cpu()))
        return res

    @contextlib.contextmanager
    def patched():
        pipeline.tile_estimate = tile_estimate
        estimation.blur_direction = blur_direction
        try:
            yield
        finally:
            pipeline.tile_estimate = te
            estimation.blur_direction = bd

    return patched()


def modes_path(name, fn, kernels, card, npx, modes=MODES):
    """One f32 path under each f32 dot mode against its plain run on the
    card: the launches (each of ``kernels`` under the mode's counter,
    ``name[highest]`` for 'highest', and none under the other's but for
    ``MODE_FREE_SHARE``'s mode-free launches), the PSNR
    and largest error, the blur direction of every estimate identical to
    the plain run's with the smallest tie margin, and the time; 'highest'
    must reach ``PSNR_HIGHEST_DB`` and beat 'compensated' by
    ``HIGHEST_GAIN_DB``. Returns {mode: (dB, launches)}."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops import cuda as pcuda

    plain_rec = []
    with pcuda.plain_versions(), recording_thetas(plain_rec):
        ref = torch.as_tensor(fn()).float().cpu()
    margin = min(float(m.min()) for _, m in plain_rec)
    res = {}
    for mode in modes:
        rec = []
        with f32_dot_mode_scope(mode):
            torch.cuda.synchronize()
            pcuda.reset_launches()
            with recording_thetas(rec):
                out = torch.as_tensor(fn()).float().cpu()
            torch.cuda.synchronize()
            counts = dict(pcuda.launches)
            ms = host_ms(fn, reps=TIMED_PATH_REPS)
        for k in kernels:
            high = f"{k}[highest]"
            if mode == "compensated":
                ok = counts.get(k, 0) > 0 and high not in counts
            elif k in MODE_FREE_SHARE:  # its mode-free launches keep k
                ok = counts.get(high, 0) == MODE_FREE_SHARE[k] * counts.get(
                    k, 0) > 0
            else:
                ok = counts.get(high, 0) > 0 and k not in counts
            require(ok, f"{name} [{mode}]: launches {counts} for {k}")
        require(bool(torch.isfinite(out).all()), f"{name} [{mode}]: not "
                                                 f"finite")
        same = len(rec) == len(plain_rec) and all(
            torch.equal(a, b) for (a, _), (b, _) in zip(rec, plain_rec))
        db = psnr(out, ref)
        err = float((out - ref).abs().max())
        print(f"(p) {name} [{mode}]: hand vs plain {db:.2f} dB, max_abs_err "
              f"{err:.3e}; theta identical to plain on {len(rec)} estimates: "
              f"{same} (smallest tie margin {margin:.3e}); {ms:.2f} ms = "
              f"{npx / 1e6 / (ms / 1e3):.2f} MP/s on {card}; launches "
              f"{counts}")
        require(same, f"{name} [{mode}]: theta differs from the plain run")
        require(db >= PSNR_F32_DB, f"{name} [{mode}]: {db:.2f} dB")
        res[mode] = (db, counts)
    if "highest" in res and "compensated" in res:
        hi, co = res["highest"][0], res["compensated"][0]
        require(hi >= PSNR_HIGHEST_DB and hi >= co + HIGHEST_GAIN_DB,
                f"{name}: 'highest' {hi:.2f} dB, 'compensated' {co:.2f} dB "
                f"(need >= {PSNR_HIGHEST_DB} and +{HIGHEST_GAIN_DB})")
    return res


def dense_macs(tabs) -> int:
    """MACs of one spectral application per plane as the four dense GEMMs
    the kernel runs."""
    h, wc, kp = tabs.h, tabs.wc, tabs.er.shape[1]
    oh, ow = h - 2 * tabs.pad, wc - 2 * tabs.pad
    return (2 * kp * h * wc + kp * 2 * h * 2 * h + 2 * h * kp * 2 * h
            + oh * ow * 2 * kp)


def highest_kernels(dev, img12, img2, report: dict) -> None:
    """The 'highest' instantiations of spectral_gemm and of the estimate
    GEMM at the 12 MP main path's shapes in f32 (88 tiles of 448 px), and
    of the halo's GEMM at config 2's (12 tiles), each under both modes
    against the plain version; fills their kernel rows. Their bounds count
    the six tf32 products per MAC of the GEMMs at the TF32 peak, or the
    bytes, whichever is larger."""
    import torch

    from polyblur_torch import f32_dot_mode_scope
    from polyblur_torch.ops.cuda.bilateral import bilateral
    from polyblur_torch.ops.cuda.features import (
        halo_grads, halo_grads_plain, halo_mask, halo_mask_plain)
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        HALF, TileView, _gray_norm_plain, kernel_spectrum, spectral_poly,
        spectral_poly_plain, stage_tables, tile_estimate,
        tile_estimate_plain)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack

    f32 = torch.float32
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)

    def tiles_of(img, overlap):
        grid = plan_patch_grid(img.shape[-2], img.shape[-1], 448, overlap)
        th, tw, sh, sw = _grid_steps(grid)
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, f32)
        return canvas, TileView(canvas, 1, 0, th * tw, tw, (sh, sw),
                                (448, 448))

    canvas, view = tiles_of(img12, 64.0 / 448.0)
    n, c = view.n, view.channels
    est_p = tile_estimate_plain(view, coeffs)
    _, margins = tie_margins(view)
    tabs = stage_tables(448, 448, f32, str(dev))
    q2 = kernel_spectrum(est_p, coeffs, tabs)
    out_p = spectral_poly_plain(view, q2, tabs)
    pair_macs = n * 448 * 448 * (448 + 448)
    for mode in MODES:
        with f32_dot_mode_scope(mode):
            est = tile_estimate(view, coeffs)
            out = spectral_poly(view, q2, tabs)
            est_ms = cuda_ms(lambda: tile_estimate(view, coeffs))
            app_ms = cuda_ms(lambda: spectral_poly(view, q2, tabs))
            # the split of the call over its four launches
            stages = estimate_stages(view, coeffs, f"(p) tile_estimate[f32 "
                                     f"{mode}, {n} tiles] launches")
            if mode == "highest":
                gb = 12.0 * pair_macs / PEAK_FLOPS["tf32"] * 1e3
                print(f"  (p) est_gemm[highest]: {stages['gemm']:.4f} ms "
                      f"against its bound {gb:.4f} ms (operations: six "
                      f"tf32 products per MAC): {100 * gb / stages['gemm']:.1f}"
                      f"% of it")
            spectral_modes(view, q2, tabs, f"spectral_gemm[f32 {mode}, "
                           f"{n * c} planes, h {tabs.h}]",
                           high=mode == "highest")
        same = bool(torch.equal(est[:, 0], est_p[:, 0]))
        rel = float(((est[:, 1:] - est_p[:, 1:]).abs()
                     / est_p[:, 1:].abs().clamp(min=1e-30)).max())
        err = float((out - out_p).abs().max())
        print(f"(p) tile_estimate[f32 {mode}, {n} x {c} x 448^2]: theta idx "
              f"identical on {n} tiles: {same} (smallest tie margin "
              f"{float(margins.min()):.3e}), max rel err {rel:.3e}, "
              f"{est_ms:.4f} ms")
        print(f"(p) spectral_gemm[f32 {mode}, {n * c} planes]: max_abs_err "
              f"{err:.3e} (PSNR {psnr(out, out_p):.1f} dB), application "
              f"{app_ms:.4f} ms")
        require(same, f"tile_estimate f32 {mode}: theta differs")
        require(rel <= TOL_REL_EST, f"tile_estimate f32 {mode}: {rel}")
        require(err <= TOL_SPEC_F32, f"spectral_gemm f32 {mode}: {err}")
    with f32_dot_mode_scope("highest"):
        report["tile_estimate[highest]"] = dict(
            max_abs_err=float((est[:, 1:] - est_p[:, 1:]).abs().max()),
            ms=est_ms,
            plain_ms=cuda_ms(lambda: tile_estimate_plain(view, coeffs),
                             reps=3),
            library_ms=gemm_pair_library_ms(_gray_norm_plain(view)),
            library_what=LIBRARY_GEMM_PAIR,
            bound=bound_ms(canvas.numel() * 4 + est.numel() * 4,
                           12.0 * pair_macs, "tf32"))
        xpad = torch.nn.functional.pad(
            view.tiles().reshape(-1, 1, 448, 448), (HALF,) * 4,
            mode="replicate")[:, 0]
        K = tabs.wc // 2 + 1
        qh = (q2[:, :, :K] * tabs.h).repeat_interleave(c, 0)

        def fft_app():
            y = torch.fft.irfft2(qh * torch.fft.rfft2(xpad),
                                 s=(tabs.h, tabs.wc))
            return y[:, HALF:HALF + 448, HALF:HALF + 448].clamp(0, 1)

        report["spectral_gemm[highest]"] = dict(
            max_abs_err=err, ms=app_ms,
            plain_ms=cuda_ms(lambda: spectral_poly_plain(view, q2, tabs),
                             reps=3),
            library_ms=cuda_ms(fft_app, reps=3),
            bound=bound_ms(2 * out.numel() * 4 + q2.numel() * 4,
                           12.0 * n * c * dense_macs(tabs), "tf32"))
    del canvas, view, est, est_p, q2, out, out_p, xpad, qh
    torch.cuda.empty_cache()

    # the halo at config 2's shapes in f32: the input gradients and one
    # mask pass of the bilateral set's o
    canvas, view = tiles_of(img2, 1.0 / 7.0)
    n = view.n
    smooth, nz = bilateral(view, out_dtype=f32, with_noise=True)
    sv = TileView.of_tiles(smooth)
    est = tile_estimate(view, coeffs)
    q2 = kernel_spectrum(est, coeffs, tabs)
    o = spectral_poly(sv, q2, tabs, clip=False, out_dtype=f32)
    grads_p = halo_grads_plain(view)
    ref = halo_mask_plain(o, grads_p, sv, nz, torch.empty_like(o))
    gscale = float(grads_p.gx.abs().max())
    for mode in MODES:
        with f32_dot_mode_scope(mode):
            grads = halo_grads(view)
            out = halo_mask(o, grads, sv, nz, torch.empty_like(o))

            def halo(g=halo_grads, m=halo_mask):
                return m(o, g(view), sv, nz, torch.empty_like(o))

            ms = cuda_ms(halo)
            # the split over the two epilogues
            g_ms = cuda_ms(lambda: halo_grads(view))
            m_ms = cuda_ms(lambda: halo_mask(o, grads, sv, nz,
                                             torch.empty_like(o)))
            print(f"  (p) halo[f32 {mode}, {n} tiles] launches: gradients "
                  f"{g_ms:.4f} ms, mask {m_ms:.4f} ms")
        rel = max(float((grads.gx - grads_p.gx).abs().max()),
                  float((grads.gy - grads_p.gy).abs().max())) / gscale
        err = float((out - ref).abs().max())
        print(f"(p) halo[f32 {mode}, {n} x 3 x 448^2]: gradients rel err "
              f"{rel:.3e}, mask max_abs_err {err:.3e}, gradients + mask "
              f"{ms:.4f} ms")
        require(rel <= TOL_REL_GRADS, f"halo f32 {mode}: gradients {rel}")
        require(err <= TOL_SPEC_F32, f"halo f32 {mode}: mask {err}")
    el = n * 3 * 448 * 448
    xin = view.tiles().float()
    report["halo[highest]"] = dict(
        max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(lambda: halo(halo_grads_plain, halo_mask_plain),
                         reps=3),
        library_ms=gemm_pair_library_ms(xin) + gemm_pair_library_ms(o),
        library_what=LIBRARY_GEMM_PAIR + ", on the input planes and on o",
        # the canvas, o, u_cmp and the noise read once, the f32 tiles
        # written once; the two GEMM pairs at six tf32 products per MAC
        bound=bound_ms(canvas.numel() * 4 + el * 4 * 4,
                       2 * 12.0 * n * 3 * 448 * 448 * (448 + 448), "tf32"))
    del canvas, view, smooth, nz, o, grads, grads_p, out, ref, xin
    torch.cuda.empty_cache()

    # fused_polynomial on the 2 MP photo's overlap-save blocks (as
    # whole_image_kernels): spectral_gemm's 'highest' case at pad 0
    from polyblur_torch.estimation import gaussian_blur_estimation
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.polyblur_fused import spectrum_plain
    from polyblur_torch.ops.cuda.sep_poly_fused import (
        fused_polynomial, fused_polynomial_plain)

    photo = torch.as_tensor(load_png("tests/data/corpus_hr/peacock_tiled.png")
                            .transpose(2, 0, 1)[None].copy(), device=dev)
    sig, rho, theta = gaussian_blur_estimation(photo, c=0.362, b=0.468,
                                               return_2d_filters=False)
    qf = sep_poly.gaussian_quadratic_coeffs(sig[:, 0], rho[:, 0], theta[:, 0])
    view, (th, _, tw, _, _) = sep_poly._block_view(photo[0], 12)
    params = torch.stack(qf, -1).repeat(3, 1).repeat(th * tw, 1)
    ref = fused_polynomial_plain(view, params, coeffs)
    bh, bw = view.patch
    tabs_b = stage_tables(bh, bw, f32, str(dev), 0)
    q2b = spectrum_plain(params[:, 0], params[:, 1], params[:, 2], coeffs,
                         tabs_b)
    for mode in MODES:
        with f32_dot_mode_scope(mode):
            out = fused_polynomial(view, params, coeffs)
            ms = cuda_ms(lambda: fused_polynomial(view, params, coeffs))
            spectral_modes(view, q2b, tabs_b, f"(p) spectral_gemm[f32 {mode},"
                           f" {view.n} blocks {bh}x{bw}, pad 0]", clip=False,
                           high=mode == "highest")
        err = float((out - ref).abs().max())
        bms, by = bound_ms(2 * out.numel() * 4 + params.numel() * 4,
                           12.0 * view.n * dense_macs(tabs_b), "tf32")
        print(f"(p) fused_polynomial[f32 {mode}, {view.n} blocks {bh}x{bw}, "
              f"pad 0]: max_abs_err {err:.3e} (PSNR {psnr(out, ref):.1f} "
              f"dB), {ms:.4f} ms; 'highest' bound {bms:.4f} ms ({by}, six "
              f"tf32 products per MAC)")
        require(err <= TOL_POLY_F32, f"fused_polynomial f32 {mode}: {err}")


def dot_mode_phases(dev, card: str, launches: dict, report: dict) -> None:
    """(p): the 'highest' kernels (:func:`highest_kernels`); the f32 paths
    (12 MP patches, config 2b, the 480 x 640 tiles route, the 2 MP photo's
    blocked ``fused_polynomial`` route, training (d)'s tiles-route step)
    under both modes against their plain runs (:func:`modes_path`); the
    mode-free fft route (``directional_maxima``) and the bf16 main path
    identical under both modes with the main path's launches."""
    import torch

    import polyblur_torch
    from polyblur_torch import PolyblurLayer, f32_dot_mode_scope
    from polyblur_torch.ops import cuda as pcuda

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    highest_kernels(dev, img, img2, report)
    torch.cuda.empty_cache()
    H, W = img.shape[-2:]

    def main_path(wd):
        return polyblur_torch.deblur_patches(
            img, patch_size=448, overlap=64.0 / 448.0, work_dtype=wd,
            out_dtype=torch.float32, device=dev, method="direct_separable",
            **PATH_KW)

    res = modes_path("12 MP deblur_patches 448/384 f32",
                     lambda: main_path(torch.float32),
                     ("tile_estimate", "spectral_gemm"), card, H * W)
    for k in ("tile_estimate", "spectral_gemm"):
        launches[f"{k}[highest]"] = res["highest"][1][f"{k}[highest]"]
    res = modes_path(
        "config 2b: 2 MP deblur_patches f32, taper + dt + halo",
        lambda: polyblur_torch.deblur_patches(
            img2, patch_size=448, overlap=1.0 / 7.0, work_dtype=torch.float32,
            out_dtype=torch.float32, device=dev, method="direct_separable",
            **CFG2_KW),
        ("tile_estimate", "spectral_gemm", "halo"), card,
        img2.shape[-2] * img2.shape[-1])
    launches["halo[highest]"] = res["highest"][1]["halo[highest]"]
    peacock = load_png("tests/data/peacock_defocus.png")
    crop = torch.as_tensor(peacock[:480, :640].transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    modes_path("crop 480x640 tiles route f32",
               lambda: polyblur_torch.polyblur_deblurring(
                   crop, device=dev, method="direct_separable", **PATH_KW),
               ("tile_estimate", "spectral_gemm"), card, 480 * 640)
    photo = load_png("tests/data/corpus_hr/peacock_tiled.png")
    modes_path("2 MP photo 1600x1200 (blocked fused_polynomial)",
               lambda: polyblur_torch.polyblur_deblurring(
                   photo, device=dev, **PATH_KW),
               ("fused_polynomial",), card, 1200 * 1600)

    # training (d)'s tiles-route step under each mode (its forward is the
    # crop's tiles route above; the backward replays the plain versions)
    def layer_d():
        return PolyblurLayer(n_iter=3, learnable=True,
                             method="direct_separable", device=dev)

    for mode in MODES:
        high = "[highest]" if mode == "highest" else ""
        with f32_dot_mode_scope(mode):
            grads_vs_plain(f"(p) (d) tiles route 1 x 3 x 480 x 640 f32 "
                           f"[{mode}]", layer_d, crop, crop,
                           TOL_REL_GRAD_F32,
                           PSNR_HIGHEST_DB if high else PSNR_F32_DB,
                           ("polyblur_core", "tiles"),
                           {f"tile_estimate{high}": 12, "kernel_spectrum": 3,
                            f"spectral_gemm{high}": 12})

    # mode-free: the fft route (directional_maxima, the composed rfft2
    # polynomial) and the bf16 main path
    outs = {}
    for mode in MODES:
        with f32_dot_mode_scope(mode):
            torch.cuda.synchronize()
            pcuda.reset_launches()
            fft = polyblur_torch.polyblur_deblurring(crop, device=dev,
                                                     method="fft", **PATH_KW)
            torch.cuda.synchronize()
            fft_counts = dict(pcuda.launches)
            pcuda.reset_launches()
            out16 = main_path(torch.bfloat16)
            torch.cuda.synchronize()
            outs[mode] = (fft, fft_counts, out16, dict(pcuda.launches))
    (fa, fca, ma, mca), (fb, fcb, mb, mcb) = (outs[m] for m in MODES)
    same_fft, same_main = bool(torch.equal(fa, fb)), bool(torch.equal(ma, mb))
    print(f"(p) crop 480x640 method=fft under both modes: identical "
          f"{same_fft}, launches {fca} / {fcb}")
    print(f"(p) main path 12 MP bf16 under both modes: identical "
          f"{same_main}, launches {mca} / {mcb} ({sum(mca.values())} "
          f"launches)")
    require(same_fft and fca == fcb and fca.get("directional_maxima", 0) > 0,
            "the fft route moved with the f32 dot mode")
    require(same_main and mca == mcb
            and mca == {k: launches[k] for k in NAMES},
            "the bf16 main path moved with the f32 dot mode")


# ---------------------------------------------------------- burst
# (q): the burst serving path (polyblur_torch.cli.burst over the host
# runtime) on four 12 MP photos and the peacock
BURST_DIR = "build/chip_smoke_burst"
BURST_12MP = 4
BURST_NAMES = ("edge_pad_cast", "tile_estimate", "kernel_spectrum",
               "spectral_gemm", "blend_overlap_add")
TOL_BURST_F32_LSB = 1   # f32 work: the outputs' 8 bits within one step


def burst_phases(dev, card: str) -> None:
    """(q): write four 12 MP photos (``make_12mp_image`` at seeds 1-4,
    quantized to 8 bits) and the peacock as PNGs, run ``cli.burst.main``
    on the card in bf16 and in f32 (its defaults: 400 px tiles at overlap
    0.25, 3 iterations), each against the same CLI under
    ``plain_versions()``: every kernel of the path launched, bf16 PNGs
    >= 40 dB from the plain run's, f32 PNGs within one 8-bit step; prints
    the steady-state MP/s (the images after the first), the mean host
    decode and device times per image, and ``native_available()``."""
    import concurrent.futures as cf
    import glob
    import os
    import shutil

    import torch
    from PIL import Image

    from polyblur_torch.cli import burst
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.runtime import native

    status = native.native_available()
    print(f"(q) native host runtime: available {status.available} "
          f"({status.reason})")
    src = os.path.join(BURST_DIR, "in")
    shutil.rmtree(BURST_DIR, ignore_errors=True)
    os.makedirs(src)

    def photo(k):
        x = make_12mp_image(np.random.default_rng(k + 1))[0]
        u8 = (255.0 * x.transpose(1, 2, 0) + 0.5).astype(np.uint8)
        Image.fromarray(u8).save(os.path.join(src, f"photo12mp_{k}.png"),
                                 compress_level=1)

    def read(path):
        return np.asarray(Image.open(path)).astype(np.float64)

    with cf.ThreadPoolExecutor(BURST_12MP) as pool:
        list(pool.map(photo, range(BURST_12MP)))
    shutil.copy("tests/data/peacock_defocus.png",
                os.path.join(src, "peacock.png"))
    paths = sorted(glob.glob(os.path.join(src, "*.png")))
    for dtype in ("bfloat16", "float32"):
        args = ["--images", os.path.join(src, "*.png"), "--dtype", dtype]
        outs = {}
        for plain in (False, True):
            out = os.path.join(BURST_DIR, f"{dtype}_{'plain' if plain else 'hand'}")
            stats = []
            torch.cuda.synchronize()
            pcuda.reset_launches()
            with pcuda.plain_versions(plain):
                n = burst.main(args + ["--outdir", out], stats=stats)
            torch.cuda.synchronize()
            counts = dict(pcuda.launches)
            require(n == len(paths), f"(q) burst {dtype}: {n} images")
            if not plain:
                for k in BURST_NAMES:
                    require(counts.get(k, 0) > 0, f"(q) burst {dtype}: {k} "
                                                  f"never launched ({counts})")
                hand_stats, hand_counts = stats, counts
            else:
                require(not counts, f"(q) plain burst launched {counts}")
            outs[plain] = out
        worst = None
        names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        with cf.ThreadPoolExecutor(4) as pool:
            pngs = list(pool.map(read, [
                os.path.join(outs[plain], f"{name}_restored.png")
                for name in names for plain in (False, True)]))
        for path, name, a, b in zip(paths, names, pngs[::2], pngs[1::2]):
            require(a.shape == b.shape == Image.open(path).size[::-1] + (3,),
                    f"(q) burst {dtype} {name}: shapes {a.shape} {b.shape}")
            lsb = int(np.abs(a - b).max())
            db = psnr(torch.from_numpy(a / 255.0), torch.from_numpy(b / 255.0))
            if dtype == "bfloat16":
                require(db >= PSNR_BF16_DB, f"(q) burst bf16 {name}: "
                                            f"{db:.2f} dB from plain")
            else:
                require(lsb <= TOL_BURST_F32_LSB, f"(q) burst f32 {name}: "
                                                  f"{lsb} LSB from plain")
            worst = (min(worst[0], db), max(worst[1], lsb)) if worst else (
                db, lsb)
        steady = hand_stats[1:]
        mps = sum(s["mp"] for s in steady) / (steady[-1]["done"]
                                              - hand_stats[0]["done"])
        dec = statistics.mean(s["decode_ms"] for s in hand_stats)
        devm = statistics.mean(s["device_ms"] for s in hand_stats)
        dev12 = statistics.mean([s["device_ms"] for s in hand_stats
                                 if s["mp"] > 10] or [math.nan])
        print(f"(q) burst {dtype}: {len(paths)} images "
              f"({BURST_12MP} x 12 MP + the peacock), steady state "
              f"{mps:.2f} MP/s (images 2-{len(paths)}), mean host decode "
              f"{dec:.1f} ms, mean device {devm:.1f} ms per image (12 MP: "
              f"{dev12:.1f} ms); vs the plain run: worst {worst[0]:.2f} dB, "
              f"{worst[1]} LSB; launches {hand_counts} on {card}")


# ---------------------------------------------------------- parallel
# (r): polyblur_torch.parallel on the card at world size 1 over NCCL (the
# card's machine has one card; more ranks run on the CPU over gloo in
# tests/test_torch_parallel.py)
PARALLEL_KW = dict(PATH_KW, method="direct_separable")
PARALLEL_GRID = dict(patch_size=448, overlap=64.0 / 448.0)
PARALLEL_LR = 10.0      # SGD steps that move each scalar visibly


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def training_pair(dev, img):
    """A (2, 3, 256, 256) f32 pair: two crops of the 12 MP image squeezed
    into [0.2, 0.8] as the sharp target (no output pixel clips, so every
    scalar has a gradient) and their Gaussian blur (sigma 1.5, replicate
    edges) as the input."""
    import torch
    import torch.nn.functional as F

    sharp = 0.2 + 0.6 * torch.cat([img[..., 1000:1256, 1000:1256],
                                   img[..., 2000:2256, 3000:3256]])
    r = torch.arange(-4, 5, dtype=torch.float32, device=dev)
    k = torch.exp(-r ** 2 / (2 * 1.5 ** 2))
    k = k / k.sum()
    x = F.pad(sharp.reshape(-1, 1, 256, 256), (4, 4, 4, 4), mode="replicate")
    x = F.conv2d(F.conv2d(x, k.view(1, 1, 1, 9)), k.view(1, 1, 9, 1))
    return x.reshape(sharp.shape).contiguous(), sharp.contiguous()


def parallel_phases(dev, card: str) -> None:
    """(r): ``initialize_distributed`` brings up a world of one over NCCL
    (a second call keeps it); on ``make_mesh()``'s mesh the 12 MP image in
    bf16 goes through ``deblur_sharded`` (448 px tiles at overlap 64/448,
    the main path's settings), with every launch counter zeroed just
    before and read just after: the main path's five kernels launched,
    the result equal to ``extract_patches -> polyblur_core ->
    overlap_add`` and >= 40 dB from its plain run, its ms beside
    ``deblur_patches``'; the banded reassembly >= 40 dB from it and from
    its own plain run; ``data_parallel_deblur`` on 4 x 3 x 480 x 640
    equal to ``polyblur_core`` on the batch; ``training_step`` and
    ``make_sharded_train_step`` on a 2 x 3 x 256 x 256 f32 pair equal to
    the world-free steps (autograd of the same loss,
    ``training.make_train_step``); then the group is destroyed."""
    import torch
    import torch.distributed as dist

    from polyblur_torch import PolyblurLayer, deblur_patches, make_train_step
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.parallel.distributed import initialize_distributed
    from polyblur_torch.parallel.sharding import (
        assemble_bands, data_parallel_deblur, deblur_sharded,
        deblur_sharded_reassembly, make_mesh, make_sharded_train_step,
        training_step)
    from polyblur_torch.patches import (extract_patches, overlap_add,
                                        plan_patch_grid)
    from polyblur_torch.pipeline import polyblur_core

    t0 = time.perf_counter()
    addr = f"127.0.0.1:{free_port()}"
    for call in ("first", "second"):
        live = initialize_distributed(coordinator_address=addr,
                                      num_processes=1, process_id=0)
        require(live is True, f"(r) initialize_distributed, {call} call: "
                              f"{live}")
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            f"(r) backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
    print(f"(r) torch.distributed: backend nccl, world 1, NCCL "
          f"{torch.cuda.nccl.version()}, init {time.perf_counter() - t0:.2f} s")
    try:
        mesh = make_mesh()
        require(mesh.shape == {"data": 1, "tile": 1}
                and mesh.device.type == "cuda"
                and mesh.device_mesh is not None, f"(r) mesh {mesh}")
        img32 = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                                device=dev)
        img = img32.to(torch.bfloat16)
        H, W = img.shape[-2:]

        def sharded():
            return deblur_sharded(img, mesh, **PARALLEL_GRID, **PARALLEL_KW)

        torch.cuda.synchronize()
        pcuda.reset_launches()
        out = sharded()
        torch.cuda.synchronize()
        counts = dict(pcuda.launches)
        for name in NAMES:
            require(counts.get(name, 0) > 0, f"(r) deblur_sharded: {name} "
                                             f"never launched ({counts})")
        grid = plan_patch_grid(H, W, **PARALLEL_GRID)
        chain = overlap_add(polyblur_core(extract_patches(img, grid),
                                          device=dev, **PARALLEL_KW), grid, 1)
        require(torch.equal(out, chain), "(r) deblur_sharded differs from "
                "extract_patches -> polyblur_core -> overlap_add")
        with pcuda.plain_versions():
            plain = sharded()
        db = psnr(out, plain)
        require(db >= PSNR_BF16_DB, f"(r) deblur_sharded {db:.2f} dB from "
                                    f"its plain run")
        ms = host_ms(sharded, reps=3)
        ms_patches = host_ms(lambda: deblur_patches(
            img, device=dev, **PARALLEL_GRID, **PARALLEL_KW), reps=3)
        print(f"(r) deblur_sharded 12 MP bf16 (448/384 tiles, world 1 over "
              f"NCCL): equal to the composed chain, {db:.2f} dB from plain, "
              f"launches {counts}; {ms:.2f} ms (median of 3) = "
              f"{H * W / 1e6 / ms * 1e3:.2f} MP/s, deblur_patches "
              f"{ms_patches:.2f} ms on {card}")
        del plain, chain

        def reassembled():
            return assemble_bands(*deblur_sharded_reassembly(
                img, mesh, **PARALLEL_GRID, **PARALLEL_KW))

        asm = reassembled()
        with pcuda.plain_versions():
            asm_plain = reassembled()
        require(asm.shape == out.shape, f"(r) reassembly {asm.shape}")
        db_g, db_p = psnr(asm, out), psnr(asm, asm_plain)
        require(min(db_g, db_p) >= PSNR_BF16_DB, f"(r) reassembly {db_g:.2f} "
                f"dB from deblur_sharded, {db_p:.2f} dB from its plain run")
        print(f"(r) deblur_sharded_reassembly + assemble_bands 12 MP bf16: "
              f"{db_g:.2f} dB from deblur_sharded, {db_p:.2f} dB from its "
              f"plain run")
        del asm, asm_plain, out, img

        batch = torch.cat([img32[..., 480 * i:480 * (i + 1), :640]
                           for i in range(4)]).contiguous()
        pcuda.reset_launches()
        dp = data_parallel_deblur(batch, mesh, **PARALLEL_KW)
        torch.cuda.synchronize()
        dp_counts = dict(pcuda.launches)
        require(torch.equal(dp, polyblur_core(batch, device=dev,
                                              **PARALLEL_KW)),
                "(r) data_parallel_deblur differs from polyblur_core")
        print(f"(r) data_parallel_deblur 4 x 3 x 480 x 640 f32: equal to "
              f"polyblur_core on the batch, launches {dp_counts}")

        blurry, sharp = training_pair(dev, img32)
        del img32
        params = dict(c=0.362, b=0.468, alpha=6.0, beta=1.0)
        new, loss = training_step(params, blurry, sharp, mesh,
                                  lr=PARALLEL_LR, n_iter=2)
        p = {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in params.items()}
        o = polyblur_core(blurry, n_iter=2, method="direct_separable",
                          remat=True, device=dev, **p)
        want = torch.mean((o - sharp) ** 2)
        grads = torch.autograd.grad(want, list(p.values()))
        for (k, v), g in zip(p.items(), grads):
            require(torch.equal(new[k], v.detach() - PARALLEL_LR * g),
                    f"(r) training_step {k}: {float(new[k])!r} against "
                    f"{float(v.detach() - PARALLEL_LR * g)!r}")
        require(torch.equal(loss, want.detach()), "(r) training_step loss")
        print(f"(r) training_step 2 x 3 x 256^2 f32, lr {PARALLEL_LR}: "
              f"equal to autograd of the same loss; loss {float(loss):.6e}, "
              f"gradients {[f'{float(g):.6e}' for g in grads]}")

        layers = [PolyblurLayer(n_iter=2, learnable=True,
                                method="direct_separable", device=dev)
                  for _ in range(2)]
        opts = [torch.optim.Adam(la.parameters(), lr=1e-2) for la in layers]
        steps = (make_sharded_train_step(layers[0], opts[0], mesh),
                 make_train_step(layers[1], opts[1]))
        losses = []
        for _ in range(2):
            pair = [s(blurry, sharp) for s in steps]
            require(torch.equal(*pair), f"(r) sharded train step loss "
                                        f"{pair}")
            losses.append(float(pair[0]))
        for a, b in zip(*(la.parameters() for la in layers)):
            require(torch.equal(a, b), f"(r) sharded train step params "
                                       f"{a} {b}")
        print(f"(r) make_sharded_train_step, 2 Adam steps: parameters and "
              f"losses {losses} equal to make_train_step's")
    finally:
        dist.destroy_process_group()
    print(f"(r) {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------ irregular, verbose, tools
# (m)-(o): an irregular 12 MP tile grid, verbose=True and the user-facing
# tools (polyblur_torch.cli).

IRREGULAR_KW = dict(PATH_KW, method="direct_separable")
# 12 MP at 448 px tiles, overlap 0.6: step int(448 * 0.4) = 179, 16 x 21
IRREGULAR_TILES = 336
VERBOSE_STAGES = 1 + 2 * PATH_KW["n_iter"]
CLI_OUTDIR = "build/chip_smoke_cli"


def irregular_path(dev, img, card: str) -> None:
    """(m): the 12 MP image through ``deblur_patches`` at 448 px, overlap
    0.6 (an irregular grid: the composed route, the tiles route's kernels
    on all 336 tiles as one batch, the plain slice-add blend), bf16 work,
    f32 out, counted and held against its plain run; theta identical
    kernel vs plain on the tiles of every iteration; MP/s, device busy,
    peak memory and the blend's own host and device time. Then
    ``PolyblurDeblurring`` at that overlap on the 1200 x 1600 photo, and
    one ``PolyblurLayer`` step through the 12 MP irregular grid in f32
    against the plain step under (a)'s gates."""
    import torch

    import polyblur_torch
    from polyblur_torch import PolyblurLayer
    from polyblur_torch import pipeline as ppipe
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda._build import plain_mode
    from polyblur_torch.patches import (_grid_steps, extract_patches,
                                        overlap_add, plan_patch_grid)

    H, W = img.shape[-2:]
    grid = plan_patch_grid(H, W, 448, 0.6)
    require(_grid_steps(grid) is None and len(grid.coords) == IRREGULAR_TILES,
            f"(m): the 448 / 0.6 grid has {len(grid.coords)} tiles")
    label = "(m) 12 MP deblur_patches 448 px overlap 0.6 (336 tiles) bf16"

    def call():
        return polyblur_torch.deblur_patches(
            img, patch_size=448, overlap=0.6, work_dtype=torch.bfloat16,
            out_dtype=torch.float32, device=dev, **IRREGULAR_KW)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = drive_path(label, call, img.shape,
                        (("deblur_patches", "composed"),
                         ("polyblur_core", "tiles")),
                        ("edge_pad_cast",) + TILE_STAGES, PSNR_BF16_DB, card,
                        H * W)
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    require("blend_overlap_add" not in counts,
            f"{label}: the regular grids' blend kernel launched")
    thetas = []
    estimate = ppipe.tile_estimate

    def recording(view, coeffs):
        est = estimate(view, coeffs)
        if not plain_mode():
            with pcuda.plain_versions():
                same = estimate(view, coeffs)
            thetas.append(bool(torch.equal(est[:, 0], same[:, 0])))
        return est

    ppipe.tile_estimate = recording
    try:
        call()
    finally:
        ppipe.tile_estimate = estimate
    require(len(thetas) == PATH_KW["n_iter"] and all(thetas),
            f"{label}: theta kernel vs plain per iteration {thetas}")
    ms = host_ms(call)
    kernels = traced_kernels(call)
    busy = kernel_device_ms(kernels)
    # the blend alone, on the restored tiles
    tiles = extract_patches(img.to(torch.bfloat16), grid)
    restored = polyblur_torch.pipeline.polyblur_core(tiles, device=dev,
                                                     **IRREGULAR_KW)
    del tiles

    def blend():
        return overlap_add(restored, grid, 1, out_dtype=torch.float32)

    blend_ms = host_ms(blend)
    blend_busy = kernel_device_ms(traced_kernels(blend))
    print(f"{label}: {ms:.2f} ms = {H * W / 1e6 / (ms / 1e3):.2f} MP/s "
          f"(median of 5) on {card}; device busy {busy:.3f} ms "
          f"({len(kernels)} device kernels); peak memory {gib:.2f} GiB; "
          f"launches {counts}; theta kernel vs plain identical on the "
          f"{IRREGULAR_TILES} tiles of all {len(thetas)} iterations; the "
          f"blend ({IRREGULAR_TILES} slice-adds) alone {blend_ms:.3f} ms "
          f"host, {blend_busy:.3f} ms device")
    del restored
    torch.cuda.empty_cache()

    photo = make_config2_image()
    module = polyblur_torch.PolyblurDeblurring(
        patch_decomposition=True, patch_size=448, patch_overlap=0.6,
        device=dev)
    drive_path("(m) PolyblurDeblurring 448 px overlap 0.6, 1200x1600 photo",
               lambda: module(photo, **PATH_KW), photo.shape,
               (("deblur_patches", "composed"), ("polyblur_core", "tiles")),
               ("edge_pad_cast",) + TILE_STAGES, PSNR_F32_DB, card,
               photo.shape[0] * photo.shape[1])

    # the layer step in f32: in bf16 the two steps' states differ by the
    # output's rounding, and over 336 tiles x 3 iterations a first theta
    # flip against the plain step drew a 1.456e-3 tie margin (gate
    # TOL_TIE_STEP; on an H100 80GB HBM3 at 700 W); in f32 the states
    # agree to ~90 dB
    def layer_m():
        return PolyblurLayer(n_iter=3, learnable=True, patch_size=448,
                             patch_overlap=0.6, method="direct_separable",
                             device=dev)

    forward = free_launches(layer_m, img)
    require(forward == counts, f"(m) layer: grad-free launches {forward}, "
                               f"the path's {counts}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    theta_checked("(m)", lambda on_run: grads_vs_plain(
        "(m) 12 MP f32 irregular patch layer", layer_m, img, img,
        TOL_REL_GRAD_F32, PSNR_F32_DB, ("deblur_patches", "composed"),
        forward, on_run=on_run))
    torch.cuda.synchronize()
    print(f"(m) layer step, kernels and plain: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {card}")
    torch.cuda.empty_cache()


def stage_lines(fn):
    """(result, the printed ``-- ...`` lines) of ``fn()``; the lines are
    printed again."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("-- ")]
    for ln in lines:
        print(f"  {ln}")
    return out, lines


def verbose_paths(dev, img12, card: str) -> None:
    """(n): ``polyblur_deblurring(verbose=True)`` on the demo, on config
    2's photo with every flag (the scan route's stages with the bilateral
    smoother), on a 480 x 640 crop through ``'fft'`` (the fused maxima)
    and on 12 MP ``auto`` (one line around the patch engine):
    the stage lines printed, the stage loop's kernels launched, and the
    result identical to ``verbose=False``."""
    import torch

    import polyblur_torch
    from polyblur_torch.ops import cuda as pcuda

    peacock = load_png("tests/data/peacock_defocus.png")
    photo = make_config2_image()
    # past 640 px the estimate takes the plain maxima chain; the fused
    # maxima kernel runs in the stage loop of an image within that edge
    crop = np.ascontiguousarray(peacock[:480, :640])
    for label, x, kw, n_lines, kernels in (
            ("(n) verbose demo 700x500", peacock, {}, VERBOSE_STAGES,
             ("fused_polynomial",)),
            ("(n) verbose config 2's photo, every flag", photo, FLAGS_KW,
             VERBOSE_STAGES, ("fused_polynomial", "bilateral")),
            ("(n) verbose crop 480x640 method='fft'", crop,
             dict(method="fft"), VERBOSE_STAGES, ("directional_maxima",)),
            ("(n) verbose 12 MP method='auto'", img12, {}, 1, NAMES)):
        def run(verbose, x=x, kw=kw):
            return polyblur_torch.polyblur_deblurring(
                x, device=dev, verbose=verbose, **PATH_KW, **kw)

        quiet = torch.as_tensor(run(False))
        torch.cuda.synchronize()
        pcuda.reset_launches()
        t0 = time.perf_counter()
        loud, lines = stage_lines(lambda: run(True))
        sec = time.perf_counter() - t0
        counts = dict(pcuda.launches)
        same = bool(torch.equal(torch.as_tensor(loud), quiet))
        print(f"{label}: {len(lines)} stage lines, {sec * 1e3:.2f} ms with "
              f"the syncs on {card}; launches {counts}; identical to "
              f"verbose=False: {same}")
        require(len(lines) == n_lines, f"{label}: {len(lines)} stage lines, "
                                       f"expected {n_lines}")
        for k in kernels:
            require(counts.get(k, 0) > 0, f"{label}: {k} never launched")
        require(same, f"{label}: verbose changed the result")


def cli_phases(dev, card: str) -> None:
    """(o): ``cli.main`` on the peacock with the demo's flags, then with
    the patch engine at overlap 0.6, each PNG equal to ``imsave_uint8`` of
    the API's output on the same arguments; ``cli.bench_suite --quick``
    (its table printed); ``cli.calibrate`` at the JAX package's test
    arguments (tests/test_runtime.py:101-107)."""
    import os

    from PIL import Image

    import polyblur_torch
    from polyblur_torch.cli import bench_suite as cbench
    from polyblur_torch.cli import calibrate as ccal
    from polyblur_torch.cli import main as cmain
    from polyblur_torch.utils.io import imread_float, imsave_uint8

    path = "tests/data/peacock_defocus.png"
    base = ["--impath", path, "--N", "3", "--alpha", "6", "--beta", "1",
            "--outdir", CLI_OUTDIR]
    img = imread_float(path)
    for label, extra, patches in (
            ("(o) cli.main demo", [], None),
            ("(o) cli.main patches 400 px overlap 0.6",
             ["--do_patch_decomposition", "true", "--patch_overlap", "0.6"],
             (400, 0.6))):
        t0 = time.perf_counter()
        out = cmain.main(base + extra)
        sec = time.perf_counter() - t0
        module = polyblur_torch.PolyblurDeblurring(
            patch_decomposition=patches is not None,
            patch_size=patches[0] if patches else 400,
            patch_overlap=patches[1] if patches else 0.25, batch_size=20,
            device=dev)
        api = module(img, n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0,
                     q=0.0, method="direct_separable")
        ref = os.path.join(CLI_OUTDIR, "api.png")
        imsave_uint8(ref, api)
        same = bool(np.array_equal(np.asarray(Image.open(out)),
                                   np.asarray(Image.open(ref))))
        print(f"{label}: {out} in {sec:.2f} s (warm-up + timed run); PNG "
              f"equal to imsave_uint8 of the API's output: {same}")
        require(same, f"{label}: the PNG differs from the API's output")

    t0 = time.perf_counter()
    rows = cbench.main(["--quick"])
    print(f"(o) bench_suite --quick: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    require(len(rows) == 10, f"(o) bench_suite --quick gave {len(rows)} "
                             f"rows")

    res = ccal.main(["--n_kernels", "4", "--n_synthetic", "2",
                     "--patch_size", "128"])
    require(set(res) == {"normal", "orthogonal"}
            and res["normal"]["c"] > 0, f"(o) calibrate gave {res}")
    print(f"(o) calibrate: normal c {res['normal']['c']!r} b "
          f"{res['normal']['b']!r}, orthogonal c {res['orthogonal']['c']!r} "
          f"b {res['orthogonal']['b']!r}")


def tool_phases(dev, card: str, launches: dict) -> None:
    """(m)-(o), with the 12 MP main path's launches and MP/s before and
    after, which must not change."""
    import torch

    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    before = main_path_launches(dev, img, card, "before (m)-(o)")
    require(before == {k: launches[k] for k in NAMES},
            f"main path launches {before} differ from the first run's")
    irregular_path(dev, img, card)
    verbose_paths(dev, img, card)
    torch.cuda.empty_cache()
    cli_phases(dev, card)
    after = main_path_launches(dev, img, card, "after (m)-(o)")
    require(after == before, f"main path launches {after} after (m)-(o), "
                             f"{before} before")


# ---------------------------------------------------------------- training
# (a)-(e): the differentiable layer's steps and each autograd Function alone.
# A Function's backward replays autograd of its plain version on the card,
# so the forward launches the kernels and the backward none.

# (a), (d): the four scalar gradients of one step with the kernels against
# the same step with every plain version, relative to the largest: the
# cotangent d loss / d out differs by the forwards' gap (bf16 57.8 dB,
# f32 ~92 dB apart); the backward itself is the same plain replay
TOL_REL_GRAD_BF16 = 2e-2
TOL_REL_GRAD_F32 = 1e-3
# (h): one bf16 image through the tiles route is one tile: where the
# plain step's bf16 state flips theta at a near-tie (margin 9.5e-5 in
# iteration 2), the two steps deblur the whole image along different
# directions from there; with the bf16 output's rounding (the forwards
# 52.9 dB apart, held to PSNR_BF16_DB; 20% of the residual against the
# input as target) the scalar gradients measured 5.2e-2 apart, and the
# same steps in f32, run after it as its witness, 2.7e-4 (on an H100
# 80GB HBM3 at 700 W; PERF.md). A batch of tiles averages a flip out
# (2e-2 holds)
TOL_REL_GRAD_BF16_TILES = 1e-1
# (a): from iteration 2 on the kernels step and the plain step estimate
# different bf16 states (57.8 dB apart); theta may differ between the two
# steps only where the two directions' interpolated maxima are this close
TOL_TIE_STEP = 1e-3
# tests/test_runtime.py:150-180's layer: every step improves
TOL_LOSS_MONOTONE = 1e-6
# (c): the JAX package's losses over the 6 steps of (c) on the CPU
# (``python3 tools/config5_losses.py``: jax.grad through its
# PolyblurLayer, Adam at lr 5e-3 on the 1024^2 blurred binary image), by
# (n_iter, method); the port's, kernels or plain, stay within this
# relative of each (the port on the CPU: 2.1e-6), a tenth of config 5's
# rise at step 5 (1.3e-3), which JAX's sequence has too
JAX_LOSSES_1024 = {
    (3, "direct_separable"): (7.42638707e-02, 7.37117305e-02, 7.31531829e-02,
                              7.27006346e-02, 7.27956146e-02, 7.27534890e-02),
    (2, "fft"): (7.85993114e-02, 7.83883780e-02, 7.81815425e-02,
                 7.80437961e-02, 7.80028999e-02, 7.79472366e-02),
}
TOL_LOSS_JAX = 1e-4
# the forward of (a) and of the batch route: the main path's launches
TRAIN_FORWARD = {"edge_pad_cast": 1, "tile_estimate": 12,
                 "kernel_spectrum": 3, "spectral_gemm": 12,
                 "blend_overlap_add": 1}


def l2_f32(out, y):
    """The f32 mean squared error (config 5b's loss)."""
    import torch

    return torch.mean((out.float() - y.float()) ** 2)


def binary_problem(n: int):
    """tests/test_runtime.py:150-180's problem at n x n, as (1, 1, n, n)
    f32 (blurry, sharp): a thresholded smooth random field (seed 0)
    blurred by an anisotropic Gaussian with wrap-around."""
    from scipy import ndimage

    from polyblur_torch.ops.gaussian import gaussian_filter_np

    rng = np.random.default_rng(0)
    base = ndimage.gaussian_filter(rng.uniform(size=(n, n)), 1.0)
    sharp = (base > base.mean()).astype(np.float32)
    k = gaussian_filter_np((1.7, 0.9), 0.6, k_size=np.array([25, 25]))
    blurry = np.clip(ndimage.convolve(sharp, k, mode="wrap"), 0,
                     1).astype(np.float32)
    return blurry[None, None], sharp[None, None]


def counted_step(layer, opt, x, y, loss_fn=l2_f32, plain=False):
    """One Adam step with the launch counters zeroed before the forward and
    read after it and after the backward (inside ``plain_versions()`` when
    ``plain``). Returns (loss, forward launches, backward launches, the
    parameters' gradients, the output)."""
    import contextlib

    import torch

    from polyblur_torch.ops import cuda as pcuda

    ctx = pcuda.plain_versions() if plain else contextlib.nullcontext()
    with ctx:
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        pcuda.reset_launches()
        out = layer(x)
        loss = loss_fn(out, y)
        torch.cuda.synchronize()
        fwd = dict(pcuda.launches)
        pcuda.reset_launches()
        loss.backward()
        torch.cuda.synchronize()
        bwd = dict(pcuda.launches)
        grads = torch.stack([p.grad.detach().clone()
                             for p in layer.parameters()])
        opt.step()
    return float(loss.detach()), fwd, bwd, grads, out.detach()


def step_time(step, x, y, name: str, card: str, training: dict):
    """Median host ms of 3 warm steps (a synchronize around each) and the
    peak memory allocated over them; printed and kept in ``training``."""
    import torch

    step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training {name}: step {ms:.2f} ms (median of 3 warm steps), "
          f"peak memory {gib:.2f} GiB on {card}")
    training[name] = dict(step_ms=ms, peak_gib=gib)
    return ms, gib


def grads_vs_plain(name: str, make_layer, x, y, tol: float, min_db: float,
                   route, expect_fwd, on_run=lambda plain: None):
    """One counted step with the kernels and one with the plain versions
    (``on_run(plain)`` called before each), each from a fresh layer: the
    route is taken, the forward launches ``expect_fwd``, the backward no
    forward kernel and one blend backward kernel per blend launch, the
    two forwards' outputs are at least ``min_db`` apart, and the four
    scalar gradients agree within ``tol`` relative to the largest."""
    import torch

    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    runs = {}
    for plain in (False, True):
        on_run(plain)
        layer = make_layer()
        opt = torch.optim.Adam(layer.parameters(), lr=1e-2)
        reset_dispatch_log()
        runs[plain] = counted_step(layer, opt, x, y, plain=plain) + (
            dispatch_log(), dict(pcuda.backward_launches))
    loss, fwd, bwd, g, out, log, bwd_k = runs[False]
    loss_p, fwd_p, bwd_p, g_p, out_p, _, bwd_kp = runs[True]
    blends = expect_fwd.get("blend_overlap_add", 0)
    db = psnr(out, out_p)
    print(f"training {name}: loss {loss:.6e} (plain {loss_p:.6e}), "
          f"forward launches {fwd}, backward launches {bwd}, backward "
          f"kernels {bwd_k}, routes {sorted(log)}, forward vs plain "
          f"{db:.2f} dB (min {min_db})")
    require(route in log, f"{name}: route {route} not taken")
    require(math.isfinite(loss) and bool(torch.isfinite(g).all()),
            f"{name}: loss or gradients not finite")
    require(fwd == expect_fwd, f"{name}: forward launches {fwd}, expected "
                               f"{expect_fwd}")
    require(not bwd, f"{name}: the backward launched {bwd}")
    require(bwd_k == ({"blend_overlap_add": blends} if blends else {}),
            f"{name}: backward kernels {bwd_k}")
    require(not fwd_p and not bwd_p and not bwd_kp,
            f"{name}: plain step launched")
    require(db >= min_db, f"{name}: forward {db:.2f} dB from plain")
    rel = float((g - g_p).abs().max() / g_p.abs().max())
    print(f"training {name}: d loss / d (c, b, alpha, beta) "
          f"{[f'{v:.6e}' for v in g.tolist()]}, plain "
          f"{[f'{v:.6e}' for v in g_p.tolist()]}, max rel err {rel:.3e} "
          f"(tol {tol})")
    require(rel <= tol, f"{name}: scalar gradients {rel:.3e} from plain")
    return log


def function_vs_plain(name: str, fn, plain, inputs,
                      backward_kernels=None) -> dict:
    """Gradients of a Function alone (its kernels forward, its plain
    replay backward or its backward kernel) against autograd of its plain
    version on the same inputs under the same seeded cotangent: bit-equal
    (every plain backward of the port is deterministic: its replicate
    pads, wrap pads and repeats are reductions). The forward must launch
    and the backward launch no forward kernel, and exactly
    ``backward_kernels`` backward ones (default none)."""
    import torch

    from polyblur_torch.ops import cuda as pcuda

    def grads(f, under_plain):
        xs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
        ctx = pcuda.plain_versions() if under_plain else None
        torch.cuda.synchronize()
        pcuda.reset_launches()
        if ctx:
            with ctx:
                out = f(*xs)
        else:
            out = f(*xs)
        torch.cuda.synchronize()
        fwd = dict(pcuda.launches)
        gen = torch.Generator(device=out.device).manual_seed(7)
        g = torch.randn(out.shape, generator=gen, device=out.device,
                        dtype=torch.float32).to(out.dtype)
        pcuda.reset_launches()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        gs = torch.autograd.grad(out, [x for x in xs if x.requires_grad], g)
        e.record()
        e.synchronize()
        return (gs, fwd, dict(pcuda.launches),
                dict(pcuda.backward_launches), s.elapsed_time(e))

    grads(plain, True)                      # warm: plans, workspaces
    g_f, fwd, bwd, bwd_k, ms = grads(fn, False)
    g_p, _, _, bwd_kp, ms_p = grads(plain, True)
    require(sum(fwd.values()) > 0, f"{name}: the forward launched nothing")
    require(not bwd, f"{name}: the backward launched {bwd}")
    require(bwd_k == (backward_kernels or {}) and not bwd_kp,
            f"{name}: backward kernels {bwd_k}, plain {bwd_kp}")
    equal = all(torch.equal(a, b) for a, b in zip(g_f, g_p))
    rel = max(float((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp(min=1e-30))
              for a, b in zip(g_f, g_p))
    kind = "bit-equal" if equal else f"not bit-equal, max rel err {rel:.3e}"
    print(f"function {name}: forward launches {fwd}; backward kernels "
          f"{bwd_k}; backward {ms:.2f} ms (plain autograd {ms_p:.2f} ms), "
          f"gradients {kind}")
    require(equal, f"{name}: gradients differ from plain autograd "
                   f"({rel:.3e})")
    return dict(backward_ms=ms, bit_equal=equal, max_rel_err=rel)


def theta_checked(tag: str, run, n_est: int = 3,
                  hold_later_flips: bool = True) -> None:
    """``run(on_run)`` runs a kernels step and a plain step through
    ``grads_vs_plain`` (``on_run(plain)`` before each). Every per-tile
    estimate of the kernels step's forward is held against the plain
    estimate of the same tiles (identical theta), and against the plain
    step's own: every flip only at a near-tie (``TOL_TIE_STEP``). Without
    ``hold_later_flips`` only a tile's first flip is held: after it the
    two steps deblur that tile along different directions, so its later
    iterations' margins are printed."""
    import torch

    from polyblur_torch import pipeline as ppipe
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, _directional_vals_plain)

    thetas = {False: [], True: []}
    estimate = ppipe.tile_estimate
    mode = [False]

    def recording(view, coeffs):
        est = estimate(view, coeffs)
        if not torch.is_grad_enabled() and not mode[0]:
            # the kernels step's forward: the plain estimate of the same
            # state beside the kernel's
            with pcuda.plain_versions():
                same = estimate(view, coeffs)
            thetas[False].append((est[:, 0].clone(), same[:, 0].clone(),
                                  view.tiles().clone()))
        elif not torch.is_grad_enabled():
            thetas[True].append(est[:, 0].clone())
        return est

    ppipe.tile_estimate = recording
    try:
        run(lambda p: mode.__setitem__(0, p))
    finally:
        ppipe.tile_estimate = estimate
    require(len(thetas[False]) == len(thetas[True]) == n_est,
            f"{tag}: not {n_est} estimates per step")
    flipped = {}
    for it, ((ik, ik_p, state), ip) in enumerate(zip(thetas[False],
                                                     thetas[True])):
        require(torch.equal(ik, ik_p), f"{tag}: iteration {it + 1}: the "
                f"kernel's theta index differs from the plain estimate's "
                f"on the same tiles")
        # the plain step's own states differ from iteration 2 on by the
        # bf16 forwards' gap: a tile may flip there only at a near-tie
        diff = torch.nonzero(ik != ip).flatten().tolist()
        vals = _directional_vals_plain(TileView.of_tiles(state))
        for t in diff:
            a, b = int(ik[t]), int(ip[t])
            margin = abs(float((vals[t, a] - vals[t, b]) / vals[t, b]))
            after = (f", after its iteration {flipped[t]} flip"
                     if t in flipped else "")
            print(f"training {tag}: iteration {it + 1} tile {t}: theta idx "
                  f"{a} (kernels step) vs {b} (plain step), relative tie "
                  f"margin {margin:.3e} on the kernels step's tiles{after}")
            require((t in flipped and not hold_later_flips)
                    or margin <= TOL_TIE_STEP,
                    f"{tag}: theta flips at margin {margin:.3e}")
            flipped.setdefault(t, it + 1)
        print(f"training {tag}: iteration {it + 1}: kernel and plain "
              f"estimates of the same tiles identical on {ik.numel()}; "
              f"against the plain step {len(diff)} near-tie flip(s)")


def free_launches(make_layer, x) -> dict:
    """The launches of a grad-free call of a fresh layer on ``x``."""
    import torch

    from polyblur_torch.ops import cuda as pcuda

    layer = make_layer()
    with torch.no_grad():
        torch.cuda.synchronize()
        pcuda.reset_launches()
        layer(x)
        torch.cuda.synchronize()
    return dict(pcuda.launches)


def flag_step(name: str, make_layer, x, y, tol: float, min_db: float,
              route, card: str, training: dict) -> None:
    """(f), (h): one Adam step of a flagged layer with the kernels against
    the same step with every plain version (``grads_vs_plain``, theta
    held by ``theta_checked`` up to each tile's first flip): the forward
    launches what the grad-free call launches, the backward (the scan
    route's plain replay) none; then the step time and peak memory."""
    import torch

    from polyblur_torch import make_train_step

    expect = free_launches(make_layer, x)
    print(f"training {name}: grad-free call launches {expect}")

    def run(on_run=lambda plain: None):
        return grads_vs_plain(name, make_layer, x, y, tol, min_db, route,
                              expect, on_run=on_run)

    theta_checked(name, run, hold_later_flips=False)
    layer = make_layer()
    step_time(make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                      lr=1e-2)),
              x, y, name, card, training)
    training[name]["forward_launches"] = expect
    del layer
    torch.cuda.empty_cache()


def flag_layer_steps(dev, card: str, training: dict) -> None:
    """(f): BASELINE config 2 (2b in f32) as a learnable layer at full
    size: the 1200 x 1600 photo through the patch engine (448 px tiles at
    overlap 1/7) with the taper, the dt prefilter and the halo mask; the
    canvas Function's backward replays the scan route on the 12 tiles."""
    import torch

    from polyblur_torch import PolyblurLayer

    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    for tag, wd, tol, min_db in (
            ("(f) config 2", torch.bfloat16, TOL_REL_GRAD_BF16, PSNR_BF16_DB),
            ("(f) config 2b", torch.float32, TOL_REL_GRAD_F32, PSNR_F32_DB)):
        def layer(wd=wd):
            return PolyblurLayer(
                n_iter=3, learnable=True, c=0.362, b=0.468, alpha=6.0,
                beta=1.0, patch_size=448, patch_overlap=1.0 / 7.0,
                method="direct_separable", device=dev, extra=dict(
                    edgetaping=True, prefiltering=True,
                    smoother="domain_transform", remove_halo=True,
                    work_dtype=wd, out_dtype=torch.float32))

        name = f"{tag} layer 1200 x 1600, {str(wd)[6:]} work"
        try:
            flag_step(name, layer, img2, img2, tol, min_db,
                      ("deblur_patches", "staged_tiles"), card, training)
        except torch.cuda.OutOfMemoryError as e:
            print(f"training {name}: does not fit in the card's memory "
                  f"({e}); not shrunk")
            raise


def scan_flag_steps(dev, card: str, training: dict) -> None:
    """(g): the scan route through both smoothers on the 2 MP photo:
    config 2c (``method='fft'``, taper + dt + halo) and every flag with
    the bilateral smoother (``polyblur_deblurring``'s route), each one
    step with and without ``remat``, scalar gradients against the plain
    step. Without ``remat`` the backward launches nothing; with it the
    recompute launches the forward's kernels again (the smoother's among
    them)."""
    import torch

    from polyblur_torch import PolyblurLayer, make_train_step
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    for tag, method, smoother, kernel in (
            ("(g) config 2c, fft, dt", "fft", "domain_transform",
             "iir_scan_rows"),
            ("(g) every flag, bilateral", "direct_separable", "bilateral",
             "bilateral")):
        runs = {}
        for remat, plain in ((False, False), (True, False), (False, True)):
            layer = PolyblurLayer(
                n_iter=3, learnable=True, method=method, remat=remat,
                device=dev, extra=dict(edgetaping=True, prefiltering=True,
                                       smoother=smoother, remove_halo=True))
            reset_dispatch_log()
            runs[remat, plain] = counted_step(
                layer, torch.optim.Adam(layer.parameters(), lr=1e-2), img2,
                img2, plain=plain) + (dispatch_log(),)
            if not plain:
                name = f"{tag}, remat={remat}"
                expect = free_launches(lambda: layer, img2)
                loss, fwd, bwd, g, _, log = runs[remat, plain]
                print(f"training {name}: loss {loss:.6e}, forward launches "
                      f"{fwd}, backward launches {bwd}, routes "
                      f"{sorted(log)}")
                require(("polyblur_core", f"scan/{method}") in log,
                        f"{name}: not the scan route: {log}")
                require(fwd == expect, f"{name}: forward {fwd}, grad-free "
                                       f"{expect}")
                require(fwd.get(kernel, 0) > 0, f"{name}: no {kernel}")
                require(bwd == (fwd if remat else {}),
                        f"{name}: backward launches {bwd}")
                require(math.isfinite(loss) and bool(torch.isfinite(g).all()),
                        f"{name}: not finite")
                step_time(make_train_step(layer, torch.optim.Adam(
                    layer.parameters(), lr=1e-2)), img2, img2, name, card,
                    training)
                training[name]["forward_launches"] = fwd
                training[name]["recompute_launches"] = bwd
            del layer
            torch.cuda.empty_cache()
        g_p = runs[False, True][3]
        for remat in (False, True):
            g = runs[remat, False][3]
            rel = float((g - g_p).abs().max() / g_p.abs().max())
            print(f"training {tag}, remat={remat}: d loss / d (c, b, alpha, "
                  f"beta) {[f'{v:.6e}' for v in g.tolist()]}, plain "
                  f"{[f'{v:.6e}' for v in g_p.tolist()]}, max rel err "
                  f"{rel:.3e} (tol {TOL_REL_GRAD_F32})")
            require(rel <= TOL_REL_GRAD_F32, f"{tag}: scalar gradients "
                                             f"{rel:.3e} from plain")
        print(f"training {tag}: peak memory without remat "
              f"{training[f'{tag}, remat=False']['peak_gib']:.2f} GiB, "
              f"with {training[f'{tag}, remat=True']['peak_gib']:.2f} GiB "
              f"on {card}")


def flag_route_steps(dev, img, card: str, training: dict) -> None:
    """(h): the tiles route with every flag (480 x 640 f32, bilateral;
    480 x 512 bf16, dt, at its cap) and the batch route (2 x 3 x 1024^2,
    bf16 work, through the patch engine at 448 px, overlap 1/7, with
    config 2's flags: the canvas Function, then the blend's)."""
    import torch

    from polyblur_torch import PolyblurLayer

    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    dt = dict(prefiltering=True, smoother="domain_transform",
              edgetaping=True, remove_halo=True)
    tiles = ("polyblur_core", "tiles")
    crop = img2[..., :480, :640].contiguous()
    flag_step("(h) tiles route 480 x 640 f32, every flag (bilateral)",
              lambda: PolyblurLayer(n_iter=3, learnable=True,
                                    method="direct_separable", device=dev,
                                    extra=FLAGS_KW),
              crop, crop, TOL_REL_GRAD_F32, PSNR_F32_DB, tiles, card,
              training)
    # the bf16 dt set, then the same crop in f32 as its witness: the
    # gradient's gap in bf16 is the near-tie flip's, not the Functions'
    crop = img2[..., :480, :512].contiguous()
    for wd, tol, min_db in ((torch.bfloat16, TOL_REL_GRAD_BF16_TILES,
                             PSNR_BF16_DB),
                            (torch.float32, TOL_REL_GRAD_F32, PSNR_F32_DB)):
        flag_step(f"(h) tiles route 480 x 512 {str(wd)[6:]}, every flag "
                  f"(dt)",
                  lambda: PolyblurLayer(n_iter=3, learnable=True,
                                        method="direct_separable",
                                        device=dev, extra=dt),
                  crop.to(wd), crop.to(wd).float(), tol, min_db, tiles, card,
                  training)
    xb = torch.cat([img[..., :1024, :1024], img[..., 1024:2048, 1024:2048]])
    flag_step("(h) batch route 2 x 3 x 1024^2 bf16, config 2's flags",
              lambda: PolyblurLayer(
                  n_iter=3, learnable=True, patch_size=448,
                  patch_overlap=1.0 / 7.0, method="direct_separable",
                  device=dev, extra=dict(dt, work_dtype=torch.bfloat16,
                                         out_dtype=torch.float32)),
              xb, xb, TOL_REL_GRAD_BF16, PSNR_BF16_DB,
              ("deblur_patches", "staged_tiles"), card, training)


def flag_functions(dev) -> dict:
    """(e), the flags' Functions alone: the bilateral Function and the two
    IIR Functions (rows, columns) on the whole 1200 x 1600 photo (f32) and
    on config 2's 12 tiles of 448^2 (bf16), and the flagged tiles (480 x
    640, every flag) and canvas (config 2) Functions, whose backward
    replays the scan route."""
    import torch

    from polyblur_torch.ops.bilateral import _bilateral_plain, bilateral_filter
    from polyblur_torch.ops.cuda.iir import (dt_coeffs_plain, scan_cols,
                                             scan_cols_plain, scan_rows,
                                             scan_rows_plain)
    from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
    from polyblur_torch.ops.cuda.polyblur_fused import (
        TileView, _ref_image_pipeline, polyblur_image_fused,
        polyblur_tiles_fused)
    from polyblur_torch.ops.domain_transform import (
        _domain_transform_derivatives)
    from polyblur_torch.patches import _grid_steps, plan_patch_grid
    from polyblur_torch.pipeline import _mega_pack, _ref_pipeline

    out = {}
    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    grid = plan_patch_grid(1200, 1600, 448, 1.0 / 7.0)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, 448, 448)
    canvas = edge_pad_cast(img2, grid.orig_size, grid.pad, torch.bfloat16)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
    tiles = view.tiles().contiguous()
    dh, dv = _domain_transform_derivatives(img2, 2.0, 0.8)
    a = math.exp(-math.sqrt(2.0) / 2.0)
    maps = {"1 x 3 x 1200 x 1600 f32": (img2, (a ** dh.double()).float(),
                                        (a ** dv.double()).float()),
            f"config 2's {view.n} x 3 x 448^2 bf16 tiles":
                (tiles,) + dt_coeffs_plain(view, coeffs)}
    for shape, (x, v_h, v_v) in maps.items():
        out[f"bilateral {shape}"] = function_vs_plain(
            f"bilateral_filter (B.1.7, {shape})", bilateral_filter,
            lambda t: _bilateral_plain(t, 5, 5.0, 0.1), (x,))
        out[f"iir rows {shape}"] = function_vs_plain(
            f"scan_rows (B.1.8, {shape})",
            lambda t, v: scan_rows(TileView.of_tiles(t), v),
            lambda t, v: scan_rows_plain(TileView.of_tiles(t), v),
            (x, v_h))
        rows = scan_rows(TileView.of_tiles(x), v_h)
        out[f"iir cols {shape}"] = function_vs_plain(
            f"scan_cols (B.1.8, {shape} rows' f32 output)", scan_cols,
            scan_cols_plain, (rows, v_v))
    crop = img2[..., :480, :640].contiguous()
    flags = dict(do_taper=True, do_halo=True, prefilter="bilateral")
    out["polyblur_tiles_fused, flags"] = function_vs_plain(
        "polyblur_tiles_fused (B.1.4, 7-8: 1 x 3 x 480 x 640 f32, every "
        "flag, bilateral; backward the scan route)",
        lambda t, co: polyblur_tiles_fused(t, co, 3, **flags),
        lambda t, co: _ref_pipeline(t, co, 3, **flags), (crop, coeffs))
    flags = dict(do_taper=True, do_halo=True, prefilter="dt")
    out["polyblur_image_fused, flags"] = function_vs_plain(
        "polyblur_image_fused (B.1.2-3, 7-8: config 2's canvas, bf16, "
        "taper + dt + halo; backward the scan route on the 12 tiles)",
        lambda cv, co: polyblur_image_fused(cv, co, 3, gi, **flags),
        lambda cv, co: _ref_image_pipeline(cv, co, 3, gi, flags),
        (canvas, coeffs))
    return out


def training_functions(dev, img) -> dict:
    """(e): each Function of ROADMAP B.1 items 1-6 alone, at its main-path
    shapes (the 12 MP bf16 canvas of 448/384 tiles; the 480 x 640 tiles
    route; config 5's 1024^2 blocks; config 5b's 48 gray 576^2 tiles)."""
    import torch

    from polyblur_torch.estimation import _mags_fast, _mags_xla
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.overlap_add import (
        blend_overlap_add, blend_overlap_add_plain)
    from polyblur_torch.ops.cuda.pad_cast import (edge_pad_cast,
                                                   edge_pad_cast_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        _restore_canvas, polyblur_image_fused, polyblur_tiles_fused)
    from polyblur_torch.ops.cuda.sep_poly_fused import (
        fused_polynomial, fused_polynomial_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        extract_patches, plan_patch_grid)
    from polyblur_torch.pipeline import _mega_pack, restore_tiles

    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    _, _, H, W = img.shape
    grid = plan_patch_grid(H, W, 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, 448, 448)
    crop4 = (grid.pad[0], grid.pad[2]) + grid.orig_size
    win, inv = _blend_constants(grid, "kaiser", dev)
    flags = dict(do_taper=False, do_halo=False, prefilter=None)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)

    out["edge_pad_cast"] = function_vs_plain(
        "edge_pad_cast (B.1.1, 1 x 3 x 3000 x 4000 f32 -> bf16 canvas)",
        lambda x: edge_pad_cast(x, grid.orig_size, grid.pad, bf16),
        lambda x: edge_pad_cast_plain(x, grid.orig_size, grid.pad, bf16),
        (img,))
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, bf16)

    def stages(cv, co):
        return _restore_canvas(cv, co, 3, gi, None, flags)

    out["polyblur_image_fused"] = function_vs_plain(
        "polyblur_image_fused (B.1.2-3, 88 tiles of 448^2 bf16)",
        lambda cv, co: polyblur_image_fused(cv, co, 3, gi), stages,
        (canvas, coeffs))
    with torch.no_grad():
        tiles = polyblur_image_fused(canvas, coeffs, 3, gi)
    out["blend_overlap_add"] = function_vs_plain(
        "blend_overlap_add (88 x 3 x 448^2 bf16 -> 12 MP f32)",
        lambda t: blend_overlap_add(t, win, inv, gi, 1, crop4, f32),
        lambda t: blend_overlap_add_plain(t, win, inv, gi, 1, crop4, f32),
        (tiles,), {"blend_overlap_add": 1})
    del canvas, tiles
    # the blend's backward kernel on upstream's 400 px / step 300 grid: the
    # training cell's 130 tiles and the flags cell's 2 MP grid
    for hw in ((3000, 4000), (1200, 1600)):
        g400 = plan_patch_grid(*hw, 400, 0.25)
        gi400 = _grid_steps(g400) + (400, 400)
        crop400 = (g400.pad[0], g400.pad[2]) + g400.orig_size
        win400, inv400 = _blend_constants(g400, "kaiser", dev)
        n400 = gi400[0] * gi400[1]
        t400 = (torch.rand((n400, 3, 400, 400), device=dev,
                           generator=torch.Generator(dev).manual_seed(26))
                * 1.5 - 0.25).to(bf16)
        out[f"blend_overlap_add_{hw[0]}x{hw[1]}"] = function_vs_plain(
            f"blend_overlap_add ({n400} x 3 x 400^2 bf16 -> {hw[0]} x "
            f"{hw[1]} f32)",
            lambda t: blend_overlap_add(t, win400, inv400, gi400, 1,
                                        crop400, f32),
            lambda t: blend_overlap_add_plain(t, win400, inv400, gi400, 1,
                                              crop400, f32),
            (t400,), {"blend_overlap_add": 1})
        del t400
    crop = img[..., :480, :640].contiguous()
    out["polyblur_tiles_fused"] = function_vs_plain(
        "polyblur_tiles_fused (B.1.4, 1 x 3 x 480 x 640 f32, 3 iterations)",
        lambda t, co: polyblur_tiles_fused(t, co, 3),
        lambda t, co: restore_tiles(t, co, 3), (crop, coeffs))
    blurry, _ = binary_problem(1024)
    x5 = torch.as_tensor(blurry[0], device=dev)                # (1, H, W)
    view, _ = sep_poly._block_view(x5, 12)
    a, b, c = sep_poly.gaussian_quadratic_coeffs(
        *(torch.tensor([v], device=dev) for v in (1.7, 0.9, 0.6)))
    params = torch.stack([a, b, c], -1).repeat(view.n, 1)

    def on(d):
        return view._replace(data=d)

    out["fused_polynomial"] = function_vs_plain(
        f"fused_polynomial (B.1.5, config 5's {view.n} blocks of "
        f"{view.patch[0]}x{view.patch[1]} f32)",
        lambda d, p, co: fused_polynomial(on(d), p, co),
        lambda d, p, co: fused_polynomial_plain(on(d), p, co),
        (view.data, params, coeffs[:4].clone()))
    grid5b = plan_patch_grid(H, W, 576, 64.0 / 576.0)
    with torch.no_grad():
        gray = extract_patches(img.to(bf16), grid5b).mean(1, keepdim=True)
    out["directional_maxima"] = function_vs_plain(
        f"_mags_fast -> directional_maxima (B.1.6, {gray.shape[0]} x 1 x "
        f"576^2 bf16, backward _mags_xla)",
        lambda g: _mags_fast(g, 6), lambda g: _mags_xla(g, 6), (gray,))
    return out


def training_phases(dev, card: str) -> dict:
    """(a)-(d) and (f)-(h): training steps through ``PolyblurLayer`` with
    the launch counters zeroed just before each forward and read after it
    and after its backward; (e) each Function alone. Returns the step
    times and peak memories by phase."""
    import torch

    from polyblur_torch import PolyblurLayer, make_train_step
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.utils.profiling import (dispatch_log,
                                                reset_dispatch_log)

    training = {}
    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    work = dict(work_dtype=torch.bfloat16, out_dtype=torch.float32)

    # (a) the main path as a layer: 448/384 tiles, bf16, kernels route
    def layer_a():
        return PolyblurLayer(n_iter=3, learnable=True, patch_size=448,
                             patch_overlap=64.0 / 448.0,
                             method="direct_separable", remat=False,
                             extra=work, device=dev)

    theta_checked("(a)", lambda on_run: grads_vs_plain(
        "(a) 12 MP bf16 patch layer", layer_a, img, img, TOL_REL_GRAD_BF16,
        PSNR_BF16_DB, ("deblur_patches", "staged_tiles"), TRAIN_FORWARD, on_run=on_run))
    layer = layer_a()
    step_time(make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                      lr=1e-2)),
              img, img, "(a) 12 MP bf16 patch layer, kernels", card,
              training)
    del layer
    torch.cuda.empty_cache()

    # (b) BASELINE config 5b (bench_suite.py:275-300): 12 MP bf16 in, 576/512
    # grid, remat: the composed route, checkpointed scan per tile batch
    x5b = img.to(torch.bfloat16)

    def layer_b():
        return PolyblurLayer(n_iter=3, learnable=True, remat=True,
                             method="direct_separable", patch_size=576,
                             patch_overlap=64.0 / 576.0, device=dev)

    layer = layer_b()
    reset_dispatch_log()
    loss, fwd, bwd, g, _ = counted_step(
        layer, torch.optim.Adam(layer.parameters(), lr=1e-2), x5b, img)
    log = dispatch_log()
    require(dict(pcuda.backward_launches) == {"blend_overlap_add": 1},
            f"(b): backward kernels {dict(pcuda.backward_launches)}")
    print(f"training (b) config 5b: loss {loss:.6e}, forward launches {fwd}, "
          f"backward launches {bwd}, routes {sorted(log)}, grads "
          f"{[f'{v:.6e}' for v in g.tolist()]}")
    for route in (("deblur_patches", "composed"),
                  ("polyblur_core", "scan/direct_separable"),
                  ("compute_polynomial_separable", "xla_sep"),
                  ("directional_maxima", "fused")):
        require(route in log, f"(b): route {route} not taken: {log}")
    require(fwd == {"edge_pad_cast": 1, "directional_maxima": 9,
                    "blend_overlap_add": 1}, f"(b): forward {fwd}")
    require(bwd == {"directional_maxima": 9},
            f"(b): backward {bwd} (the checkpointed recompute only)")
    require(math.isfinite(loss) and bool(torch.isfinite(g).all()),
            "(b): not finite")
    step_time(make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                      lr=1e-2), l2_f32),
              x5b, img, "(b) config 5b, 12 MP bf16, 576/512, remat", card,
              training)
    del layer, x5b
    torch.cuda.empty_cache()

    # (c) BASELINE config 5 (bench_suite.py:247-273: 1024^2 gray, 3
    # iterations, direct_separable, remat) and the layer of its CPU test
    # (tests/test_runtime.py:150-180: 2 iterations, 'fft', remat), both on
    # that test's blurred binary image: 6 Adam steps at lr 5e-3 each. The
    # test's layer must improve on every step, as the JAX package's test
    # requires; config 5's layer raises its loss at step 5 in both packages
    # (tools/config5_losses.py), so its sequences must end below their
    # start and agree with and without remat. Every sequence follows the
    # JAX package's step by step (JAX_LOSSES_1024).
    blurry, sharp = (torch.as_tensor(a, device=dev)
                     for a in binary_problem(1024))
    losses = {}
    for name, kw, routes, launched, monotone in (
            ("(c) tests/test_runtime.py's layer, 1024^2, 2 iterations, "
             "fft, remat", dict(n_iter=2, method="fft", remat=True),
             (("polyblur_core", "scan/fft"),), {}, True),
            ("(c) config 5, 1024^2 gray, remat",
             dict(n_iter=3, method="direct_separable", remat=True),
             (("compute_polynomial_separable", "xla_sep"),), {}, False),
            ("(c) config 5, 1024^2 gray, no remat",
             dict(n_iter=3, method="direct_separable", remat=False),
             (("compute_polynomial_separable", "blocked"),),
             {"fused_polynomial": 15}, False)):
        layer = PolyblurLayer(learnable=True, device=dev, **kw)
        opt = torch.optim.Adam(layer.parameters(), lr=5e-3)
        step = make_train_step(layer, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_dispatch_log()
        loss, fwd, bwd, _, _ = counted_step(layer, opt, blurry, sharp)
        log = dispatch_log()
        seq, times = [loss], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq.append(float(step(blurry, sharp)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = statistics.median(times[-3:]) * 1e3
        training[name] = dict(step_ms=ms, peak_gib=gib, losses=seq)
        losses[name] = seq
        print(f"training {name}: losses {[f'{v:.8e}' for v in seq]}, "
              f"forward launches {fwd}, backward launches {bwd}, routes "
              f"{sorted(log)}")
        print(f"training {name}: step {ms:.2f} ms (median of the last 3 of "
              f"6 steps), peak memory {gib:.2f} GiB on {card}")
        require(all(math.isfinite(v) for v in seq), f"{name}: not finite")
        require(seq[-1] < seq[0], f"{name}: no decrease over 6 steps: {seq}")
        ref = JAX_LOSSES_1024[(kw["n_iter"], kw["method"])]
        rel_jax = max(abs(u - v) / v for u, v in zip(seq, ref))
        print(f"training {name}: losses within {rel_jax:.3e} relative of "
              f"the JAX package's on the CPU (tol {TOL_LOSS_JAX})")
        require(rel_jax <= TOL_LOSS_JAX,
                f"{name}: losses {rel_jax:.3e} from the JAX package's")
        if monotone:
            require(all(b <= a + TOL_LOSS_MONOTONE
                        for a, b in zip(seq, seq[1:])),
                    f"{name}: the loss increased: {seq}")
        for route in routes:
            require(route in log, f"{name}: route {route} not taken: {log}")
        require(fwd == launched and not bwd,
                f"{name}: launches {fwd} forward, {bwd} backward")
        del layer, opt, step
    a, b = (losses[k] for k in list(losses)[1:])
    rel = max(abs(u - v) / u for u, v in zip(a, b))
    print(f"training (c): config 5 with and without remat (the blocked "
          f"kernels) agree within {rel:.3e} relative over 6 steps")
    require(rel <= 1e-3, f"(c): the two routes' losses differ by {rel:.3e}")
    del blurry, sharp
    torch.cuda.empty_cache()

    # (d) the whole-image tiles route (480 x 640, f32) and the batch route
    crop = img[..., :480, :640].contiguous()

    def layer_d():
        return PolyblurLayer(n_iter=3, learnable=True,
                             method="direct_separable", device=dev)

    grads_vs_plain("(d) tiles route 1 x 3 x 480 x 640 f32", layer_d, crop,
                   crop, TOL_REL_GRAD_F32, PSNR_F32_DB,
                   ("polyblur_core", "tiles"),
                   {"tile_estimate": 12, "kernel_spectrum": 3,
                    "spectral_gemm": 12})
    layer = layer_d()
    step_time(make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                      lr=1e-2)),
              crop, crop, "(d) tiles route 480 x 640 f32", card, training)
    xb = torch.cat([img[..., :1024, :1024], img[..., 1024:2048, 1024:2048]])

    def layer_batch():
        return PolyblurLayer(n_iter=3, learnable=True, patch_size=448,
                             patch_overlap=64.0 / 448.0,
                             method="direct_separable", extra=work,
                             device=dev)

    grads_vs_plain("(d) batch route 2 x 3 x 1024^2 bf16", layer_batch, xb,
                   xb, TOL_REL_GRAD_BF16, PSNR_BF16_DB,
                   ("deblur_patches", "staged_tiles"), TRAIN_FORWARD)
    layer = layer_batch()
    step_time(make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                      lr=1e-2)),
              xb, xb, "(d) batch route 2 x 3 x 1024^2 bf16", card, training)
    del layer, xb, crop
    torch.cuda.empty_cache()

    # (e) each Function alone
    training["functions"] = training_functions(dev, img)
    torch.cuda.empty_cache()

    # (f)-(h): training through the feature flags, and (e) for their
    # Functions
    flag_layer_steps(dev, card, training)
    scan_flag_steps(dev, card, training)
    flag_route_steps(dev, img, card, training)
    del img
    torch.cuda.empty_cache()
    training["functions"].update(flag_functions(dev))
    return training


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
        HALF, TileView, _gray_norm_plain, kernel_spectrum,
        kernel_spectrum_plain, spectral_poly, spectral_poly_plain,
        stage_tables, tile_estimate, tile_estimate_plain)
    from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                        plan_patch_grid)
    from polyblur_torch.pipeline import _mega_pack

    t_start = time.perf_counter()
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
    path_kw = dict(PATH_KW, method="direct_separable")
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
        vals, margins = tie_margins(view)
        print(f"tile_estimate[{tag}]: smallest relative tie margin "
              f"{float(margins.min()):.3e} (tile {int(margins.argmin())}) "
              f"over {n_tiles} tiles")
        if not bool(same.all()):
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
        estimate_stages(view, coeffs, f"tile_estimate[{tag}, {n_tiles} x "
                        f"{c} x {ph}^2, 12 MP]")
        if tag == "bf16":
            g = _gray_norm_plain(view)
            report["tile_estimate"] = dict(
                max_abs_err=float((est[:, 1:] - est_p[:, 1:]).abs().max()),
                ms=cuda_ms(lambda: tile_estimate(view, coeffs)),
                plain_ms=cuda_ms(lambda: tile_estimate_plain(view, coeffs),
                                 reps=3),
                library_ms=gemm_pair_library_ms(g),
                library_what=LIBRARY_GEMM_PAIR,
                bound=bound_ms(n_tiles * b * c * ph * pw * esz
                               + est.numel() * 4,
                               n_tiles * b * maxima_flops(c, ph, pw), "f32"))

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
            report["kernel_spectrum"] = spectrum_row(est, coeffs, tabs,
                                                     f"{tag}, n={n_tiles}")

        out = spectral_poly(view, q2, tabs)
        out_p = spectral_poly_plain(view, q2, tabs)
        err = float((out.float() - out_p.float()).abs().max())
        tol = TOL_SPEC_BF16 if tag == "bf16" else TOL_SPEC_F32
        require(err <= tol, f"spectral_gemm {tag} error {err}")
        print(f"spectral_gemm[{tag}]: max_abs_err {err:.3e} "
              f"(PSNR {psnr(out, out_p):.1f} dB)")
        spectral_modes(view, q2, tabs, f"spectral_gemm[{tag}, {n_tiles * b}"
                       f" x {c} planes, h {h}, kp {tabs.er.shape[1]}]")
        if tag == "bf16":
            nb = 2 * out.numel() * esz + q2.numel() * 4
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
                bound=bound_ms(nb, n_tiles * b * c * application_flops(h, wc),
                               tag))

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
            def blend():
                return blend_overlap_add(out, win, inv_wsum, gi, b, crop4,
                                         torch.float32)

            # the library's overlap-add: F.fold of the window-multiplied
            # tiles (columns in grid order), the product made beforehand
            cols = (out.float().reshape(th * tw, b, c, ph, pw) * win).permute(
                1, 2, 3, 4, 0).reshape(b, c * ph * pw, th * tw).contiguous()
            hc, wcv = inv_wsum.shape
            pt, pl, oh, ow = crop4

            def fold():
                return F.fold(cols, (hc, wcv), (ph, pw), stride=(sh, sw))

            ferr = float(((fold()[:, :, pt:pt + oh, pl:pl + ow]
                           * inv_wsum[pt:pt + oh, pl:pl + ow]).clamp(0, 1)
                          - o_p).abs().max())
            print(f"  F.fold yardstick (then the weight, crop and clip) vs "
                  f"plain: max_abs_err {ferr:.3e}")
            report["blend_overlap_add"] = dict(
                max_abs_err=err, ms=cuda_ms(blend), device_ms=device_ms(blend),
                plain_ms=cuda_ms(lambda: blend_overlap_add_plain(
                    out, win, inv_wsum, gi, b, crop4, torch.float32),
                    reps=3),
                library_ms=cuda_ms(fold),
                library_what="overlap-add only: torch.nn.functional.fold of "
                "the window-multiplied f32 tiles onto the canvas (not the "
                "window product, the weight, the crop, the clip)",
                bound=bound_ms(nb, 0.0, tag))
            del cols
        del canvas, ref, view, est, est_p, q2, q2_p, out, out_p, o, o_p, vals
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
    per_call = dict(tile_estimate=4, spectral_gemm=4)
    floor = sum(report[k]["bound"][0] * launches[k] / per_call.get(k, 1)
                for k in NAMES)
    print(f"main path bound: {floor:.4f} ms (the kernel rows' bounds times "
          f"their calls) = {H * W / 1e6 / (floor / 1e3):.0f} MP/s")

    with pcuda.plain_versions():
        plain16 = path(img, torch.bfloat16)
    p = psnr(out16, plain16)
    print(f"path bf16 hand vs plain: {p:.2f} dB")
    require(p >= PSNR_BF16_DB, f"bf16 path PSNR {p:.2f} < {PSNR_BF16_DB}")
    del plain16
    out32 = path(img, torch.float32)
    with pcuda.plain_versions():
        plain32 = path(img, torch.float32)
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
    with pcuda.plain_versions():
        pb = polyblur_torch.deblur_patches(
            xb, patch_size=448, overlap=64.0 / 448.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32, device=dev,
            **path_kw)
    p = psnr(ob, pb)
    print(f"batch 2 (2, 3, 1024, 1024), 4-tile chunks: hand vs plain "
          f"{p:.2f} dB, launches {dict(pcuda.launches)}")
    require(p >= PSNR_BF16_DB, f"batch-2 PSNR {p:.2f} < {PSNR_BF16_DB}")

    spectrum_planes(dev, coeffs, report)
    blend_geometries(dev)
    blend_backward_row(dev, report, launches)

    # ---------------------------------------------------------- whole image
    print(f"[{time.perf_counter() - t_start:.1f} s] whole-image phases")
    whole_image_kernels(dev, report)
    torch.cuda.empty_cache()
    whole_image_paths(dev, img, card, launches)

    # ---------------------------------------------------------- features
    print(f"[{time.perf_counter() - t_start:.1f} s] feature-flag phases")
    del img
    torch.cuda.empty_cache()
    img2 = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    feature_kernels(dev, img2, report)
    redesign_checks(dev, img2)
    torch.cuda.empty_cache()
    feature_paths(dev, img2, card, launches)

    # ---------------------------------------------------------- (i)-(k)
    print(f"[{time.perf_counter() - t_start:.1f} s] slice phases (i)-(l)")
    del img2
    torch.cuda.empty_cache()
    slice_phases(dev, card, launches, report)

    # ---------------------------------------------------------- (m)-(o)
    print(f"[{time.perf_counter() - t_start:.1f} s] slice phases (m)-(o)")
    torch.cuda.empty_cache()
    tool_phases(dev, card, launches)

    # ---------------------------------------------------------- (p), (q)
    print(f"[{time.perf_counter() - t_start:.1f} s] f32 dot modes (p)")
    torch.cuda.empty_cache()
    dot_mode_phases(dev, card, launches, report)
    print(f"[{time.perf_counter() - t_start:.1f} s] burst (q)")
    torch.cuda.empty_cache()
    burst_phases(dev, card)
    print(f"[{time.perf_counter() - t_start:.1f} s] parallel (r)")
    torch.cuda.empty_cache()
    parallel_phases(dev, card)

    # ---------------------------------------------------------- training
    print(f"[{time.perf_counter() - t_start:.1f} s] training phases")
    torch.cuda.empty_cache()
    training = training_phases(dev, card)
    print(f"[{time.perf_counter() - t_start:.1f} s] done")

    # ---------------------------------------------------------- report
    rows = []
    for name in (NAMES + SPECTRUM_ROWS + ("polyblur_tiles", "fused_polynomial",
                                          "directional_maxima") + FEATURES
                 + ("bilateral[n=88]",) + GENERALIZED + HIGHEST_ROWS
                 + ("blend_overlap_add_backward",)):
        r = report[name]
        src, replaces = SOURCES[name]
        bms, by = r["bound"]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r["library_ms"]})
        for extra in ("library_what", "tile_stage", "device_ms", "passes",
                      "weights_device_ms", "stage"):
            if extra in r:
                rows[-1][extra] = r[extra]
    print(json.dumps({"training": training}))
    print(card)
    print(json.dumps({"kernels": rows}))
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
