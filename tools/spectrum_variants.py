#!/usr/bin/env python3
"""Design variants of the ``kernel_spectrum`` CUDA kernel, timed on one
NVIDIA GPU against the kernel as built.

Run from the repository root on a machine with a card and ``nvcc``:
``python3 tools/spectrum_variants.py``. Each variant is a copy of
``polyblur_torch/csrc/spectral.cu`` with one design choice changed by a
text substitution, compiled with the package's ``nvcc`` flags into
``build/spectrum_variants/`` and called through ctypes:

* ``as built``: the source unchanged;
* ``4 blocks/SM``: ``__launch_bounds__(256, 4)`` on the y-pass kernel
  (at most 64 registers);
* ``1 pass/block``: 64 rows per block at every plane count (more blocks,
  the taps formed once per 64 rows);
* ``warp 8x4``: a warp spans 8 column groups x 4 row groups of the 4 x 4
  register tiles, not 16 x 2;
* ``taps launch``: the two-launch form — a first launch forms each
  plane's tap products once and writes them, (n, 2, 25, kp) f32, and the
  y-pass blocks read them instead of forming them.

Each at the plane counts of the routes: 88 and 12 tiles of 448 px and one
480 x 640 image. Prints the device time of one call (CUDA events around 20
back-to-back calls of the C entry, median of 5) and the error against the
plain version, relative to max |q|. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import math
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_Y_KERNEL = ("// Block (x, y, z) = (64 columns, `rows` rows, plane).\n"
             "__global__ void __launch_bounds__(kSpecThreads)\n")
_PROLOGUE = ("  const float* qn = q + (long long)n * stride + off;\n"
             "  spectrum_taps(qn[0], qn[1], qn[2], er, ei, kp, k0, s);\n")
# the two-launch form: the y-pass reads the taps through its q pointer
_TAPS_IN = """  {
    const float* tn = q + (long long)n * 2 * kTaps * kp;
    for (int e = tid; e < kTaps * kSpecCols; e += kSpecThreads) {
      const int j = e / kSpecCols, c = e % kSpecCols;
      s.hr[j][c] = tn[(long long)j * kp + k0 + c];
      s.hi[j][c] = tn[(long long)(kTaps + j) * kp + k0 + c];
    }
  }
"""
_TAPS_KERNEL = """__global__ void __launch_bounds__(kSpecThreads)
spectrum_taps_kernel(const float* __restrict__ q, int stride, int off,
                     const float* __restrict__ er,
                     const float* __restrict__ ei, int kp,
                     float* __restrict__ taps) {
  __shared__ SpecTaps s;
  const int n = blockIdx.y;
  const int k0 = blockIdx.x * kSpecCols;
  const float* qn = q + (long long)n * stride + off;
  spectrum_taps(qn[0], qn[1], qn[2], er, ei, kp, k0, s);
  float* tn = taps + (long long)n * 2 * kTaps * kp;
  for (int e = threadIdx.x; e < kTaps * kSpecCols; e += kSpecThreads) {
    const int j = e / kSpecCols, c = e % kSpecCols;
    tn[(long long)j * kp + k0 + c] = s.hr[j][c];
    tn[(long long)(kTaps + j) * kp + k0 + c] = s.hi[j][c];
  }
}

"""
_TAPS_ENTRY = """
extern "C" int pb_kernel_spectrum_taps(const float* q, int stride, int off,
                                       const float* coeffs, const float* er,
                                       const float* ei, const float* cyt,
                                       const float* syt, int n, int h,
                                       int kp, float* taps, float* qhat2,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  spectrum_taps_kernel<<<dim3(kp / kSpecCols, n), kSpecThreads, 0, s>>>(
      q, stride, off, er, ei, kp, taps);
  const int rows = spectrum_rows(n, h, kp);
  dim3 grid(kp / kSpecCols, (h + rows - 1) / rows, n);
  kernel_spectrum_kernel<<<grid, kSpecThreads, 0, s>>>(
      taps, 0, 0, coeffs, er, ei, cyt, syt, h, kp, rows, qhat2);
  return static_cast<int>(cudaGetLastError());
}
"""
_Y_COMMENT = "// plane n's quadratic form is q[n * stride + off + 0..2]"
VARIANTS = {
    "as built": [],
    "4 blocks/SM": [(_Y_KERNEL, _Y_KERNEL.replace(
        "(kSpecThreads)", "(kSpecThreads, 4)"))],
    "1 pass/block": [(
        "  int chunks = (4 * 132 + col_blocks * n - 1) / (col_blocks * n);",
        "  int chunks = passes;")],
    "warp 8x4": [(
        "  const int cg = tid % 16, rg = tid / 16;",
        "  const int cg = tid % 8 + 8 * (tid / 32 % 2),\n"
        "            rg = tid % 32 / 8 + 4 * (tid / 64);")],
    "taps launch": [(_PROLOGUE, _TAPS_IN),
                    (_Y_COMMENT, _TAPS_KERNEL + _Y_COMMENT)],
}


def build(name: str, src: str, out_dir: str, csrc: str, flags) -> str:
    path = os.path.join(out_dir, name.replace(" ", "_").replace("/", "_"))
    with open(path + ".cu", "w") as f:
        f.write(src)
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", *flags, f"-I{csrc}",
                        "-o", path + ".so", path + ".cu"],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    return path + ".so"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spectrum_variants: no CUDA device", file=sys.stderr)
        return 2
    from polyblur_torch.ops.cuda import polyblur_fused as pf
    from polyblur_torch.ops.cuda._build import CSRC, NVCC_FLAGS
    from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs
    from polyblur_torch.pipeline import _mega_pack

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card {card}")
    with open(os.path.join(CSRC, "spectral.cu")) as f:
        base = f.read()
    out_dir = os.path.join(ROOT, "build", "spectrum_variants")
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}: the source changed; update the "
                                   f"substitution")
            src = src.replace(old, new)
        if name == "taps launch":
            src += _TAPS_ENTRY
        sources[name] = src
    with ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(
            lambda kv: build(kv[0], kv[1], out_dir, str(CSRC), NVCC_FLAGS),
            sources.items())))

    dev = torch.device("cuda")
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=dev)
    g = torch.Generator().manual_seed(7)
    cases = []
    for n, (ph, pw), wd in ((88, (448, 448), torch.bfloat16),
                            (12, (448, 448), torch.bfloat16),
                            (1, (480, 640), torch.float32)):
        sigma, rho = (0.3 + 3.7 * torch.rand(n, generator=g)
                      for _ in range(2))
        theta = torch.randint(0, 30, (n,), generator=g).float() * (
            math.pi / 30)
        est = torch.zeros((n, 8))
        est[:, 5:8] = torch.stack(gaussian_quadratic_coeffs(sigma, rho,
                                                            theta), 1)
        est = est.to(dev)
        tabs = pf.stage_tables(ph, pw, wd, str(dev))
        cases.append((n, est, tabs, pf.kernel_spectrum_plain(est, coeffs,
                                                             tabs)))
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, path in libs.items():
        taps_form = name == "taps launch"
        lib = ctypes.CDLL(path)
        fn = (lib.pb_kernel_spectrum_taps if taps_form
              else lib.pb_kernel_spectrum)
        fn.argtypes = ([P, I, I] + [P] * 5 + [I] * 3
                       + [P] * (3 if taps_form else 2))
        fn.restype = I
        for n, est, tabs, want in cases:
            h, kp = tabs.h, tabs.er.shape[1]
            out = torch.empty((n, h, 2 * kp), device=dev)
            taps = torch.empty((n, 2, 25, kp), device=dev)
            args = ([est.data_ptr(), 8, 5, coeffs.data_ptr(),
                     tabs.er.data_ptr(), tabs.ei.data_ptr(),
                     tabs.cyt.data_ptr(), tabs.syt.data_ptr(), n, h, kp]
                    + ([taps.data_ptr()] if taps_form else [])
                    + [out.data_ptr(), stream])
            out.zero_()
            if fn(*args) != 0:
                raise RuntimeError(f"{name}: launch refused")
            torch.cuda.synchronize()
            err = float((out - want).abs().max() / want.abs().max())
            for _ in range(3):
                fn(*args)
            times = []
            for _ in range(5):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                for _ in range(20):
                    fn(*args)
                e.record()
                e.synchronize()
                times.append(s.elapsed_time(e) / 20)
            print(f"{name:13s} n={n:2d} h={h} kp={kp}: "
                  f"{statistics.median(times):.4f} ms, rel err {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
