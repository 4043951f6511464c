#!/usr/bin/env python3
"""Emulate the f32 dot modes of ``spectral_gemm`` on the CPU.

    python3 tools/dot_mode_emulation.py [tile] [schemes]

One application of the spectral polynomial (the four DFT GEMMs of
``spectral_poly_plain``, f32 work dtype) on a ``tile`` px crop of the
peacock (default 448: the 12 MP path's 472 px canvas), each GEMM formed by
one of these schemes, printed against exact (float64) products and
against plain f32 ``torch.matmul`` in dB and largest error:

- ``3x_trunc``: 3xTF32 (tf32 pieces hi, lo; products hi lo, lo hi, hi hi
  per 8-deep step, the order of the ``'compensated'`` case) with the
  tensor cores' f32 accumulation modelled as round toward zero after
  each 8-deep MMA over the whole of K;
- ``6_trunc``: the three-piece split's six products in that accumulator;
- ``6_order``: the ``'highest'`` case as built: per 32-deep K stage a
  fresh truncating accumulator, the five small products of its four
  8-deep steps first (``SMALL_FIRST``, or the ``small`` order given to
  :func:`_mm`), then the four hi hi, and the stage added to the running
  sum with a rounded f32 add.

The truncation model is an assumption (the hardware's adder is not
documented); it reproduced the order of the card's 3xTF32 error. An
8-deep MMA is modelled as its products summed in float64 in K order,
added to the accumulator and rounded toward zero, one output element at a
time, so a product of the transposed operands gives the transposed bits
(tests/test_torch_est_highest.py relies on that). At 448 px it runs for a
few minutes. Imports no JAX.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from polyblur_torch.ops.cuda.polyblur_fused import (  # noqa: E402
    _tf32, spectrum_plain, stage_tables)
from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs  # noqa: E402
from polyblur_torch.utils.imaging import replicate_pad  # noqa: E402

# the five small products of an 8-deep step as (A piece, B piece), 0 hi,
# 1 mid, 2 lo: lo hi, hi lo, mid mid, mid hi, hi mid
SMALL_FIRST = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1)]


def _rz(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _pieces(a: np.ndarray, n: int):
    out, r = [], a.astype(np.float32)
    for _ in range(n):
        p = _tf32(r)
        out.append(p.astype(np.float64))
        r = (r - p).astype(np.float32)
    return out


def _mm(a: np.ndarray, b: np.ndarray, scheme: str,
        small=SMALL_FIRST) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if scheme == "exact":
        return a.astype(np.float64) @ b.astype(np.float64)
    if scheme == "f32":
        return (torch.from_numpy(a) @ torch.from_numpy(b)).double().numpy()
    k = a.shape[1]
    if scheme == "3x_trunc":
        ap, bp = _pieces(a, 2), _pieces(b, 2)
        terms = [(0, 1), (1, 0), (0, 0)]
    else:
        ap, bp = _pieces(a, 3), _pieces(b, 3)
        terms = list(small) + [(0, 0)]

    def step(acc, k0, i, j):
        s = 0.0
        for kk in range(k0, min(k, k0 + 8)):
            s = s + ap[i][:, kk:kk + 1] * bp[j][kk:kk + 1]
        return _rz(acc.astype(np.float64) + s)

    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if scheme in ("3x_trunc", "6_trunc"):
        for k0 in range(0, k, 8):
            for i, j in terms:
                acc = step(acc, k0, i, j)
        return acc.astype(np.float64)
    run = acc
    for s0 in range(0, k, 32):
        acc = np.zeros_like(run)
        ks = range(s0, min(k, s0 + 32), 8)
        for k0 in ks:
            for i, j in small:
                acc = step(acc, k0, i, j)
        for k0 in ks:
            acc = step(acc, k0, 0, 0)
        run = (run + acc).astype(np.float32)
    return run.astype(np.float64)


def application(xc, q2, t, ph, pw, scheme):
    """crop(p(K) xc) through the four GEMMs of ``spectral_poly_plain``,
    each product's output rounded to f32."""
    h, wc = t.h, t.wc
    kp = q2.shape[-1] // 2
    r = _mm(xc, t.fwd_t[:, :wc].numpy().T, scheme).astype(np.float32)
    rst = np.concatenate([r[:, :kp], r[:, kp:]], 0)
    y = _mm(t.ydft[:, :2 * h].numpy(), rst, scheme).astype(np.float32)
    pst = (y * np.concatenate([q2[:, :kp]] * 2, 0)).astype(np.float32)
    z = _mm(t.ydft_inv[:, :2 * h].numpy(), pst, scheme).astype(np.float32)
    zz = np.concatenate([z[:h], z[h:]], -1)
    q = t.pad
    return _mm(zz[q:q + ph], t.inv_t.numpy()[q:q + pw].T, scheme)


def db(a, b) -> str:
    mse = float(np.mean((a - b) ** 2))
    return (f"{10 * math.log10(1.0 / max(mse, 1e-30)):.2f} dB, max "
            f"{float(np.abs(a - b).max()):.3e}")


def main() -> int:
    from PIL import Image

    tile = int(sys.argv[1]) if len(sys.argv) > 1 else 448
    schemes = (sys.argv[2] if len(sys.argv) > 2
               else "3x_trunc,6_trunc,6_order").split(",")
    torch.set_num_threads(4)
    img = np.asarray(Image.open("tests/data/peacock_defocus.png"))
    x = torch.tensor(img[:tile, :tile, 0].astype(np.float32) / 255.0)
    t = stage_tables(tile, tile, torch.float32, "cpu")
    qa, qb, qc = gaussian_quadratic_coeffs(torch.tensor([1.3]),
                                           torch.tensor([0.7]),
                                           torch.tensor([0.4]))
    q2 = spectrum_plain(qa, qb, qc, torch.tensor([0.02, -0.3, 1.5, 0.5]),
                        t)[0].numpy()
    xc = replicate_pad(x[None], (t.pad,) * 4)[0].numpy()
    exact = application(xc, q2, t, tile, tile, "exact")
    plain = application(xc, q2, t, tile, tile, "f32")
    print(f"{tile} px: plain f32 vs exact {db(plain, exact)}")
    for scheme in schemes:
        out = application(xc, q2, t, tile, tile, scheme)
        print(f"{scheme}: vs exact {db(out, exact)}; vs plain f32 "
              f"{db(out, plain)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
