"""Host tables of the per-tile spectral polynomial and the blur estimate.

The operator (see ops/sep_poly.py) is the exact sampled-kernel polynomial,
diagonal in the 2D DFT of the replicate-padded tile:

    p(K) u = idft2( p(K_hat) * dft2(u_pad) )

evaluated as matrix products against the constant tables built here in
float64 NumPy: a packed x-rDFT (one product gives the [re | im]
half-spectrum), the y-DFT cos/sin pair, the packed inverse x-rDFT, and the
tap-phase tables from which the kernel spectrum K_hat is rebuilt from three
quadratic-form scalars per tile. The quirks are kept as they are: the DFT
tables reduce ``v*k mod wc`` before the trig, the tap tables do not.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["_dft_mats_np", "_ydft_mats_np", "_packed_k",
           "_dft_operands_packed", "_tap_tables_np", "_interp_weights_np",
           "N_ANGLES", "N_INTERP"]

N_ANGLES = 6     # directional maxima are taken at N_ANGLES + 1 angles
N_INTERP = 30    # interpolated angle grid (6-degree steps)


@functools.lru_cache(maxsize=8)
def _dft_mats_np(wc: int):
    """Real-DFT matrices along the x axis. rfft: ``Re = z @ Cf``,
    ``Im = -(z @ Sf)``; irfft: ``z = Re @ Ai + Im @ Bi``. The v*k products
    are reduced mod wc exactly before the trig."""
    K = wc // 2 + 1
    v = np.arange(wc)[:, None]
    k = np.arange(K)[None, :]
    ang = (2.0 * np.pi / wc) * np.mod(v * k, wc)
    cf = np.cos(ang).astype(np.float32)
    sf = np.sin(ang).astype(np.float32)
    ki = np.arange(K)[:, None]
    vi = np.arange(wc)[None, :]
    ang2 = (2.0 * np.pi / wc) * np.mod(ki * vi, wc)
    wk = np.where((ki == 0) | ((wc % 2 == 0) & (ki == wc // 2)),
                  1.0, 2.0) / wc
    ai = (wk * np.cos(ang2)).astype(np.float32)
    bi = (-wk * np.sin(ang2)).astype(np.float32)
    return cf, sf, ai, bi


@functools.lru_cache(maxsize=8)
def _ydft_mats_np(h: int):
    """Full-DFT cos/sin matrices along the y axis: ``C[q, y] =
    cos(2 pi q y / h)``, ``S[q, y] = sin(...)`` (symmetric, so forward and
    inverse share them; the inverse's 1/h is folded into the spectrum)."""
    q = np.arange(h)[:, None]
    y = np.arange(h)[None, :]
    ang = (2.0 * np.pi / h) * np.mod(q * y, h)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _packed_k(wc: int) -> int:
    """Padded half-spectrum width: K = wc//2+1 rounded up to 128."""
    return -(-(wc // 2 + 1) // 128) * 128


def _dft_operands_packed(wc: int):
    """Packed real-DFT blocks as float32 host arrays: forward
    F = [Cf | -Sf] (wc, 2 Kp), so one product yields the (re | im)
    half-spectrum, and inverse G = [Ai ; Bi] (2 Kp, wc). K is padded to
    Kp with zero columns/rows, so the two halves sit at offsets 0 and Kp
    and the mid-chain half-swap is a plain offset."""
    cf, sf, ai, bi = _dft_mats_np(wc)
    K = wc // 2 + 1
    kp = _packed_k(wc)
    fwd = np.zeros((wc, 2 * kp), np.float32)
    fwd[:, :K] = cf
    fwd[:, kp:kp + K] = -sf
    inv = np.zeros((2 * kp, wc), np.float32)
    inv[:K, :] = ai
    inv[kp:kp + K, :] = bi
    return fwd, inv


def _tap_tables_np(h: int, wc: int, half: int):
    """Tables of the analytic kernel-spectrum build.

    ``er/ei`` (128, Kp): row t (t < 2*half+1) is the x-phase
    cos/-sin(2 pi (t - half) k / wc) of tap offset t - half; rows beyond
    the support are zero. ``cyt/syt`` (h, 32): column j is the y-phase
    cos/sin(2 pi q (j - half) / h) of row offset j - half."""
    K = wc // 2 + 1
    kp = _packed_k(wc)
    taps = 2 * half + 1
    t = np.arange(taps)[:, None] - half
    k = np.arange(K)[None, :]
    er = np.zeros((128, kp), np.float32)
    ei = np.zeros((128, kp), np.float32)
    ang = (2.0 * np.pi / wc) * t * k
    er[:taps, :K] = np.cos(ang)
    ei[:taps, :K] = -np.sin(ang)
    q = np.arange(h)[:, None]
    j = np.arange(taps)[None, :] - half
    angy = (2.0 * np.pi / h) * q * j
    cyt = np.zeros((h, 32), np.float32)
    syt = np.zeros((h, 32), np.float32)
    cyt[:, :taps] = np.cos(angy)
    syt[:, :taps] = np.sin(angy)
    return er, ei, cyt, syt


@functools.lru_cache(maxsize=4)
def _interp_weights_np():
    """(30, 7) Keys-cubic interpolation weights of the reference's angle
    grids (blur_estimation.py:138-148 with the integer-truncated thetas of
    deblurring.py:62-63), incl. the 1e-5 weight-sum guard."""
    x = np.floor(np.linspace(0, 180, N_ANGLES + 1)) / N_INTERP
    xn = np.floor(np.arange(0, 180, 180 / N_INTERP)) / N_INTERP
    d = np.abs(xn[:, None] - x[None, :])
    w = np.where(d < 1, (1.5 * d - 2.5) * d * d + 1,
                 np.where(d < 2, ((-0.5 * d + 2.5) * d - 4) * d + 2, 0.0))
    w = w / (w.sum(axis=1, keepdims=True) + 1e-5)
    return w.astype(np.float32)
