"""The reference's spectral image derivative as a constant matrix.

The gradient operator of the reference (filters.py:159-186) is linear and
shift-invariant, so along each axis it is multiplication by a constant
circulant matrix:

    gx = img @ Dw.T      gy = Dh @ img

The matrix is built once per size in float64 NumPy by pushing the identity
through the reference discretization — including its fftshift/Nyquist
layout — so it is the exact same linear map (the calibrated (c, b) of the
affine blur model depend on this discretization).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["_derivative_matrix_np"]


@lru_cache(maxsize=32)
def _derivative_matrix_np(n: int) -> np.ndarray:
    """(n, n) float32 matrix of the reference's 1D spectral derivative.

    Columns are the derivative of the canonical basis vectors under
    ``Re IFFT(2 pi f * i * FFT(.))`` with the fftshifted frequency layout
    of filters.py:166-186 (f = (arange(n) - n//2)/n, applied to the
    shifted spectrum).
    """
    eye = np.eye(n, dtype=np.float64)
    U = np.fft.fftshift(np.fft.fft(eye, axis=0), axes=0)
    f = ((np.arange(n) - n // 2) / n)[:, None]
    G = np.fft.ifft(np.fft.ifftshift(2.0 * np.pi * f * (1j * U), axes=0),
                    axis=0)
    return np.real(G).astype(np.float32)
