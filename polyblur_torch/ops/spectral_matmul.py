"""The reference's spectral image derivative as a constant matrix.

The gradient operator of the reference (filters.py:159-186) is linear and
shift-invariant, so along each axis it is multiplication by a constant
circulant matrix:

    gx = img @ Dw.T      gy = Dh @ img

The matrix is built once per size in float64 NumPy by pushing the identity
through the reference discretization — including its fftshift/Nyquist
layout — so it is the exact same linear map (the calibrated (c, b) of the
affine blur model depend on this discretization).

The f32 dot mode (``ops.cuda.sep_poly_fused.set_f32_dot_mode``) does not
reach these products, nor the composed route's ``rfft2`` polynomial
(``ops.sep_poly._spectral2d``): they stay exact f32 (``torch.matmul`` with
TF32 off, :func:`require_full_f32`) under either mode. Their JAX
counterparts are the XLA products outside any Pallas kernel, which the
mode switches between Precision.HIGH and HIGHEST
(polyblur_tpu/ops/sep_poly.py:145-150); exact f32 is at least as close
as either.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["_derivative_matrix_np", "derivative_matrix",
           "fourier_gradients_matmul", "require_full_f32"]


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


@lru_cache(maxsize=16)
def _derivative_matrix_on(n: int, dtype: torch.dtype,
                          device: str) -> torch.Tensor:
    return torch.tensor(_derivative_matrix_np(n), device=device).to(dtype)


def derivative_matrix(n: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """The (n, n) derivative matrix as a tensor, cached per device: the
    whole-image estimate would otherwise copy it to the card on every
    iteration. Callers must not write to it."""
    return _derivative_matrix_on(n, dtype, str(torch.device(device or "cpu")))


def require_full_f32(t: torch.Tensor) -> None:
    """The plain f32 products are a reference: on the card they must not
    run in TF32."""
    if t.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the plain reference needs full f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False and "
                           "float32 matmul precision 'highest'")


def fourier_gradients_matmul(images: torch.Tensor):
    """Exact spectral gradients via two constant-matrix products (the same
    linear map as ``ops.fourier.fourier_gradients``), accumulated in f32.

    :param images: (..., H, W)
    :return: (grad_x, grad_y), same shape and dtype
    """
    require_full_f32(images)
    h, w = images.shape[-2:]
    x = images.float()
    gx = x @ derivative_matrix(w, device=x.device).T
    gy = derivative_matrix(h, device=x.device) @ x
    return gx.to(images.dtype), gy.to(images.dtype)
