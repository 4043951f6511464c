"""Parametric anisotropic Gaussian kernels (port of
polyblur_tpu/ops/gaussian.py).

The blur model is a zero-mean 2D Gaussian with std ``sigma`` along
direction ``theta`` and std ``rho`` orthogonal to it: the estimator's
batched kernels (reference blur_estimation.py:189-232) and the NumPy
synthesis kernel with its dirac fallback (filters.py:198-245).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["inverse_covariance", "batch_gaussian_kernels",
           "gaussian_filter_np", "dirac"]


def inverse_covariance(sigmas, rhos, thetas):
    """(inv00, inv01, inv11) of the 2x2 inverse covariance of (sigma, rho,
    theta) batches (the reference negates theta)."""
    thetas = -thetas
    c = torch.cos(thetas)
    s = torch.sin(thetas)
    cc, ss, sc = c * c, s * s, s * c
    inv_l1 = 1.0 / (sigmas * sigmas)
    inv_l2 = 1.0 / (rhos * rhos)
    return cc * inv_l1 + ss * inv_l2, sc * (inv_l1 - inv_l2), \
        cc * inv_l2 + ss * inv_l1


def batch_gaussian_kernels(thetas, sigmas, rhos, ksize: int) -> torch.Tensor:
    """Normalized (B, 1, ksize, ksize) kernels ``exp(-0.5 x^T S^-1 x)`` on a
    centred integer grid; ``thetas, sigmas, rhos`` are (B, 1)."""
    inv00, inv01, inv11 = inverse_covariance(sigmas, rhos, thetas)
    b = sigmas.shape[0]
    t = (torch.arange(ksize, device=sigmas.device)
         - (ksize - 1) // 2).to(sigmas.dtype)
    X = t[None, None, None, :]   # x varies along columns
    Y = t[None, None, :, None]
    q = (inv00.reshape(b, 1, 1, 1) * X * X
         + 2.0 * inv01.reshape(b, 1, 1, 1) * X * Y
         + inv11.reshape(b, 1, 1, 1) * Y * Y)
    # float64 exp, as in ``sep_poly.gaussian_taps``
    kernels = torch.exp(-0.5 * q.double()).to(q.dtype)
    return kernels / kernels.sum(dim=(-2, -1), keepdim=True)


def gaussian_filter_np(sigma, theta, shift=(0.0, 0.0),
                       k_size=(15, 15)) -> np.ndarray:
    """NumPy anisotropic Gaussian kernel for synthesis and calibration, with
    the fallback to a centred dirac when the mass drops below 1e-2.

    :param sigma: pair (std along theta, std orthogonal)
    :param theta: rotation angle in radians
    """
    shift = np.asarray(shift, dtype=np.float64)
    k_size = np.asarray(k_size, dtype=np.int64)
    lambda_1, lambda_2 = float(sigma[0]), float(sigma[1])
    theta = -float(theta)
    LAMBDA = np.diag([lambda_1 ** 2, lambda_2 ** 2])
    Q = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    INV_SIGMA = np.linalg.inv(Q @ LAMBDA @ Q.T)
    MU = (k_size // 2 - shift).astype(np.float64)
    X, Y = np.meshgrid(range(int(k_size[0])), range(int(k_size[1])))
    Z = np.stack([X, Y], axis=-1).astype(np.float64) - MU
    q = (INV_SIGMA[0, 0] * Z[..., 0] ** 2
         + 2.0 * INV_SIGMA[0, 1] * Z[..., 0] * Z[..., 1]
         + INV_SIGMA[1, 1] * Z[..., 1] ** 2)
    raw = np.exp(-0.5 * q).astype(np.float32)
    if raw.sum() < 1e-2:
        kernel = np.zeros_like(raw)
        kernel[int(k_size[0]) // 2, int(k_size[1]) // 2] = 1.0
        return kernel
    return raw / raw.sum()


def dirac(dims) -> np.ndarray:
    """Centred dirac kernel (filters.py:237-245)."""
    kernel = np.zeros(tuple(dims), dtype=np.float32)
    kernel[dims[0] // 2, dims[1] // 2] = 1.0
    return kernel
