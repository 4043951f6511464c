"""Pure-NumPy oracle: independent re-derivation of every pipeline stage.

A copy of the JAX package's ``oracle/numpy_ref.py`` (importing anything
under ``polyblur_tpu`` imports JAX), with the same functions and results.
Serves three roles (SURVEY.md §4, §7 step 0):
  1. test oracle — tiny deterministic inputs, compared stage-by-stage
     against the implementations;
  2. the NumPy gradient/kernel path the reference's calibration script
     needs but lacks (calibrate_blur_parameters.py:9 imports a top-level
     ``filters`` module that does not exist — SURVEY.md §2.4 item 7);
  3. readable documentation of the math, free of framework idiom.

Everything here is float64 NumPy; no JAX, no torch.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "fourier_gradients",
    "gaussian_filter",
    "directional_gradient_magnitudes",
    "keys_cubic_interp",
    "estimate_gaussian_parameters",
    "polynomial_coefficients",
    "compute_polynomial_fft",
    "p2o",
    "normalized_convolution",
]


def fourier_gradients(image: np.ndarray):
    """Spectral image gradients, same discretization as the torch reference
    (the reference's polyblur/filters.py:159-186): multiply the fftshifted
    spectrum by ``2*pi*f * i`` per axis.

    :param image: (H, W) array
    :return: (grad_x, grad_y) — x is the column (width) direction
    """
    h, w = image.shape[-2:]
    U = np.fft.fftshift(np.fft.fft2(image), axes=(-2, -1))
    freqh = ((np.arange(h) - h // 2) / h)[:, None]
    freqw = ((np.arange(w) - w // 2) / w)[None, :]
    iU = 1j * U
    gx = np.real(np.fft.ifft2(np.fft.ifftshift(2 * np.pi * freqw * iU,
                                               axes=(-2, -1))))
    gy = np.real(np.fft.ifft2(np.fft.ifftshift(2 * np.pi * freqh * iU,
                                               axes=(-2, -1))))
    return gx, gy


def gaussian_filter(sigma, theta, shift=np.array([0.0, 0.0]),
                    k_size=np.array([15, 15])) -> np.ndarray:
    """Anisotropic Gaussian kernel (std ``sigma[0]`` along direction
    ``theta``, ``sigma[1]`` orthogonal), matching filters.py:198-234 with
    the degenerate-mass dirac fallback."""
    lambda_1, lambda_2 = float(sigma[0]), float(sigma[1])
    theta = -float(theta)
    LAMBDA = np.diag([lambda_1 ** 2, lambda_2 ** 2])
    Q = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    INV_SIGMA = np.linalg.inv(Q @ LAMBDA @ Q.T)
    MU = (np.asarray(k_size) // 2 - np.asarray(shift)).astype(np.float64)
    X, Y = np.meshgrid(range(int(k_size[0])), range(int(k_size[1])))
    Z = np.stack([X, Y], axis=-1).astype(np.float64) - MU
    q = (INV_SIGMA[0, 0] * Z[..., 0] ** 2
         + 2 * INV_SIGMA[0, 1] * Z[..., 0] * Z[..., 1]
         + INV_SIGMA[1, 1] * Z[..., 1] ** 2)
    raw = np.exp(-0.5 * q)
    if raw.sum() < 1e-2:
        out = np.zeros_like(raw)
        out[int(k_size[0]) // 2, int(k_size[1]) // 2] = 1.0
        return out
    return raw / raw.sum()


def directional_gradient_magnitudes(gx, gy, n_angles: int = 6) -> np.ndarray:
    """``max_xy |cos(t) gx - sin(t) gy|`` over angles linspace(0, pi, n+1)."""
    angles = np.linspace(0.0, np.pi, n_angles + 1)
    return np.array([
        np.abs(np.cos(t) * gx - np.sin(t) * gy).max() for t in angles])


def keys_cubic_interp(x_new, x, y):
    """Keys cubic-convolution interpolation with the reference's 1e-5
    weight-sum guard (blur_estimation.py:138-148)."""
    d = np.abs(np.asarray(x_new)[:, None] - np.asarray(x)[None, :])
    w = np.where(d < 1, (1.5 * d - 2.5) * d * d + 1,
                 np.where(d < 2, ((-0.5 * d + 2.5) * d - 4) * d + 2, 0.0))
    w = w / (w.sum(axis=-1, keepdims=True) + 1e-5)
    return np.einsum("nk,...k->...n", w, np.asarray(y))


def estimate_gaussian_parameters(image: np.ndarray, c: float = 0.362,
                                 b: float = 0.468, n_angles: int = 6,
                                 n_interpolated_angles: int = 30):
    """Whole estimation chain on one grayscale (H, W) image in [0, 1].

    :return: (sigma, rho, theta_radians)
    """
    lo, hi = image.min(), image.max()
    img = np.clip((image - lo) / (hi - lo), 0.0, 1.0)
    gx, gy = fourier_gradients(img)
    mags = directional_gradient_magnitudes(gx, gy, n_angles)
    thetas = np.floor(np.linspace(0, 180, n_angles + 1))
    ith = np.floor(np.arange(0, 180, 180 / n_interpolated_angles))
    interp = keys_cubic_interp(ith / n_interpolated_angles,
                               thetas / n_interpolated_angles, mags)
    i_min = int(np.argmin(interp))
    theta = ith[i_min]
    f_n = interp[i_min]
    i_ortho = int((theta + 90) % 180 / (180 / n_interpolated_angles))
    f_o = interp[i_ortho]
    sigma = np.sqrt(np.clip(c * c / (f_n * f_n + 1e-8) - b * b, 0.09, 16.0))
    rho = np.sqrt(np.clip(c * c / (f_o * f_o + 1e-8) - b * b, 0.09, 16.0))
    return sigma, rho, theta * np.pi / 180.0


def polynomial_coefficients(alpha, beta):
    return (alpha / 2 - beta + 2, 3 * beta - alpha - 6, 5 - 3 * beta + alpha / 2)


def p2o(psf: np.ndarray, shape) -> np.ndarray:
    """PSF -> OTF: zero-embed, roll center to origin, FFT (filters.py:255)."""
    h, w = psf.shape[-2:]
    otf = np.zeros(psf.shape[:-2] + tuple(shape), np.float64)
    otf[..., :h, :w] = psf
    otf = np.roll(otf, (-(h // 2), -(w // 2)), axis=(-2, -1))
    return np.fft.fft2(otf)


def compute_polynomial_fft(image: np.ndarray, kernel: np.ndarray,
                           alpha: float, beta: float) -> np.ndarray:
    """Degree-3 polynomial deconvolution, circular model, on one (H, W)
    image with one (h, w) kernel (deblurring.py:141-169, Horner form)."""
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    Y = np.fft.fft2(image)
    K = p2o(kernel, image.shape)
    X = a3 * Y
    X = K * X + a2 * Y
    X = K * X + a1 * Y
    X = K * X + beta * Y
    return np.real(np.fft.ifft2(X))


def _nc_box_filter_rows(F: np.ndarray, ct: np.ndarray,
                        box_radius: float) -> np.ndarray:
    """Normalized box filter along rows in the transformed domain, float64.

    Independent re-derivation of NC.cpp:50-140 (channel-generic; the C++
    hardcodes 3 channels at :131-133). The transformed coordinate ``ct`` is
    strictly increasing along rows (dHdx >= 1), so the C++'s incremental
    ``find(... > bound)`` scan is exactly a right-sided searchsorted; the
    box sum is a summed-area-table difference normalized by the (count +
    1e-4) guard of NC.cpp:137.
    """
    b, c, h, w = F.shape
    out = np.empty_like(F)
    for bi in range(b):
        for y in range(h):
            row = ct[bi, y]
            l_idx = np.searchsorted(row, row - box_radius, side="right")
            u_idx = np.searchsorted(row, row + box_radius, side="right")
            sat = np.zeros((c, w + 1), np.float64)
            sat[:, 1:] = np.cumsum(F[bi, :, y, :], axis=-1)
            out[bi, :, y, :] = (sat[:, u_idx] - sat[:, l_idx]) \
                / (u_idx - l_idx + 1e-4)
    return out


def normalized_convolution(img: np.ndarray, sigma_s: float = 60.0,
                           sigma_r: float = 0.4,
                           num_iterations: int = 3) -> np.ndarray:
    """Edge-aware smoothing, normalized-convolution variant, float64.

    Independent oracle for NC.cpp:143-204: l1 joint-image derivatives,
    dHdx = 1 + (sigma_s / sigma_r) |dI|, cumulated transforms, and the
    per-iteration sigma_H_i schedule (Gastal eq. 14, NC.cpp:191) with
    box_radius = sqrt(3) sigma_H_i; horizontal then transposed-vertical
    box passes per iteration.

    :param img: (B, C, H, W)
    """
    img = np.asarray(img, np.float64)
    b, c, h, w = img.shape
    dIdx = np.zeros((b, h, w), np.float64)
    dIdy = np.zeros((b, h, w), np.float64)
    dIdx[:, :, 1:] = np.sum(np.abs(np.diff(img, axis=3)), axis=1)
    dIdy[:, 1:, :] = np.sum(np.abs(np.diff(img, axis=2)), axis=1)
    dHdx = 1.0 + (sigma_s / sigma_r) * dIdx
    dVdy = 1.0 + (sigma_s / sigma_r) * dIdy
    ct_H = np.cumsum(dHdx, axis=2)
    ct_V = np.transpose(np.cumsum(dVdy, axis=1), (0, 2, 1))

    F = img.copy()
    N = num_iterations
    for i in range(num_iterations):
        sigma_H_i = sigma_s * math.sqrt(3.0) * 2.0 ** (N - (i + 1)) \
            / math.sqrt(4.0 ** N - 1.0)
        box_radius = math.sqrt(3.0) * sigma_H_i
        F = _nc_box_filter_rows(F, ct_H, box_radius)
        F = np.transpose(F, (0, 1, 3, 2))
        F = _nc_box_filter_rows(F, ct_V, box_radius)
        F = np.transpose(F, (0, 1, 3, 2))
    return F
