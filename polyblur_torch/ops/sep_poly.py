"""Spectral polynomial deconvolution with parametric kernels (plain torch).

The estimator's sampled anisotropic Gaussian kernel

    k[t, j] = exp(-0.5 (a t^2 + 2 b t j + c j^2)) / N,   t, j in [-half, half]

is centrally symmetric, so its OTF on the padded canvas (``p2o`` of the
kernel, reference filters.py:255) is real and analytic in the quadratic
form (a, b, c), and the whole degree-3 polynomial is diagonal in the 2D DFT
of the replicate-padded tile:

    p(K) u = idft2( p(K_hat) * dft2(u_padded) ),
    p(z)   = ((a3 z + a2) z + a1) z + beta.

This is exactly the reference's fft method (deblurring.py:141-169). The OTF
is rebuilt from the tap-phase tables of ops/tables.py; the plain version of
the per-tile ``kernel_spectrum`` kernel (ops/cuda/polyblur_fused.py) is built
from the steps here.
"""

from __future__ import annotations

import torch

from .tables import _tap_tables_np

__all__ = ["gaussian_quadratic_coeffs", "quadratic_form", "gaussian_taps",
           "otf_from_taps", "kernel_spectrum"]


def quadratic_form(sigma2, rho2, theta):
    """(a, b, c) of the kernel's quadratic form from the variances along
    and across the blur direction ``theta`` (radians)."""
    t = -theta
    ct = torch.cos(t)
    st = torch.sin(t)
    inv_l1 = 1.0 / sigma2
    inv_l2 = 1.0 / rho2
    a = ct * ct * inv_l1 + st * st * inv_l2
    b = st * ct * (inv_l1 - inv_l2)
    c = ct * ct * inv_l2 + st * st * inv_l1
    return a, b, c


def gaussian_quadratic_coeffs(sigma, rho, theta):
    """(a, b, c) of the kernel's quadratic form, from (sigma, rho, theta).

    Matches the inverse covariance of blur_estimation.py:189-208 (the
    reference negates theta): a multiplies x^2 (columns), c multiplies y^2
    (rows), b the cross term.
    """
    return quadratic_form(sigma * sigma, rho * rho, theta)


def gaussian_taps(a, b, c, half: int = 12) -> torch.Tensor:
    """(N, 2 half + 1, 2 half + 1) sampled kernels, normalized to sum 1;
    rows are y offsets j, columns x offsets t."""
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=a.device)
    af = a.float()[:, None, None]
    bf = b.float()[:, None, None]
    cf = c.float()[:, None, None]
    tx = t[None, None, :]
    ty = t[None, :, None]
    km = torch.exp(-0.5 * (af * tx * tx + 2.0 * bf * tx * ty + cf * ty * ty))
    return km * (1.0 / km.sum(dim=(-2, -1), keepdim=True))


def otf_from_taps(km, er, ei, cyt, syt) -> torch.Tensor:
    """(N, h, kp) real OTF of the taps ``km`` from the tap-phase tables of
    ``_tap_tables_np``: per row offset j the tap row's x-spectrum, then the
    y-offset phases combine the rows."""
    taps = km.shape[-1]
    hr = km @ er[:taps]
    hi = km @ ei[:taps]
    return cyt[:, :taps] @ hr + syt[:, :taps] @ hi


def kernel_spectrum(a, b, c, h: int, w: int, half: int = 12) -> torch.Tensor:
    """(N, h, w//2+1) real OTF of the sampled anisotropic Gaussian on the
    (h, w) circular canvas — ``p2o(kernel, (h, w))`` evaluated analytically
    (the kernel is centrally symmetric, so the imaginary part is zero)."""
    tables = (torch.as_tensor(v, device=a.device)
              for v in _tap_tables_np(h, w, half))
    return otf_from_taps(gaussian_taps(a, b, c, half),
                         *tables)[..., :w // 2 + 1]


def _horner_spectrum(khat, horner):
    a3, a2, a1, beta = horner
    return ((a3 * khat + a2) * khat + a1) * khat + beta
