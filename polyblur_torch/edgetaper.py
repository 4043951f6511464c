"""Edge tapering: boundary preprocessing before deconvolution (port of
polyblur_tpu/edgetaper.py; reference edgetaper.py).

The taper weight map ``alpha`` is the outer product of 1 minus the
normalized periodic autocorrelations of the kernel's axis projections; the
image is blended ``alpha * img + (1 - alpha) * blur(img)`` ``n_tapers``
times. The autocorrelations are divided by their GLOBAL maximum over the
whole batch (the reference's ``torch.max``, edgetaper.py:15,21), as the
JAX package keeps it; the tiles route's taper stage
(``ops/cuda/features.py``) divides per tile, as the TPU kernel does, so
the two agree for a single tile only.
"""

from __future__ import annotations

import torch

from .ops.conv import convolve2d
from .ops.gaussian import batch_gaussian_kernels

__all__ = ["edgetaper", "edgetaper_alpha"]


def _projection_autocorr(proj: torch.Tensor, n: int) -> torch.Tensor:
    """Periodic autocorrelation of a kernel axis projection over length
    n - 1, extended to n, as 1 - z / max(z) with the batch-global max."""
    z = torch.fft.fft(proj.float(), n=n - 1, dim=-1)
    z = torch.fft.ifft(torch.abs(z) ** 2, dim=-1).real
    z = torch.cat([z, z[..., :1]], -1)
    return 1.0 - z / torch.amax(z)


def edgetaper_alpha(kernel: torch.Tensor, img_shape) -> torch.Tensor:
    """Taper weight map of shape (B, C, H, W) (edgetaper.py:10-23) from
    (B, C, h, w) kernels."""
    h, w = img_shape
    v1 = _projection_autocorr(kernel.sum(-1), h)   # (B, C, H)
    v2 = _projection_autocorr(kernel.sum(-2), w)   # (B, C, W)
    return v1[..., :, None] * v2[..., None, :]


def _kernels_from_params(sigma, rho, theta, ksize: int) -> torch.Tensor:
    """(B, C', ksize, ksize) 2D kernels of (B, C') blur parameters
    (blur_estimation.py:211-232 semantics)."""
    b, c = sigma.shape
    k = batch_gaussian_kernels(theta.reshape(-1, 1), sigma.reshape(-1, 1),
                               rho.reshape(-1, 1), ksize)
    return k.reshape(b, c, ksize, ksize)


def edgetaper(img: torch.Tensor, kernel, n_tapers: int = 3,
              method: str = "fft", ksize: int = 25) -> torch.Tensor:
    """Blend the image borders with blurred copies (edgetaper.py:26-33).

    ``kernel`` is a (B, C, h, w) tensor, blurred by ``ops.conv.convolve2d``
    with ``method`` (the circular FFT convolution for ``'fft'``, the zero
    'same' grouped convolution for ``'direct'``), or a ``(sigma, rho,
    theta)`` tuple of (B, C') tensors: the weight map then comes from the
    parametric kernels and the blur is the exact sampled-kernel circular
    convolution ``ops.sep_poly.spectral_blur`` (the fused or blocked
    polynomial kernel with p(z) = z).
    """
    h, w = img.shape[-2:]
    if isinstance(kernel, (tuple, list)):
        from .ops.sep_poly import spectral_blur

        sigma, rho, theta = kernel
        k2d = _kernels_from_params(sigma, rho, theta, ksize)
        alpha = edgetaper_alpha(k2d, (h, w)).to(img.dtype)
        for _ in range(n_tapers):
            blurred = spectral_blur(img, sigma, rho, theta, ker_size=ksize)
            img = alpha * img + (1.0 - alpha) * blurred
        return img
    alpha = edgetaper_alpha(kernel, (h, w)).to(img.dtype)
    for _ in range(n_tapers):
        blurred = convolve2d(img, kernel, method=method)
        img = alpha * img + (1.0 - alpha) * blurred
    return img
