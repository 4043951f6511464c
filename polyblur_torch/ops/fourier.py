"""Fourier-domain primitives: spectral gradients, PSF->OTF, FFT convolution.

Ports of polyblur_tpu/ops/fourier.py (the reference's filters.py:159-186,
:255-273 and :31-35). The gradient discretization is kept exactly the
reference's, because the calibrated affine blur model (c, b) is only valid
for it.
"""

from __future__ import annotations

import math

import torch

from .spectral_matmul import fourier_gradients_matmul

__all__ = ["fourier_gradients", "spectral_gradients", "p2o", "fft_convolve2d"]


def spectral_gradients(images: torch.Tensor, backend: str = "auto"):
    """Spectral image gradients: the constant-matrix products up to 1024 px,
    the FFT above (as the JAX package switches). Same linear map either
    way."""
    if backend == "auto":
        backend = "matmul" if max(images.shape[-2:]) <= 1024 else "fft"
    if backend == "matmul":
        return fourier_gradients_matmul(images)
    return fourier_gradients(images)


def fourier_gradients(images: torch.Tensor):
    """Image gradients via Fourier interpolation: ``gx = Re IFFT(2 pi f_w
    i U)`` with ``U`` fftshifted, ``gy`` with the row frequencies.

    :param images: (..., H, W) real tensor
    :return: (grad_x, grad_y), same shape and dtype as ``images``
    """
    h, w = images.shape[-2:]
    U = torch.fft.fftshift(torch.fft.fft2(images.float()), dim=(-2, -1))
    dev = images.device
    freqh = ((torch.arange(h, device=dev) - h // 2) / h).float()[:, None]
    freqw = ((torch.arange(w, device=dev) - w // 2) / w).float()[None, :]
    iU = torch.complex(-U.imag, U.real)  # i * U
    gx = torch.fft.ifft2(torch.fft.ifftshift(2 * math.pi * freqw * iU,
                                             dim=(-2, -1))).real
    gy = torch.fft.ifft2(torch.fft.ifftshift(2 * math.pi * freqh * iU,
                                             dim=(-2, -1))).real
    return gx.to(images.dtype), gy.to(images.dtype)


def p2o(psf: torch.Tensor, shape) -> torch.Tensor:
    """Point-spread function -> optical transfer function: zero-embed the
    (..., h, w) PSF into (..., H, W), roll its centre to the origin, FFT."""
    h, w = psf.shape[-2:]
    otf = torch.zeros(psf.shape[:-2] + tuple(shape), dtype=torch.float32,
                      device=psf.device)
    otf[..., :h, :w] = psf.float()
    otf = torch.roll(otf, (-(h // 2), -(w // 2)), dims=(-2, -1))
    return torch.fft.fft2(otf)


def fft_convolve2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Circular 'same' convolution in the Fourier domain: wrap-pad by half
    the kernel support, multiply by the OTF, crop. ``kernel`` is
    (B, C, h, w) or (B, 1, h, w) and broadcasts over channels. The wrap
    pad is an index gather; while autograd records ``img`` and it is at
    least half the support on each side, it is concatenated slices
    instead (their backward sums by reduction, not by the atomics of
    ``index_select``'s)."""
    ks = kernel.shape[-1] // 2
    hh, ww = img.shape[-2:]
    if (torch.is_grad_enabled() and img.requires_grad
            and 0 < ks <= min(hh, ww)):
        x = torch.cat([img[..., -ks:, :], img, img[..., :ks, :]], -2)
        x = torch.cat([x[..., -ks:], x, x[..., :ks]], -1)
    else:
        rows = torch.arange(-ks, hh + ks, device=img.device) % hh
        cols = torch.arange(-ks, ww + ks, device=img.device) % ww
        x = img.index_select(-2, rows).index_select(-1, cols)
    K = p2o(kernel, x.shape[-2:])
    y = torch.fft.ifft2(K * torch.fft.fft2(x.float())).real
    return y[..., ks:-ks, ks:-ks].to(img.dtype)
