"""Non-blind restoration: the degree-3 polynomial deconvolution.

With blur operator K and gains (alpha, beta) the degree-3 filter is

    a3 = alpha/2 - beta + 2,  a2 = 3 beta - alpha - 6,  a1 = 5 - 3 beta + alpha/2
    out = a3 K^3 u + a2 K^2 u + a1 K u + beta u            (Horner evaluated)

(reference deblurring.py:113-239; port of polyblur_tpu/restoration.py). The
patch engine evaluates it per tile in the spectral kernels of
ops/cuda/polyblur_fused.py; the whole-image route through
:func:`inverse_filtering_rank3`: ``'direct_separable'`` with the
``(sigma, rho, theta)`` parameters takes ``ops.sep_poly`` (the fused or
blocked kernel), ``'fft'`` with the 2D kernel takes ``torch.fft``,
``'direct'`` (the reference's own method on CUDA) three grouped spatial
convolutions (``ops.conv``); the optional edgetaper (``edgetaper.py``) and
halo masking (:func:`halo_masking`) wrap it as in the JAX package.
"""

from __future__ import annotations

import torch

from . import edgetaper as _edgetaper
from .ops.conv import convolve2d
from .ops.fourier import p2o, spectral_gradients
from .ops.sep_poly import compute_polynomial_separable
from .utils.imaging import clip_as_jax, crop_with_kernel, pad_with_kernel
from .utils.profiling import record_dispatch

__all__ = ["polynomial_coefficients", "compute_polynomial",
           "compute_polynomial_fft", "compute_polynomial_direct",
           "halo_masking", "inverse_filtering_rank3"]


def polynomial_coefficients(alpha, beta):
    """(a3, a2, a1) of the gains: Python numbers, or tensors that stay in
    the autograd graph."""
    a3 = alpha / 2.0 - beta + 2.0
    a2 = 3.0 * beta - alpha - 6.0
    a1 = 5.0 - 3.0 * beta + alpha / 2.0
    return a3, a2, a1


def compute_polynomial_fft(img: torch.Tensor, kernel: torch.Tensor, alpha,
                           beta, not_symmetric: bool = False) -> torch.Tensor:
    """Fourier-domain polynomial filter (deblurring.py:141-169): one fft2,
    the kernel's OTF, three complex multiply-adds, one ifft2."""
    h, w = img.shape[-2:]
    Y = torch.fft.fft2(img.float())
    K = p2o(kernel, (h, w))
    if not_symmetric:
        # pure-phase correction for non-symmetric kernels
        Y = torch.conj(K) / (torch.abs(K) + 1e-8) * Y
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    X = a3 * Y
    X = K * X + a2 * Y
    X = K * X + a1 * Y
    X = K * X + beta * Y
    return torch.fft.ifft2(X).real.to(img.dtype)


def compute_polynomial_direct(img: torch.Tensor, kernel, alpha, beta,
                              method: str = "direct") -> torch.Tensor:
    """Spatial-domain polynomial filter (deblurring.py:122-138): Horner
    with three convolutions, ``((a3 u) * k + a2 u) * k + a1 u) * k + beta
    u``. ``kernel`` is a (B, C, h, w) / (B, 1, h, w) tensor (grouped 2D
    convolution, zero 'same' padding) or a ``(sigma, rho, theta)`` tuple
    (the separable Gaussian passes)."""
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    out = a3 * img
    out = convolve2d(out, kernel, method=method) + a2 * img
    out = convolve2d(out, kernel, method=method) + a1 * img
    return convolve2d(out, kernel, method=method) + beta * img


def compute_polynomial(img, kernel, alpha, beta, method: str = "fft",
                       not_symmetric: bool = False, ker_size: int = 25):
    """Backend dispatcher (deblurring.py:113-119): ``'fft'`` with a 2D
    kernel, ``'direct_separable'`` with a ``(sigma, rho, theta)`` tuple
    (the spectral kernels), ``'direct'`` (and ``'direct_separable'`` with a
    2D kernel) by spatial convolutions."""
    if method == "fft":
        return compute_polynomial_fft(img, kernel, alpha, beta, not_symmetric)
    if method == "direct_separable" and isinstance(kernel, (tuple, list)):
        sigma, rho, theta = kernel
        return compute_polynomial_separable(img, sigma, rho, theta, alpha,
                                            beta, ker_size=ker_size)
    if method in ("direct", "direct_separable"):
        return compute_polynomial_direct(img, kernel, alpha, beta, method)
    raise ValueError(f"{method!r} not implemented")


def halo_masking(img: torch.Tensor, imout: torch.Tensor,
                 grad_img=None) -> torch.Tensor:
    """Replace gradient-inverted pixels of the output by the input (Alg. 5):
    ``M = -<grad u, grad u_hat>`` per pixel, ``nM = sum ||grad u||^2``,
    ``z = clip(M / (nM + M), 0)``, ``out = z u + (1 - z) u_hat``
    (deblurring.py:193-208 with the grad_prod_ bug fixed; the 1e-12 guard
    keeps constant images finite). The clip follows ``jnp.clip``'s tie
    rule (``utils.imaging.clip_as_jax``): ``z`` is exactly 0 wherever
    ``M`` is, in every flat region and replicate border."""
    if grad_img is None:
        grad_x, grad_y = spectral_gradients(img)
    else:
        grad_x, grad_y = grad_img
    gout_x, gout_y = spectral_gradients(imout)
    m = (-grad_x * gout_x) + (-grad_y * gout_y)
    nm = torch.sum(grad_x * grad_x + grad_y * grad_y, dim=(-2, -1),
                   keepdim=True)
    z = clip_as_jax(m / (nm + m + 1e-12), 0.0, None)
    return imout + z * (img - imout)


def inverse_filtering_rank3(img: torch.Tensor, kernel, alpha=2.0, beta=4.0,
                            correlate: bool = False,
                            remove_halo: bool = False,
                            do_edgetaper: bool = False, grad_img=None,
                            method: str = "fft",
                            ker_size: int = 25,
                            prefer_xla: bool = False) -> torch.Tensor:
    """One polynomial deconvolution step (deblurring.py:211-239):
    replicate-pad by half the kernel support, optionally edgetaper, apply
    p(K), crop back, optionally mask halos against the (tapered) padded
    image cropped back, clip to [0, 1] (``jnp.clip``'s tie rule, as the
    halo's). ``ker_size`` sets the support of
    parametric ``(sigma, rho, theta)`` kernels; 2D kernels carry their
    own. ``grad_img`` is the halo mask's input gradients (computed from
    ``img`` when None). ``prefer_xla`` sends the separable route's
    polynomial down the plain composition instead of the kernels, as the
    JAX package's scan route does under ``remat``."""
    is_param_kernel = isinstance(kernel, (tuple, list))
    ksize = ker_size if is_param_kernel else kernel.shape[-1]
    fast = (is_param_kernel and method == "direct_separable"
            and not do_edgetaper)
    record_dispatch("inverse_filtering_rank3",
                    "separable_fast" if fast else f"generic/{method}")
    if fast:
        # padding, crop (and the final clamp without the halo mask) are
        # fused into the kernel
        sigma, rho, theta = kernel
        if remove_halo:
            imout = compute_polynomial_separable(img, sigma, rho, theta,
                                                 alpha, beta, prepad=True,
                                                 ker_size=ksize,
                                                 prefer_xla=prefer_xla)
            return clip_as_jax(halo_masking(img, imout, grad_img))
        return compute_polynomial_separable(img, sigma, rho, theta, alpha,
                                            beta, prepad=True, clip=True,
                                            ker_size=ksize,
                                            prefer_xla=prefer_xla)
    if correlate and not is_param_kernel:
        kernel = torch.rot90(kernel, 2, dims=(-2, -1))
    padded = pad_with_kernel(img, ksize=ksize)
    if do_edgetaper:
        # the taper of parametric kernels samples 25 taps whatever
        # ker_size is: the JAX package passes no support here
        # (polyblur_tpu/restoration.py:185)
        padded = _edgetaper.edgetaper(padded, kernel, method=method)
    imout = compute_polynomial(padded, kernel, alpha, beta, method=method,
                               ker_size=ksize)
    imout = crop_with_kernel(imout, ksize=ksize)
    if remove_halo:
        imout = halo_masking(crop_with_kernel(padded, ksize=ksize), imout,
                             grad_img)
    return clip_as_jax(imout)
