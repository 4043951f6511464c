"""Spatial-domain convolutions with per-sample kernels (port of
polyblur_tpu/ops/conv.py; reference filters.py:14-98 and the separable
C++ of separable_convolution/separable_gaussian2d.cpp).

* :func:`conv2d_grouped` — the grouped direct 2D cross-correlation of
  ``method='direct'``: every (b, c) plane its own kernel, zero 'same'
  padding ``((k - 1) // 2, k // 2)``, no flip;
* :func:`separable_gaussian_conv2d` — the anisotropic Gaussian as two 1D
  passes: axis-aligned (rows, then columns) where theta is a multiple of
  90 degrees or sigma == rho, else the sheared ("xt") pass: an x pass,
  then taps along the sheared direction, each a row-shifted (clipped) and
  fractionally column-shifted copy. Both branches run and are blended by
  mask, as the JAX package does.

Neither has a TPU kernel: the JAX package lowers them to
``lax.conv_general_dilated`` with f32 accumulation, here ``F.conv2d`` on
f32 operands (the kernel first rounded to the image dtype), cast back to
the image dtype. cuDNN would run f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), 10 bits of mantissa; every
convolution here, forward and backward, is one autograd Function whose
two passes run inside :func:`full_f32_convs` (TF32 off, deterministic
algorithms), so the card computes the f32 products the JAX package's CPU
and TPU paths do, and the same gradients on every run.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..utils.imaging import replicate_pad

__all__ = ["conv2d_grouped", "convolve2d", "gaussian_taps_1d",
           "separable_gaussian_conv2d", "full_f32_convs"]


# cuDNN's flags are process-global: the scope is counted, so a backward on
# the autograd engine's thread and a forward on the caller's can overlap
# without either restoring the flags under the other
_scope_lock = threading.Lock()
_scope_depth = 0
_scope_saved = None


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN's f32 convolutions without TF32, by deterministic algorithms,
    while any thread is inside the block; the flags the first entrant found
    are restored when the last one leaves. Other threads' convolutions in
    that window run without TF32 too."""
    global _scope_depth, _scope_saved
    cudnn = torch.backends.cudnn
    with _scope_lock:
        if _scope_depth == 0:
            _scope_saved = (cudnn.allow_tf32, cudnn.deterministic)
            cudnn.allow_tf32, cudnn.deterministic = False, True
        _scope_depth += 1
    try:
        yield
    finally:
        with _scope_lock:
            _scope_depth -= 1
            if _scope_depth == 0:
                cudnn.allow_tf32, cudnn.deterministic = _scope_saved


class _GroupedConv(torch.autograd.Function):
    """(1, N, H', W') valid f32 cross-correlation with (N, 1, kh, kw) f32
    kernels, one per plane; both passes inside :func:`full_f32_convs`."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        with full_f32_convs():
            return F.conv2d(x, k, groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        gx = gk = None
        with full_f32_convs():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, k, g,
                                                groups=x.shape[1])
            if ctx.needs_input_grad[1]:
                gk = torch.nn.grad.conv2d_weight(x, k.shape, g,
                                                 groups=x.shape[1])
        return gx, gk


def _grouped_conv(x: torch.Tensor, k: torch.Tensor, dtype) -> torch.Tensor:
    """(1, N, H', W') valid cross-correlation with (N, 1, kh, kw) kernels,
    one per plane: the kernel rounded to ``dtype``, f32 products and
    accumulation, the result in ``dtype``."""
    return _GroupedConv.apply(x.float(), k.to(dtype).float()).to(dtype)


def conv2d_grouped(img: torch.Tensor, kernel: torch.Tensor,
                   padding: str = "same") -> torch.Tensor:
    """'same' cross-correlation where every (b, c) plane has its own
    kernel (filters.py:40-49: ``F.conv2d`` does not flip; zero padding).

    :param img: (B, C, H, W)
    :param kernel: (B, C, h, w) or (B, 1, h, w) (broadcast over channels)
    :return: (B, C, H, W) in the image dtype
    """
    b, c, h, w = img.shape
    if kernel.shape[1] == 1 and c > 1:
        kernel = kernel.expand(b, c, *kernel.shape[2:])
    kh, kw = kernel.shape[-2:]
    x = img.reshape(1, b * c, h, w)
    if padding == "same":
        x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    elif padding != "valid":
        raise ValueError(f"padding {padding!r} not supported")
    out = _grouped_conv(x, kernel.reshape(b * c, 1, kh, kw), img.dtype)
    return out.reshape(b, c, *out.shape[-2:])


def convolve2d(img: torch.Tensor, kernel, method: str = "direct"):
    """Dispatcher (filters.py:14-37): ``kernel`` is a (B, C, h, w) /
    (B, 1, h, w) tensor (``'direct'``, ``'fft'``) or a ``(sigma, rho,
    theta)`` tuple of (B, C) tensors (``'direct'``,
    ``'direct_separable'``)."""
    if method == "direct":
        if isinstance(kernel, (tuple, list)):
            return separable_gaussian_conv2d(img, *kernel)
        return conv2d_grouped(img, kernel)
    if method == "fft":
        from .fourier import fft_convolve2d

        return fft_convolve2d(img, kernel)
    if method == "direct_separable":
        return separable_gaussian_conv2d(img, *kernel)
    raise ValueError(f"Convolution method {method!r} is not implemented")


def gaussian_taps_1d(sigma: torch.Tensor, ksize: int) -> torch.Tensor:
    """(N, ksize) L1-normalized 1D Gaussian taps of the (N,) stds on the
    centred grid ``-ksize // 2 + 1 .. ksize // 2``."""
    t = torch.arange(-ksize // 2 + 1, ksize // 2 + 1, device=sigma.device
                     ).to(sigma.dtype)
    # float64 exp, as in ``ops.sep_poly.gaussian_taps``
    k = torch.exp((-(t * t)[None, :] / (2.0 * (sigma * sigma)[:, None]))
                  .double()).to(sigma.dtype)
    return k / k.sum(dim=-1, keepdim=True)


def _conv1d_rows(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(N, H, W) planes convolved along the last axis with their (N, k)
    taps, replicate-padded (``k // 2 - 1`` left for even k, ``k // 2``
    right)."""
    n, h, w = img.shape
    k = taps.shape[-1]
    r_left = k // 2 - 1 if k % 2 == 0 else k // 2
    x = replicate_pad(img, (r_left, k // 2, 0, 0))
    out = _grouped_conv(x[None], taps.reshape(n, 1, 1, k), img.dtype)
    return out[0]


def _ortho_conv(img: torch.Tensor, sigma_x: torch.Tensor,
                sigma_y: torch.Tensor, ksize: int) -> torch.Tensor:
    """Axis-aligned separable pass: rows with sigma_x, then columns with
    sigma_y."""
    out = _conv1d_rows(img, gaussian_taps_1d(sigma_x, ksize))
    out = _conv1d_rows(out.transpose(-1, -2), gaussian_taps_1d(sigma_y,
                                                               ksize))
    return out.transpose(-1, -2)


def _shift_rows_clip(img: torch.Tensor, shift: int) -> torch.Tensor:
    """``out[y] = img[clip(y + shift)]`` for an integer shift, (N, H, W):
    the edge row expanded, not repeated (a reduction backward)."""
    n, h, w = img.shape
    if shift == 0:
        return img
    if shift > 0:
        return torch.cat([img[:, shift:], img[:, -1:].expand(n, shift, w)],
                         1)
    return torch.cat([img[:, :1].expand(n, -shift, w), img[:, :shift]], 1)


def _frac_shift_cols(img: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """``out[..., x]``: ``img`` linearly interpolated at column ``x - dx``
    (indices clipped), per plane: ``dx`` is (N,)."""
    n, h, w = img.shape
    df = torch.floor(dx)
    a = (dx - df)[:, None, None].to(img.dtype)
    base = (torch.arange(w, device=img.device)[None, :]
            - df[:, None].to(torch.int64))
    idx0 = base.clamp(0, w - 1)[:, None, :].expand(n, h, w)
    idx1 = (base - 1).clamp(0, w - 1)[:, None, :].expand(n, h, w)
    return (1.0 - a) * torch.gather(img, -1, idx0) + a * torch.gather(
        img, -1, idx1)


def _xt_conv(img: torch.Tensor, sigma, rho, theta, ksize: int):
    """Oblique separable pass (separable_gaussian2d.cpp:91-183): an x pass
    with std ``sigma rho / sigma_phi``, then taps along the sheared
    direction (dy, dx) = (1, 1 / mu); tap i samples the image shifted i
    rows (replicate-clipped) and i / mu columns (linear)."""
    co, so = torch.cos(theta), torch.sin(theta)
    dot = rho * rho * co * co + sigma * sigma * so * so
    sigma_phi = torch.sqrt(dot)
    sigma_x = sigma * rho / sigma_phi
    mu = dot / (rho * rho - sigma * sigma + 1e-5)
    taps_x = gaussian_taps_1d(sigma_x, ksize)
    half = (ksize - 1) // 2
    t = torch.arange(0, half + 1, device=img.device).to(sigma.dtype)
    kphi = torch.exp((-(t * t)[None, :]
                      / (2.0 * (sigma_phi * sigma_phi)[:, None])).double()
                     ).to(sigma.dtype)
    kphi = kphi / (kphi[:, :1] + 2.0 * kphi[:, 1:].sum(dim=-1, keepdim=True))
    imgx = _conv1d_rows(img, taps_x)
    out = kphi[:, 0][:, None, None] * imgx
    inv_mu = 1.0 / mu
    for i in range(1, half + 1):
        up = _frac_shift_cols(_shift_rows_clip(imgx, -i), -i * inv_mu)
        dn = _frac_shift_cols(_shift_rows_clip(imgx, i), i * inv_mu)
        out = out + kphi[:, i][:, None, None] * (up + dn)
    return out


def separable_gaussian_conv2d(img: torch.Tensor, sigma: torch.Tensor,
                              rho: torch.Tensor, theta: torch.Tensor,
                              ksize: int = 25) -> torch.Tensor:
    """Anisotropic Gaussian blur by two 1D passes, per-plane parameters
    (polyblur_tpu/ops/conv.py:195-239): planes whose theta is a multiple
    of 90 degrees (within 1e-4), or with sigma == rho, take the
    axis-aligned pass (sigma along x where floor(theta in degrees) mod 180
    is 0, else along y), the others the sheared pass; both are computed
    (the sheared one on safe parameters where it is masked out) and
    blended by mask.

    :param img: (B, C, H, W)
    :param sigma, rho, theta: (B, C) or (B, 1) per-plane parameters
    :return: (B, C, H, W)
    """
    b, c, h, w = img.shape
    if sigma.shape[1] != c:
        sigma, rho, theta = (v.expand(b, c) for v in (sigma, rho, theta))
    x = img.reshape(b * c, h, w)
    sg, rh, th = (v.reshape(-1) for v in (sigma, rho, theta))
    atol = 1e-4
    deg = th * (180.0 / math.pi)
    is_ortho = (torch.remainder(deg, 90.0) <= atol) | (sg == rh)
    along_x = torch.remainder(torch.floor(deg), 180.0) < atol
    sx = torch.where(along_x, sg, rh)
    sy = torch.where(along_x, rh, sg)
    out_ortho = _ortho_conv(x, sx, sy, ksize)
    th_safe = torch.where(is_ortho, torch.full_like(th, math.pi / 4.0), th)
    sg_safe = torch.where(is_ortho, torch.ones_like(sg), sg)
    rh_safe = torch.where(is_ortho, torch.full_like(rh, 0.5), rh)
    out_xt = _xt_conv(x, sg_safe, rh_safe, th_safe, ksize)
    out = torch.where(is_ortho[:, None, None], out_ortho, out_xt)
    return out.reshape(b, c, h, w)
