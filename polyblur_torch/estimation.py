"""Blind anisotropic-Gaussian blur estimation from directional gradient
statistics (reference blur_estimation.py), plain torch.

The chain is: range-normalize -> spectral gradients -> per-angle directional
gradient maxima -> Keys-cubic interpolation to a finer angle grid -> argmin
angle (the blur direction) -> affine model ``sigma^2 = c^2 / f^2 - b^2``
with clamping.

Every branch of the JAX package (polyblur_tpu/estimation.py) is here: the
C == 3 (or not multichannel) gray collapse or, for ``multichannel`` images
of another channel count, each channel estimated on its own; ``q > 0``
quantile normalization; the ``discard_saturation`` mask; any ``n_angles``.
The q = 0, no-saturation directional maxima of images up to
``MEGA_MAX_TILE`` go through the fused reduction
(``ops.cuda.est_fused.directional_maxima``), larger ones and the other
branches through the plain chain of spectral gradients, as the JAX package
runs XLA there. The plain version of the patch engine's per-tile estimate
(``ops.cuda.polyblur_fused.tile_estimate_plain``) is built from the steps
here, fed with the kernel's host tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .envelopes import MEGA_MAX_TILE
from .ops.fourier import spectral_gradients
from .ops.gaussian import batch_gaussian_kernels
from .utils.imaging import clip_as_jax
from .utils.profiling import record_dispatch

__all__ = ["gaussian_blur_estimation", "find_maximal_blur_direction",
           "compute_gaussian_parameters", "cubic_interpolator",
           "angle_grids", "normalize_range", "normalize_quantiles",
           "quantile_linear", "directional_maxima", "keys_weights",
           "weighted_sum", "blur_direction", "clamped_variances",
           "compute_gradient_magnitudes"]


def angle_grids(n_angles: int, n_interpolated_angles: int,
                dtype: torch.dtype = torch.float32):
    """(thetas (n_angles + 1,), interpolated_thetas (n_interp,)) in degrees
    as ``dtype``, integer-truncated like the reference's ``.long()``
    tensors (deblurring.py:62-63)."""
    thetas = torch.floor(torch.linspace(0.0, 180.0, n_angles + 1,
                                        dtype=torch.float64))
    interpolated_thetas = torch.floor(torch.arange(
        0.0, 180.0, 180.0 / n_interpolated_angles, dtype=torch.float64))
    return thetas.to(dtype), interpolated_thetas.to(dtype)


def normalize_range(x: torch.Tensor) -> torch.Tensor:
    """Min/max normalize over the last two axes, guarded and clipped to
    [0, 1] by ``jnp.clip``'s rule (``utils.imaging.clip_as_jax``): the
    darkest and brightest pixels sit exactly on its bounds."""
    vmin = x.amin(dim=(-2, -1), keepdim=True)
    vmax = x.amax(dim=(-2, -1), keepdim=True)
    v = (x - vmin) / torch.clamp(vmax - vmin, min=1e-8)
    return clip_as_jax(v, 0.0, 1.0)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """(..., 1) ``q``-quantile of ``x`` over its last axis, linearly
    interpolated between the sorted neighbours, in ``x``'s dtype:
    ``jnp.quantile``'s arithmetic (the position ``q (n - 1)`` and the
    weights in f32, the two values weighted in f32 and rounded once; NaN
    when the row holds one). ``torch.quantile`` refuses bf16 and rows past
    2^24 elements, which a 12 MP image has."""
    n = x.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(np.float32(1.0) - w_hi)
    lo, hi = (int(min(max(v, 0), n - 1)) for v in (lo, hi))
    xs = torch.sort(x, dim=-1).values
    f32 = torch.float32
    v = (xs[..., lo:lo + 1].float() * torch.tensor(w_lo, dtype=f32)
         + xs[..., hi:hi + 1].float() * torch.tensor(w_hi, dtype=f32))
    nan = torch.isnan(x).any(dim=-1, keepdim=True)
    return torch.where(nan, torch.nan, v).to(x.dtype)


def normalize_quantiles(x: torch.Tensor, q: float = 0.0) -> torch.Tensor:
    """Range-normalize every (b, c) slice of a (B, C, H, W) batch: by the
    (q, 1 - q) quantiles for q > 0, by min/max otherwise
    (:func:`normalize_range`), guarded and clipped to [0, 1]
    (polyblur_tpu/estimation.py:38-55)."""
    if q <= 0:
        return normalize_range(x)
    flat = x.reshape(x.shape[:2] + (-1,))
    vmin = quantile_linear(flat, q)[..., None]
    vmax = quantile_linear(flat, 1.0 - q)[..., None]
    v = (x - vmin) / torch.clamp(vmax - vmin, min=1e-8)
    return clip_as_jax(v, 0.0, 1.0)


def directional_maxima(gx: torch.Tensor, gy: torch.Tensor,
                       cs: torch.Tensor) -> torch.Tensor:
    """(..., n) maxima over the last two axes of ``|cos t gx - sin t gy|``
    at the n angles of the (n, 2) cos/sin table ``cs``."""
    return torch.stack([torch.abs(cs[a, 0] * gx - cs[a, 1] * gy)
                        .amax(dim=(-2, -1)) for a in range(cs.shape[0])], -1)


def compute_gradient_magnitudes(grad_x: torch.Tensor, grad_y: torch.Tensor,
                                n_angles: int = 6) -> torch.Tensor:
    """Max absolute directional derivative per sampled angle:
    ``max_xy |cos t gx - sin t gy|`` for t in linspace(0, pi, n_angles + 1)
    on the channel means of the gradients, with the angles cast to
    ``grad_x``'s dtype before cos / sin (polyblur_tpu/estimation.py:57-73,
    blur_estimation.py:122-134).

    :param grad_x, grad_y: (B, C, H, W)
    :return: (B, n_angles + 1)
    """
    # the channel means summed in f32 and scaled by 1 / C, as XLA's
    # jnp.mean runs on the CPU (it multiplies by the reciprocal)
    inv_c = 1.0 / grad_x.shape[1]
    gx = (grad_x.sum(1, dtype=torch.float32) * inv_c).to(grad_x.dtype)
    gy = (grad_y.sum(1, dtype=torch.float32) * inv_c).to(grad_y.dtype)
    angles = torch.linspace(0.0, math.pi, n_angles + 1,
                            device=gx.device).to(gx.dtype)
    cs = torch.stack([torch.cos(angles), torch.sin(angles)], -1)
    return directional_maxima(gx, gy, cs)


def _mags_xla(img: torch.Tensor, n_angles: int, q: float = 0.0,
              discard_saturation: bool = False) -> torch.Tensor:
    """normalize -> spectral gradients -> directional maxima in the image
    dtype, as the JAX package's XLA chain runs on every backend (the
    gradients are computed in f32 and rounded): min/max or, for q > 0,
    quantile normalization; with ``discard_saturation`` the gradients of
    the pixels above 0.99 (of the image as given) are zeroed
    (polyblur_tpu/estimation.py:184-195). ``img`` is (B, C, H, W);
    returns (B, n_angles + 1)."""
    gx, gy = spectral_gradients(normalize_quantiles(img, q))
    if discard_saturation:
        mask = img > 0.99
        gx, gy = gx.masked_fill(mask, 0.0), gy.masked_fill(mask, 0.0)
    angles = torch.linspace(0.0, math.pi, n_angles + 1,
                            device=img.device).to(img.dtype)
    return directional_maxima(
        gx.mean(dim=1), gy.mean(dim=1),
        torch.stack([torch.cos(angles), torch.sin(angles)], 1))


def _mags_fast(img: torch.Tensor, n_angles: int) -> torch.Tensor:
    """Directional maxima through the fused reduction for images up to
    ``MEGA_MAX_TILE`` (the kernel on CUDA tensors, its plain version on
    CPU ones), the plain chain of :func:`_mags_xla` above. The fused
    reduction computes in f32 and returns the image dtype, as the JAX
    package casts its Pallas maxima back (polyblur_tpu
    estimation.py:160-161). Its backward replays autograd of
    :func:`_mags_xla`, as the JAX package's custom VJP does
    (estimation.py:143-175; ROADMAP B.1 item 6): the gradient of max and
    abs, defined almost everywhere."""
    if max(img.shape[-2:]) <= MEGA_MAX_TILE:
        from .ops.cuda.autograd import replay
        from .ops.cuda.est_fused import directional_maxima as fused

        record_dispatch("directional_maxima", "fused")
        return replay(lambda x: fused(x, n_angles).to(x.dtype),
                      lambda x: _mags_xla(x, n_angles), img)
    record_dispatch("directional_maxima", "plain")
    return _mags_xla(img, n_angles)


def _as(v, like: torch.Tensor):
    """A Python number as a 0-d tensor of ``like``'s dtype (a tensor is
    returned as it is): JAX rounds a weak-typed constant to the operand's
    dtype before the operation, PyTorch would apply it in f32."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def keys_weights(x_new: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., N, n) Keys-cubic weights of the samples ``x`` (..., n) at
    ``x_new`` (..., N), with the reference's 1e-5 weight-sum guard
    (blur_estimation.py:138-148)."""
    d = torch.abs(x_new[..., :, None] - x[..., None, :])
    w = torch.where(
        d < 1.0,
        (1.5 * d - 2.5) * d * d + 1.0,
        torch.where(d < 2.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0,
                    torch.zeros_like(d)),
    )
    return w / (w.sum(dim=-1, keepdim=True) + 1e-5)


def weighted_sum(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum_k w[..., :, k] * y[..., k]``, summed in k order (the order the
    estimate kernel sums in)."""
    out = y[..., 0, None] * w[..., 0]
    for k in range(1, y.shape[-1]):
        out = out + y[..., k, None] * w[..., k]
    return out


def cubic_interpolator(x_new: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Keys cubic interpolation of ``y(x)`` at ``x_new``. Shapes:
    x_new (..., N), x (..., n), y (..., n) -> (..., N). The weights are
    computed in the dtype of ``x``; below f32 the sum accumulates in f32
    and is rounded once, as the JAX package's einsum does."""
    w = keys_weights(x_new, x)
    if y.dtype == torch.float32:
        return weighted_sum(w, y)
    return weighted_sum(w.float(), y.float()).to(y.dtype)


def blur_direction(interp: torch.Tensor, interpolated_thetas: torch.Tensor):
    """First-minimum argmin of the interpolated maxima (..., N) and the
    magnitude at the +90 degree orthogonal angle.

    :return: (i_min, magnitudes_normal, magnitudes_ortho, thetas_normal in
        degrees), each (..., 1)
    """
    n_interp = interpolated_thetas.shape[-1]
    i_min = torch.argmin(interp, dim=-1, keepdim=True)  # first minimum
    thetas_normal = torch.gather(interpolated_thetas.expand_as(interp), -1,
                                 i_min)
    thetas_ortho = torch.remainder(thetas_normal + 90.0, 180.0)
    i_ortho = (thetas_ortho / (180.0 / n_interp)).to(torch.int64)
    return (i_min, torch.gather(interp, -1, i_min),
            torch.gather(interp, -1, i_ortho), thetas_normal)


def find_maximal_blur_direction(gradient_magnitudes: torch.Tensor,
                                thetas: torch.Tensor,
                                interpolated_thetas: torch.Tensor):
    """Blur direction = argmin of the interpolated directional maxima
    (blur_estimation.py:151-167), plus the magnitude at the +90 degree
    orthogonal angle.

    :return: (magnitudes_normal, magnitudes_ortho, theta_rad), each (B, 1)
    """
    n_interp = interpolated_thetas.shape[-1]
    interp = cubic_interpolator(interpolated_thetas / n_interp,
                                thetas / n_interp, gradient_magnitudes)
    _, m_n, m_o, thetas_normal = blur_direction(interp, interpolated_thetas)
    return m_n, m_o, thetas_normal * _as(math.pi / 180.0, thetas_normal)


def clamped_variances(magnitudes_normal, magnitudes_ortho, c, b):
    """Affine blur model with the reference's guards:
    ``clip(c^2 / (f^2 + 1e-8) - b^2, 0.09, 16)`` for both directions
    (blur_estimation.py:171-185), before the square root. Python numbers
    enter in the magnitudes' dtype, as JAX's weak types do; tensors
    promote it."""
    dt = magnitudes_normal.dtype
    for v in (c, b):
        # a tensor c or b is not weakly typed: it promotes the magnitudes,
        # as a traced f32 scalar does in JAX
        if isinstance(v, torch.Tensor):
            dt = torch.promote_types(dt, v.dtype)
    magnitudes_normal = m = magnitudes_normal.to(dt)
    magnitudes_ortho = magnitudes_ortho.to(dt)
    cc, bb = _as(c * c, m), _as(b * b, m)
    eps, lo, hi = _as(1e-8, m), _as(0.09, m), _as(16.0, m)
    sigma2 = cc / (magnitudes_normal * magnitudes_normal + eps) - bb
    rho2 = cc / (magnitudes_ortho * magnitudes_ortho + eps) - bb
    return torch.clamp(sigma2, lo, hi), torch.clamp(rho2, lo, hi)


def compute_gaussian_parameters(magnitudes_normal, magnitudes_ortho, c, b):
    """``(sigma, rho)``: the square roots of :func:`clamped_variances`."""
    sigma2, rho2 = clamped_variances(magnitudes_normal, magnitudes_ortho,
                                     c, b)
    return torch.sqrt(sigma2), torch.sqrt(rho2)


def gaussian_blur_estimation(img: torch.Tensor, c=0.362, b=0.468,
                             q: float = 0.0, n_angles: int = 6,
                             n_interpolated_angles: int = 30,
                             ker_size: int = 25,
                             discard_saturation: bool = False,
                             multichannel: bool = False,
                             return_2d_filters: bool = True):
    """Estimate per-image Gaussian blur parameters.

    :param img: (B, C, H, W) blurry image(s) in [0, 1]
    :return: the (B, C', ker_size, ker_size) kernels, or the ``(sigma,
        rho, theta)`` tuple of (B, C') tensors when ``return_2d_filters``
        is False, in the image dtype; C' = C for a ``multichannel`` image
        of C != 3 channels (each estimated on its own), else 1 (the
        channel mean). As in the JAX package, the gray mean, the plain
        maxima chain, the angle grids, the interpolation and the blur
        model run in the image dtype; the fused maxima (and the plain
        chain's gradients) are computed in f32 and rounded to it.
    """
    dev, dt = img.device, img.dtype
    thetas, interpolated_thetas = angle_grids(n_angles, n_interpolated_angles,
                                              dt)
    if img.shape[1] == 3 or not multichannel:
        img = img.mean(dim=1, keepdim=True)
    bsz, csz = img.shape[:2]
    # each channel on its own: a (B C, 1, H, W) batch (the JAX package's
    # vmap over channels)
    planes = img.reshape(bsz * csz, 1, *img.shape[-2:])
    if q == 0.0 and not discard_saturation:
        mags = _mags_fast(planes, n_angles)
    else:
        record_dispatch("directional_maxima", "plain")
        mags = _mags_xla(planes, n_angles, q, discard_saturation)
    m_n, m_o, theta = find_maximal_blur_direction(
        mags, thetas[None].to(dev), interpolated_thetas[None].to(dev))
    sigma, rho = compute_gaussian_parameters(m_n, m_o, c=c, b=b)
    sigma, rho, theta = (v.reshape(bsz, csz) for v in (sigma, rho, theta))
    if not return_2d_filters:
        return sigma, rho, theta
    k = batch_gaussian_kernels(theta.reshape(-1, 1), sigma.reshape(-1, 1),
                               rho.reshape(-1, 1), ker_size)
    return k.reshape(bsz, csz, ker_size, ker_size).to(dt)
