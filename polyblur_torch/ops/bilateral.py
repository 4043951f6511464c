"""Bilateral filter: the edge-aware smoother of the prefilter (port of
polyblur_tpu/ops/bilateral.py; reference filters.py:107-148).

``J = sum_s w_s(I) I_s / (sum_s w_s(I) + 1e-5)`` over the ksize x ksize
replicate-padded neighbourhood, with spatial weights ``exp(-(dx^2 + dy^2) /
2 sigma_s^2)`` and colour weights ``exp(-(I_s - I)^2 / 2 sigma_c^2)``. On the
card every size runs the hand-written kernel (``ops/cuda/bilateral.py``,
``csrc/bilateral.cu``); the JAX package's 640 px cap was the TPU's VMEM
limit and only chose Pallas over XLA, which compute the same function.
The filter is differentiable (ROADMAP B.1 item 7): one autograd Function
whose backward runs autograd of :func:`_bilateral_plain`, as
``bilateral_pallas``'s custom VJP replays ``_bilateral_xla``
(polyblur_tpu/ops/pallas/bilateral.py:102-123).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.imaging import pad_with_kernel
from ..utils.profiling import record_dispatch

__all__ = ["bilateral_filter", "spatial_weights"]


def spatial_weights(ksize: int = 5, sigma_spatial: float = 5.0) -> np.ndarray:
    """(ksize, ksize) f32 spatial weights of the reference's grid
    ``t = arange(-ksize//2 + 1, ksize//2 + 1)``, computed in float64 and
    rounded to f32 (rows dy, columns dx), as bilateral_block computes
    them."""
    t = np.arange(-ksize // 2 + 1, ksize // 2 + 1)
    gw = np.exp(-(t[None, :] ** 2 + t[:, None] ** 2)
                / (2.0 * sigma_spatial * sigma_spatial))
    return gw.astype(np.float32)


def _bilateral_plain(img: torch.Tensor, ksize: int = 5,
                     sigma_spatial: float = 5.0,
                     sigma_color: float = 0.1) -> torch.Tensor:
    """The arithmetic of the JAX package's ``_bilateral_xla`` in f32 (as
    ``bilateral_pallas`` computes it for any input dtype), cast back to
    the input dtype; the taps are summed in the same order (dy outer, dx
    inner). While autograd records ``img`` the replicate pad is built from
    expanded edges (``utils.imaging.replicate_pad``), whose backward sums
    by reductions, not by the atomics of ``F.pad``'s."""
    x = img.float()
    h, w = x.shape[-2:]
    gw = spatial_weights(ksize, sigma_spatial)
    padded = pad_with_kernel(x, ksize=ksize)
    inv_var2 = torch.tensor(1.0 / (2.0 * sigma_color * sigma_color),
                            dtype=torch.float32)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(ksize):
        for dx in range(ksize):
            shifted = padded[..., dy:dy + h, dx:dx + w]
            d = shifted - x
            # exp in float64 (see ops.sep_poly.gaussian_taps)
            f = torch.exp((-d * d * inv_var2).double()).float() * float(
                gw[dy, dx])
            num = num + f * shifted
            den = den + f
    return (num / (den + 1e-5)).to(img.dtype)


def bilateral_filter(img: torch.Tensor, ksize: int = 5,
                     sigma_spatial: float = 5.0,
                     sigma_color: float = 0.1) -> torch.Tensor:
    """Edge-preserving smoothing of a (B, C, H, W) batch; returns the
    smoothed batch in the input dtype (the kernel on CUDA tensors, its
    plain version on CPU tensors), differentiable in ``img``."""
    from .cuda.autograd import replay
    from .cuda.bilateral import bilateral
    from .cuda.polyblur_fused import TileView

    record_dispatch("bilateral_filter", "cuda")
    if img.dim() != 4:
        raise ValueError(f"bilateral_filter takes (B, C, H, W), got "
                         f"{tuple(img.shape)}")
    return replay(
        lambda t: bilateral(TileView.of_tiles(t.contiguous()), ksize,
                            sigma_spatial, sigma_color),
        lambda t: _bilateral_plain(t, ksize, sigma_spatial, sigma_color),
        img)
