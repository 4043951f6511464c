"""The fused directional-maxima reduction of the whole-image blur estimate.

Replaces polyblur_tpu/ops/pallas/est_fused.py::directional_maxima_pallas:
per image, gray = channel mean -> min/max normalize -> the two spectral
derivative products -> ``max |cos t gx - sin t gy|`` at the n_angles + 1
sampled directions ``t = k pi / n_angles``, and only the (B, n_angles + 1)
maxima leave the kernel. It is stages 1-3 of the patch engine's estimate
kernel (``csrc/estimate.cu``: the gray min/max pass in row bands, ~1024
blocks at any B; the normalization, writing g and its transpose split for
the tensor cores; the derivative GEMM pair on the tensor cores in 3xTF32
with the maxima reduced in its epilogue — the patch engine's 7 angles in
registers, any other count in register groups of 8), launched over the
images as one tile each and counted as ``directional_maxima``: 3 launches.
They run the 3xTF32 instantiation under either f32 dot mode: the JAX
kernel does not read the mode (est_fused.py:52-56).

Bound on the H100: operations — 2 (H^2 W + H W^2) MACs per image, 0.34 G
at 480 x 640 (the function needs f32 products: 67 TFLOP/s outside the
tensor cores); at B = 1 the GEMM has 80 output tiles of 64 x 64 for 132
SMs.
"""

from __future__ import annotations

import torch

from ..tables import N_ANGLES
from ._build import runs_plain
from .polyblur_fused import TileView, _maxima_plain, launch_estimate

__all__ = ["directional_maxima", "directional_maxima_plain"]


def _check(img: torch.Tensor) -> None:
    if img.dim() != 4:
        raise ValueError(f"directional_maxima takes (B, C, H, W), got "
                         f"{tuple(img.shape)}")


def directional_maxima_plain(img: torch.Tensor,
                             n_angles: int = N_ANGLES) -> torch.Tensor:
    """Plain version of :func:`directional_maxima`."""
    _check(img)
    return _maxima_plain(TileView.of_tiles(img), n_angles)


def directional_maxima(img: torch.Tensor,
                       n_angles: int = N_ANGLES) -> torch.Tensor:
    """(B, C, H, W) images in [0, 1] (f32 or bf16) -> (B, n_angles + 1)
    f32 directional gradient maxima of the min/max-normalized channel mean
    (q = 0, no saturation mask)."""
    _check(img)
    if runs_plain(img):
        return directional_maxima_plain(img, n_angles)
    return launch_estimate(TileView.of_tiles(img.contiguous()), (1, 2, 3),
                           "directional_maxima", n_angles=n_angles,
                           mode_free=True)[0]
