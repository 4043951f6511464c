"""The fused directional-maxima reduction of the whole-image blur estimate.

Replaces polyblur_tpu/ops/pallas/est_fused.py::directional_maxima_pallas:
per image, gray = channel mean -> min/max normalize -> the two spectral
derivative products -> ``max |cos t gx - sin t gy|`` at the n_angles + 1
sampled directions, and only the (B, 7) maxima leave the kernel. It is
stages 1 and 2 of the patch engine's estimate kernel (``csrc/estimate.cu``:
gray + min/max + normalized scratch; the f32 derivative GEMM pair with the
7 maxima reduced in its epilogue), launched over the images as one tile
each and counted as ``directional_maxima``.

Bound on the H100: operations — 2 (H^2 W + H W^2) f32 MACs per image,
0.34 G at 480 x 640 (67 TFLOP/s f32). Stage 1 is one block per image: at
B = 1 one SM does the whole min/max pass; correct, and slow.
"""

from __future__ import annotations

import torch

from ..tables import N_ANGLES
from ._build import runs_plain
from .polyblur_fused import TileView, _maxima_plain, launch_estimate

__all__ = ["directional_maxima", "directional_maxima_plain"]


def _check(img: torch.Tensor, n_angles: int) -> None:
    if img.dim() != 4:
        raise ValueError(f"directional_maxima takes (B, C, H, W), got "
                         f"{tuple(img.shape)}")
    if n_angles != N_ANGLES:
        raise ValueError(f"the estimate kernel is built for n_angles="
                         f"{N_ANGLES}, got {n_angles}")


def directional_maxima_plain(img: torch.Tensor,
                             n_angles: int = N_ANGLES) -> torch.Tensor:
    """Plain version of :func:`directional_maxima`."""
    _check(img, n_angles)
    return _maxima_plain(TileView.of_tiles(img))


def directional_maxima(img: torch.Tensor,
                       n_angles: int = N_ANGLES) -> torch.Tensor:
    """(B, C, H, W) images in [0, 1] (C = 1 or 3, f32 or bf16) -> (B, 7)
    f32 directional gradient maxima of the min/max-normalized channel mean
    (q = 0, no saturation mask)."""
    _check(img, n_angles)
    if runs_plain(img):
        return directional_maxima_plain(img, n_angles)
    return launch_estimate(TileView.of_tiles(img.contiguous()), (1, 2),
                           "directional_maxima")[0]
