"""The Polyblur iteration of the patch engine: estimate -> spectrum ->
polynomial deconvolution, over a whole tile batch.

The TPU mega kernel (polyblur_tpu/ops/pallas/polyblur_fused.py) runs the N
iterations of one tile inside one VMEM-resident program. Here each stage
runs over all tiles at once (:func:`restore_tiles`), with the intermediates
in device memory: per iteration ``tile_estimate`` (3 launches),
``kernel_spectrum`` (1) and the four ``spectral_gemm`` products of
``spectral_poly``. The state is stored in the work dtype after every
iteration, as the TPU kernel stores it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .ops.cuda.overlap_add import blend_overlap_add, blend_overlap_add_plain
from .ops.cuda.pad_cast import edge_pad_cast, edge_pad_cast_plain
from .ops.cuda.polyblur_fused import (TileView, kernel_spectrum,
                                      kernel_spectrum_plain, spectral_poly,
                                      spectral_poly_plain, stage_tables,
                                      tile_estimate, tile_estimate_plain)
from .restoration import polynomial_coefficients

__all__ = ["StageOps", "KERNELS", "PLAIN", "restore_tiles", "_mega_pack"]


class StageOps(NamedTuple):
    """The five stage functions of the patch engine's path."""
    edge_pad_cast: Callable
    tile_estimate: Callable
    kernel_spectrum: Callable
    spectral_poly: Callable
    blend: Callable


#: The dispatching wrappers: plain versions on CPU tensors, kernels on CUDA.
KERNELS = StageOps(edge_pad_cast, tile_estimate, kernel_spectrum,
                   spectral_poly, blend_overlap_add)

#: The plain versions on any device — the reference the kernels are held
#: against on the card.
PLAIN = StageOps(edge_pad_cast_plain, tile_estimate_plain,
                 kernel_spectrum_plain, spectral_poly_plain,
                 blend_overlap_add_plain)


def _mega_pack(c, b, alpha, beta, sigma_s, sigma_r,
               device=None) -> torch.Tensor:
    """(8,) f32 coefficient vector of the per-tile stages:
    [a3, a2, a1, beta, c, b, sigma_s, sigma_r]."""
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    return torch.tensor([float(v) for v in (a3, a2, a1, beta, c, b, sigma_s,
                                            sigma_r)],
                        dtype=torch.float32, device=device)


def restore_tiles(tiles, coeffs: torch.Tensor, n_iter: int,
                  out: torch.Tensor | None = None,
                  ops: StageOps = KERNELS) -> torch.Tensor:
    """N blind Polyblur iterations on every tile of ``tiles``.

    :param tiles: a :class:`TileView` (tiles cut from a canvas without a
        copy) or an (N, C, ph, pw) tile batch, in the work dtype
    :param coeffs: (8,) f32 from :func:`_mega_pack`, on the tiles' device
    :param out: optional (N, C, ph, pw) destination
    :returns: the restored (N, C, ph, pw) tiles in the work dtype
    """
    view = tiles if isinstance(tiles, TileView) else TileView.of_tiles(tiles)
    ph, pw = view.patch
    data = view.data
    if out is None:
        out = torch.empty((view.n, view.channels, ph, pw), dtype=data.dtype,
                          device=data.device)
    if n_iter < 1:
        out.copy_(view.tiles())
        return out
    tables = stage_tables(ph, pw, data.dtype, str(data.device))
    src = view
    for _ in range(n_iter):
        est = ops.tile_estimate(src, coeffs)
        qhat2 = ops.kernel_spectrum(est, coeffs, tables)
        ops.spectral_poly(src, qhat2, tables, out)
        src = TileView.of_tiles(out)
    return out
