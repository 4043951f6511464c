"""The fused spectral polynomial p(K) on a plane batch with per-plane
quadratic forms: the whole-image polynomial of ``ops.sep_poly``.

Replaces polyblur_tpu/ops/pallas/sep_poly_fused.py::fused_polynomial_pallas
(its ``_make_kernel`` at :288-337): per plane, the analytic kernel spectrum
from three quadratic-form scalars, the degree-3 Horner polynomial, the six
DFT products, an optional replicate pad by the kernel half-support (with
the crop) and an optional clip to [0, 1]. The TPU holds one plane's canvas,
spectra and tables in VMEM; here it is the patch engine's kernels of
``csrc/spectral.cu`` (see ops/cuda/polyblur_fused.py), generalized:
``kernel_spectrum`` reads the (N, 3) params rows directly and takes the
kernel half-support (12, the patch engine's, is its own instantiation; any
other up to 15, as the TPU kernel's 32-column tap tables allow), and the
four ``spectral_gemm`` launches take a pad/crop width of the half-support
or 0 and a clip flag. 1 + 4 launches per application, counted as
``fused_polynomial`` (the four GEMMs as ``fused_polynomial[highest]``
under the f32 dot mode ``'highest'``).

Callers: ``ops.sep_poly._apply_param_operator`` with the replicate pad on
whole images up to a 664 px canvas, and ``ops.sep_poly._blocked_polynomial``
without it on the overlap-save blocks of larger images, cut from the
wrap-extended canvas through a :class:`TileView` (no copy).

Differentiable in x, the params and the coefficients (ROADMAP B.1 item 5,
the counterpart of the custom VJP at polyblur_tpu/ops/pallas/
sep_poly_fused.py:388-426): the backward replays autograd of
:func:`fused_polynomial_plain` on the saved inputs; a view's canvas is the
input, its geometry a constant.

Bound on the H100: operations — ~115 M MACs per 280 x 240 block of the
2 MP blocked route (180 planes, 20.6 G MACs per application), on the
tensor cores: bf16 wgmma, or for f32 three tf32 wgmma products per step
(3xTF32, the counterpart of the TPU kernel's compensated bf16 split), or
six under the f32 dot mode ``'highest'``.

The f32 dot mode (:func:`set_f32_dot_mode`, :func:`f32_dot_mode`,
:func:`f32_dot_mode_scope`; the JAX module's, sep_poly_fused.py:150-194)
selects the f32 instantiations of the tensor-core GEMMs that the JAX
package's mode selects: ``spectral_gemm`` (every f32 application of the
tiles, patch and blocked routes, and :func:`fused_polynomial`; JAX's
``_spectral_poly_block``) and the estimate's and the halo mask's
derivative GEMM on f32 tiles (JAX's ``_est_dots``,
polyblur_fused.py:251-252). ``'compensated'`` (the default) runs 3xTF32,
``'highest'`` a three-piece tf32 split with six products (each 32-deep K
stage promoted into the running sum by a rounded f32 add), as template
cases of ``csrc/spectral.cu`` and ``csrc/estimate.cu``: :func:`dot_variant`
names the instantiation. bf16 work, ``directional_maxima`` (JAX's
est_fused.py:52-56 does not read the mode), the composed route's exact
f32 ``torch.matmul`` and every plain version are the same under both.
"""

from __future__ import annotations

import contextlib

import torch

from ._build import runs_plain
from .autograd import replay
from .polyblur_fused import (HALF, TileView, launch_spectral_gemm,
                             launch_spectrum, spectral_poly_plain,
                             spectrum_plain, stage_tables)

__all__ = ["fused_polynomial", "fused_polynomial_plain", "set_f32_dot_mode",
           "f32_dot_mode", "f32_dot_mode_scope", "dot_variant", "launch_name"]

_F32_DOT_MODES = ("compensated", "highest")
_f32_dot_mode = "compensated"


def set_f32_dot_mode(mode: str) -> None:
    """Select the f32 dot mode of the kernels: ``'compensated'`` (the
    default: 3xTF32, ~2^-22 relative per product) or ``'highest'`` (six
    tf32 products of a three-piece split, f32 grade). The mode is a
    process-wide setting, not thread-safe; prefer
    :func:`f32_dot_mode_scope`.

    Unlike the JAX package, whose jitted callables keep the mode they were
    traced with (polyblur_tpu/ops/pallas/sep_poly_fused.py:168-171), the
    port reads the mode at each call: every launch after this call uses
    it."""
    global _f32_dot_mode
    if mode not in _F32_DOT_MODES:
        raise ValueError(f"unknown f32 dot mode {mode!r}; expected "
                         "'compensated' or 'highest'")
    _f32_dot_mode = mode


def f32_dot_mode() -> str:
    """The current f32 dot mode."""
    return _f32_dot_mode


@contextlib.contextmanager
def f32_dot_mode_scope(mode: str):
    """Set ``mode`` (:func:`set_f32_dot_mode`) for the block and restore
    the previous mode afterwards, also when the block raises."""
    prev = _f32_dot_mode
    set_f32_dot_mode(mode)
    try:
        yield
    finally:
        set_f32_dot_mode(prev)


def dot_variant(dtype: torch.dtype, mode_free: bool = False) -> int:
    """The instantiation of the mode-reading GEMMs for work dtype ``dtype``
    under the current f32 dot mode, as the kernels' ``high`` argument: 1
    for the ``'highest'`` case (f32 only), else 0 — the bf16 GEMMs, and the
    3xTF32 estimate of bf16 tiles, under either mode; ``mode_free`` kernels
    (``directional_maxima``) always 0."""
    return int(dtype == torch.float32 and not mode_free
               and _f32_dot_mode == "highest")


def launch_name(name: str, variant: int) -> str:
    """The launch counter of kernel ``name`` in instantiation ``variant``:
    the ``'highest'`` case counts as ``name[highest]``."""
    return f"{name}[highest]" if variant else name


def _view_and_tables(x, replicate_pad: bool, half: int):
    """(view, spectral tables) of an (N, H, W) tensor (one channel per
    plane) or a :class:`TileView`, for ``2 half + 1`` taps."""
    view = x if isinstance(x, TileView) else TileView.of_tiles(
        x.contiguous()[:, None])
    tables = stage_tables(*view.patch, view.data.dtype, str(view.data.device),
                          half if replicate_pad else 0, half)
    return view, tables


def _shape_like(out: torch.Tensor, x) -> torch.Tensor:
    return out if isinstance(x, TileView) else out[:, 0]


def fused_polynomial_plain(x, params: torch.Tensor, coeffs: torch.Tensor,
                           replicate_pad: bool = False, clip: bool = False,
                           half: int = HALF) -> torch.Tensor:
    """Plain version of :func:`fused_polynomial`: the spectrum of
    ``ops.sep_poly`` and the same four products, rounded where the kernel
    rounds."""
    view, tables = _view_and_tables(x, replicate_pad, half)
    params = params.float()
    q2 = spectrum_plain(params[:, 0], params[:, 1], params[:, 2],
                        coeffs.float(), tables)
    return _shape_like(spectral_poly_plain(view, q2, tables, clip=clip), x)


def fused_polynomial(x, params: torch.Tensor, coeffs: torch.Tensor,
                     replicate_pad: bool = False, clip: bool = False,
                     half: int = HALF) -> torch.Tensor:
    """p(K) on a plane batch.

    :param x: (N, H, W) planes in the work dtype (f32 or bf16; rectangles
        fine), or a :class:`TileView` of N tiles whose C channels share
        their tile's params
    :param params: (N, 3) f32 per-plane quadratic forms [a, b, c]
        (``ops.sep_poly.gaussian_quadratic_coeffs``)
    :param coeffs: Horner coefficients [a3, a2, a1, beta]: a (4,) vector,
        or the first four of the (8,) ``pipeline._mega_pack`` vector
    :param replicate_pad: pad by the kernel half-support before and crop
        after (whole images); else the canvas is the plane itself
        (circular, the overlap-save blocks)
    :param clip: clip the result to [0, 1]
    :param half: the kernel half-support, ``ker_size // 2`` (0 .. 15)
    :returns: same shape and dtype as ``x`` ((n, C, ph, pw) for a view)
    """
    def on(data):
        return x._replace(data=data) if isinstance(x, TileView) else data

    data = x.data if isinstance(x, TileView) else x
    return replay(
        lambda d, p, c: _fused_polynomial(on(d), p, c, replicate_pad, clip,
                                          half),
        lambda d, p, c: fused_polynomial_plain(on(d), p, c, replicate_pad,
                                               clip, half),
        data, params, coeffs)


def _fused_polynomial(x, params: torch.Tensor, coeffs: torch.Tensor,
                      replicate_pad: bool, clip: bool,
                      half: int) -> torch.Tensor:
    view, tables = _view_and_tables(x, replicate_pad, half)
    if runs_plain(view.data):
        return fused_polynomial_plain(x, params, coeffs, replicate_pad, clip,
                                      half)
    if params.shape != (view.n, 3):
        raise ValueError(f"fused_polynomial: params {tuple(params.shape)} "
                         f"for {view.n} planes")
    q2 = launch_spectrum(params, 0, coeffs, tables, "fused_polynomial")
    return _shape_like(launch_spectral_gemm(view, q2, tables, None, clip,
                                            "fused_polynomial"), x)
