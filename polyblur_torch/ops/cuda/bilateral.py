"""The 5 x 5 bilateral filter over a batch of (tile, channel) planes.

Kernel: ``csrc/bilateral.cu`` (replaces polyblur_tpu/ops/pallas/
bilateral.py::bilateral_pallas and the bilateral prefilter stage of the
mega kernel, polyblur_fused.py:475-478). One launch, counted as
``bilateral``, serves ``ops.bilateral.bilateral_filter`` (whole images of
any size, output in the input dtype) and the tiles route's prefilter
(``smooth`` and ``noise = x - smooth`` in f32, read from the tiles through
a :class:`TileView`). Bound on the H100: operations; the kernel spends
one exponential per neighbour pair (12 per pixel, the MUFU's ex2), see
the source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..bilateral import _bilateral_plain, spatial_weights
from ._build import (check, check_cuda, count_launch, dtype_code, library,
                     runs_plain, stream_of)
from .polyblur_fused import _VIEW_ARGTYPES, TileView

__all__ = ["bilateral", "bilateral_plain"]

_I = ctypes.c_int
_P = ctypes.c_void_p


def bilateral_plain(view: TileView, ksize: int = 5,
                    sigma_spatial: float = 5.0, sigma_color: float = 0.1,
                    out_dtype: torch.dtype | None = None,
                    with_noise: bool = False):
    """Plain version of :func:`bilateral`."""
    x = view.tiles()
    smooth = _bilateral_plain(x.float(), ksize, sigma_spatial, sigma_color)
    out = smooth.to(out_dtype or x.dtype)
    if with_noise:
        return out, x.float() - smooth
    return out


def bilateral(view: TileView, ksize: int = 5, sigma_spatial: float = 5.0,
              sigma_color: float = 0.1, out_dtype: torch.dtype | None = None,
              with_noise: bool = False):
    """Bilateral filter of the (n, C, H, W) tiles of ``view`` (f32 or bf16).

    :param out_dtype: dtype of the smoothed planes (default: the tiles')
    :param with_noise: also return ``noise = x - smooth`` in f32 (from the
        f32 smoothed value, before its cast)
    :returns: smooth (n, C, H, W), or (smooth, noise)
    """
    if runs_plain(view.data):
        return bilateral_plain(view, ksize, sigma_spatial, sigma_color,
                               out_dtype, with_noise)
    check_cuda("bilateral", view.data)
    if ksize != 5:
        raise ValueError(f"the bilateral kernel is 5 x 5, got ksize={ksize}")
    odt = out_dtype or view.data.dtype
    h, w = view.patch
    c = view.channels
    dev = view.data.device
    smooth = torch.empty((view.n, c, h, w), dtype=odt, device=dev)
    noise = (torch.empty((view.n, c, h, w), dtype=torch.float32, device=dev)
             if with_noise else None)
    gw = spatial_weights(ksize, sigma_spatial).reshape(-1)
    inv_var2 = float(np.float32(1.0 / (2.0 * sigma_color * sigma_color)))
    lib = library("bilateral")
    fn = lib.pb_bilateral
    fn.argtypes = ([_I] + _VIEW_ARGTYPES + [_I] * 4
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_float, _I]
                   + [_P] * 3)
    fn.restype = _I
    err = fn(dtype_code(view.data.dtype), *view.c_args(), view.n, c, h, w,
             gw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), inv_var2,
             dtype_code(odt), smooth.data_ptr(),
             None if noise is None else noise.data_ptr(), stream_of(smooth))
    count_launch("bilateral")
    check(lib, err, "bilateral")
    return (smooth, noise) if with_noise else smooth
