"""The edgetaper and halo stages of the mega kernel's feature flags, over a
tile batch.

* :func:`taper_weights` — ``csrc/features.cu``: the per-tile taper
  vectors (av, ah) of the estimated kernel (polyblur_fused.py:378-433);
  counted as ``taper``. Each of the three blends ``xc = a u + (1 - a) Ku``
  with ``a = av[i] ah[j]`` (:493-498) runs in the epilogue of its blur's
  last product (``spectral_poly(..., taper=(av, ah))``, counted as
  ``spectral_gemm``).
* :func:`halo_grads`, :func:`halo_mask` — ``csrc/estimate.cu``'s
  derivative GEMM pair with two more epilogues: the input tiles' gradients
  and their per-plane |grad|^2 sums once per call, then per iteration the
  gradient-inversion mask of the output, its clip, the prefilter's noise
  and the store in the work dtype (polyblur_fused.py:288-302, :503-517);
  counted as ``halo`` (``halo[highest]`` in the f32 dot mode's
  ``'highest'`` case, which an f32 work dtype takes under that mode).

Each has a plain version beside it that computes what the TPU kernel
computes, in its order; the wrappers take it for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..spectral_matmul import require_full_f32
from ._build import (check, check_cuda, count_launch, dtype_code, library,
                     runs_plain, stream_of)
from .polyblur_fused import (HALF, _NULL_VIEW_ARGS, _VIEW_ARGTYPES, TileView,
                             estimate_tables)
from .sep_poly_fused import dot_variant, launch_name

__all__ = ["taper_weights", "taper_weights_plain", "HaloGrads",
           "halo_grads", "halo_grads_plain", "halo_mask", "halo_mask_plain"]

_I = ctypes.c_int
_P = ctypes.c_void_p
_TAPS = 2 * HALF + 1
_EB = 64             # output block edge of the estimate GEMM (estimate.cu)


# ------------------------------------------------------------------ taper

def _lag_autocorr(p: torch.Tensor) -> torch.Tensor:
    """(n, 25) linear autocorrelations of the (n, 25) projections at lags
    0..24 (zeros past the support)."""
    return torch.stack([(p[:, :_TAPS - d] * p[:, d:]).sum(-1)
                        for d in range(_TAPS)], -1)


def _taper_vector(ac: torch.Tensor, length: int) -> torch.Tensor:
    """(n, length) ``1 - z / ac[0]`` with z[i] = ac[d] where i == d or
    i == length - 1 - d (the TPU kernel's scatter of the 25 lags)."""
    idx = torch.arange(length, device=ac.device)
    z = torch.zeros((ac.shape[0], length), dtype=torch.float32,
                    device=ac.device)
    for d in range(_TAPS):
        m = ((idx == d) | (idx == length - 1 - d)).float()
        z = z + ac[:, d:d + 1] * m
    return 1.0 - z / ac[:, :1]


def taper_weights_plain(est: torch.Tensor, h: int, wc: int):
    """Plain version of :func:`taper_weights`."""
    qa, qb, qc = (est[:, k, None, None].float() for k in (5, 6, 7))
    t = torch.arange(-HALF, HALF + 1, dtype=torch.float32, device=est.device)
    tf, jf = t[None, None, :], t[None, :, None]     # column t, row j

    def taps(a, c):
        quad = a * tf * tf + 2.0 * qb * tf * jf + c * jf * jf
        # exp in float64 (see ops.sep_poly.gaussian_taps)
        return torch.exp((-0.5 * quad).double()).float()

    k2d, k2dt = taps(qa, qc), taps(qc, qa)
    total = k2d.sum((-2, -1), keepdim=True)[:, 0]
    px = k2d.sum(-2) / total                         # x-projection (n, 25)
    py = k2dt.sum(-2) / total                        # y-projection
    return (_taper_vector(_lag_autocorr(py), h),
            _taper_vector(_lag_autocorr(px), wc))


def taper_weights(est: torch.Tensor, h: int, wc: int):
    """The taper vectors of each tile's estimated kernel.

    :param est: (n, 8) f32 rows of ``tile_estimate`` (qa, qb, qc at 5-7)
    :param h, wc: the (padded) canvas the taper blends
    :returns: (av (n, h), ah (n, wc)) f32, the weight map being
        ``av[:, :, None] * ah[:, None, :]``
    """
    if runs_plain(est):
        return taper_weights_plain(est, h, wc)
    check_cuda("taper", est)
    est = est.float().contiguous()
    n = est.shape[0]
    av = torch.empty((n, h), dtype=torch.float32, device=est.device)
    ah = torch.empty((n, wc), dtype=torch.float32, device=est.device)
    lib = library("features")
    fn = lib.pb_taper_weights
    fn.argtypes = [_P] + [_I] * 5 + [_P] * 3
    fn.restype = _I
    err = fn(est.data_ptr(), est.shape[1], 5, n, h, wc, av.data_ptr(),
             ah.data_ptr(), stream_of(est))
    count_launch("taper")
    check(lib, err, "taper weights")
    return av, ah


# ------------------------------------------------------------------- halo

class HaloGrads(NamedTuple):
    """The input tiles' gradients of the halo mask."""
    gx: torch.Tensor     # (n, C, ph, pw) f32
    gy: torch.Tensor     # (n, C, ph, pw) f32
    part: torch.Tensor   # (n C, k) f32: nM of a plane = the sum of its row


def _derivatives(x: torch.Tensor):
    """(x Dw^T, Dh x) in full f32 with the estimate's derivative tables."""
    t = estimate_tables(x.shape[-2], x.shape[-1], str(x.device))
    return x @ t.dw.T, t.dh @ x


def halo_grads_plain(view: TileView) -> HaloGrads:
    """Plain version of :func:`halo_grads`."""
    require_full_f32(view.data)
    gx, gy = _derivatives(view.tiles().float())
    nm = (gx * gx + gy * gy).sum((-2, -1)).reshape(-1, 1)
    return HaloGrads(gx, gy, nm)


def _blocks(ph: int, pw: int) -> int:
    return -(-ph // _EB) * -(-pw // _EB)


def _halo_launch(epi: int, src: TileView, grads: HaloGrads,
                 ucmp: TileView | None = None, noise=None, out=None) -> None:
    """Epilogue ``epi`` of the halo's GEMM; the f32 dot mode's instantiation
    follows the work dtype (the input tiles', or the mask's ``out``)."""
    ph, pw = src.patch
    c = src.channels
    variant = dot_variant(src.data.dtype if out is None else out.dtype)
    t = estimate_tables(ph, pw, str(src.data.device), pieces=2 + variant)
    uargs, udt = _NULL_VIEW_ARGS, torch.float32
    odt = torch.float32
    if ucmp is not None:
        uargs, udt, odt = ucmp.c_args(), ucmp.data.dtype, out.dtype
    lib = library("estimate")
    fn = lib.pb_halo_gemm
    fn.argtypes = ([_I, _I] + _VIEW_ARGTYPES + [_I] * 4 + [_P] * 5 + [_I]
                   + _VIEW_ARGTYPES + [_P, _P, _I, _I, _P])
    fn.restype = _I
    err = fn(epi, dtype_code(src.data.dtype), *src.c_args(), src.n, c, ph,
             pw, t.dw2.data_ptr(), t.dh2.data_ptr(), grads.gx.data_ptr(),
             grads.gy.data_ptr(), grads.part.data_ptr(), dtype_code(udt),
             *uargs, None if noise is None else noise.data_ptr(),
             None if out is None else out.data_ptr(), dtype_code(odt),
             variant, stream_of(grads.gx))
    count_launch(launch_name("halo", variant))
    check(lib, err, f"halo epilogue {epi}")


def halo_grads(view: TileView) -> HaloGrads:
    """The gradients (gx, gy) of the (n, C, ph, pw) tiles of ``view``
    (f32 or bf16, read in f32) and their per-plane sums of gx^2 + gy^2,
    for :func:`halo_mask`; computed once per call from the input tiles."""
    if runs_plain(view.data):
        return halo_grads_plain(view)
    check_cuda("halo", view.data)
    ph, pw = view.patch
    c = view.channels
    dev = view.data.device
    gx = torch.empty((view.n, c, ph, pw), dtype=torch.float32, device=dev)
    grads = HaloGrads(gx, torch.empty_like(gx),
                      torch.empty((view.n * c, _blocks(ph, pw)),
                                  dtype=torch.float32, device=dev))
    _halo_launch(1, view, grads)
    return grads


def halo_mask_plain(o: torch.Tensor, grads: HaloGrads, ucmp: TileView,
                    noise: torch.Tensor | None,
                    out: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`halo_mask` (polyblur_fused.py:503-517)."""
    require_full_f32(o)
    gox, goy = _derivatives(o)
    nm = grads.part.sum(-1).reshape(o.shape[:2] + (1, 1))
    m = -(grads.gx * gox) - (grads.gy * goy)
    z = torch.clamp(m / (nm + m + 1e-12), min=0.0)
    u = ucmp.tiles().float()
    v = (o + z * (u - o)).clamp(0.0, 1.0)
    if noise is not None:
        v = (v + noise).clamp(0.0, 1.0)
    out.copy_(v.to(out.dtype))
    return out


def halo_mask(o: torch.Tensor, grads: HaloGrads, ucmp: TileView,
              noise: torch.Tensor | None, out: torch.Tensor) -> torch.Tensor:
    """Gradient-inversion masking of the restored planes, then the clip,
    the prefilter's noise and the store:

        M = -(gx0 gox) - (gy0 goy),  z = max(M / (nM + M + 1e-12), 0)
        out = clip(clip(o + z (u - o)) + noise)

    :param o: (n, C, ph, pw) f32 restored (unclipped) planes
    :param grads: :func:`halo_grads` of the call's input tiles
    :param ucmp: the planes the restoration started from (the taper's
        cropped canvas, the smoothed planes, or the iterate)
    :param noise: (n, C, ph, pw) f32 or None
    :param out: (n, C, ph, pw) destination in the work dtype (it may be
        the tensor ``ucmp`` reads)
    """
    if runs_plain(o):
        return halo_mask_plain(o, grads, ucmp, noise, out)
    check_cuda("halo", o, ucmp.data, out)
    n, c, ph, pw = o.shape
    if (o.dtype != torch.float32 or not o.is_contiguous()
            or out.shape != o.shape or not out.is_contiguous()
            or grads.gx.shape != o.shape
            or grads.part.shape != (n * c, _blocks(ph, pw))
            or (ucmp.n, ucmp.channels) + ucmp.patch != o.shape
            or (noise is not None and (noise.shape != o.shape
                                       or not noise.is_contiguous()))):
        raise ValueError("halo mask: shapes do not match")
    _halo_launch(2, TileView.of_tiles(o), grads, ucmp, noise, out)
    return out
