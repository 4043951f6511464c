"""Windowed overlap-add of a restored tile batch into the output image.

Kernel: ``csrc/blend.cu`` (replaces the blend of polyblur_tpu/ops/pallas/
polyblur_fused.py::_make_kernel and polyblur_tpu/ops/pallas/overlap_add.py::
overlap_add_fused). Gather form: each output pixel sums its covering tiles
times the window in f32 (own tile, left, top, top-left — the TPU kernel's
order), multiplies by the host-computed reciprocal window sum, clips to
[0, 1] and writes the output dtype; the crop to the original image is
folded in. A kernel thread owns 8 output columns of a row for all
channels, with 16-byte accesses where the grid's steps, tile width and
left crop are multiples of 8 (the 12 MP main path's), and a scalar path
for the rest.

Differentiable in the tiles (the JAX package's overlap_add.py defines no
VJP; the patch route trains through this blend): the backward is a kernel
of its own, :func:`blend_overlap_add_backward` (``csrc/blend.cu``), the
gather that is the blend's adjoint, bit-equal to autograd of
:func:`blend_overlap_add_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (check, count_backward, count_launch, dtype_code,
                     library, plain_mode, runs_plain, stream_of)
from .autograd import replay

__all__ = ["blend_overlap_add", "blend_overlap_add_plain",
           "blend_overlap_add_backward"]

_I = ctypes.c_int
_P = ctypes.c_void_p


def blend_overlap_add_plain(tiles: torch.Tensor, window: torch.Tensor,
                            inv_wsum: torch.Tensor, grid_info, batch: int,
                            crop, out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`blend_overlap_add` (same summation order)."""
    th, tw, sh, sw, ph, pw = grid_info
    pt, pl, h, w = crop
    dev = tiles.device
    c = tiles.shape[1]
    t6 = tiles.reshape(th, tw, batch, c, ph, pw).float()
    Y = torch.arange(h, device=dev) + pt
    X = torch.arange(w, device=dev) + pl
    acc = torch.zeros((batch, c, h, w), dtype=torch.float32, device=dev)
    for di in range(-(-ph // sh)):
        ki = Y // sh - di
        ly = Y - ki * sh
        row_ok = (ki >= 0) & (ki < th) & (ly < ph)
        for dj in range(-(-pw // sw)):
            kj = X // sw - dj
            lx = X - kj * sw
            ok = row_ok[:, None] & ((kj >= 0) & (kj < tw) & (lx < pw))[None]
            kic, kjc = ki.clamp(0, th - 1), kj.clamp(0, tw - 1)
            lyc, lxc = ly.clamp(0, ph - 1), lx.clamp(0, pw - 1)
            v = t6[kic[:, None], kjc[None], :, :, lyc[:, None], lxc[None]]
            v = v.permute(2, 3, 0, 1) * window[lyc[:, None], lxc[None]]
            acc = acc + torch.where(ok, v, torch.zeros((), device=dev))
    out = (acc * inv_wsum[pt:pt + h, pl:pl + w]).clamp(0.0, 1.0)
    return out.to(out_dtype or tiles.dtype)


def blend_overlap_add(tiles: torch.Tensor, window: torch.Tensor,
                      inv_wsum: torch.Tensor, grid_info, batch: int, crop,
                      out_dtype=None) -> torch.Tensor:
    """Blend a (th*tw*batch, C, ph, pw) tile batch (tile-major, then image)
    into the (batch, C, h, w) output.

    :param window: (ph, pw) f32 blending window
    :param inv_wsum: (Hc, Wc) f32 reciprocal window sum over the padded
        canvas (host-computed in float64, +1e-8)
    :param grid_info: (th, tw, sh, sw, ph, pw) regular grid
    :param crop: (pt, pl, h, w): output = canvas[pt:pt+h, pl:pl+w]
    :param out_dtype: output dtype (default: the tile dtype); the blend
        always accumulates in f32
    """
    args = (window, inv_wsum, grid_info, batch, crop, out_dtype)
    if plain_mode():
        return blend_overlap_add_plain(tiles, *args)
    return replay(lambda t: _blend_overlap_add(t, *args), None, tiles,
                  backward=lambda t, g: (blend_overlap_add_backward(
                      t, window, inv_wsum, grid_info, batch, crop, g),))


def _blend_overlap_add(tiles: torch.Tensor, window: torch.Tensor,
                       inv_wsum: torch.Tensor, grid_info, batch: int, crop,
                       out_dtype=None) -> torch.Tensor:
    if runs_plain(tiles):
        return blend_overlap_add_plain(tiles, window, inv_wsum, grid_info,
                                       batch, crop, out_dtype)
    for t in (tiles, window, inv_wsum):
        if t.device.type != "cuda":
            raise ValueError(f"blend_overlap_add: expected CUDA tensors, "
                             f"got {t.device}")
    th, tw, sh, sw, ph, pw = (int(v) for v in grid_info)
    pt, pl, h, w = (int(v) for v in crop)
    c = tiles.shape[1]
    odt = out_dtype or tiles.dtype
    if tiles.shape != (th * tw * batch, c, ph, pw) or \
            window.shape != (ph, pw) or window.dtype != torch.float32 or \
            inv_wsum.dtype != torch.float32 or \
            pt + h > inv_wsum.shape[0] or pl + w > inv_wsum.shape[1]:
        raise ValueError("blend_overlap_add: shapes do not match the grid")
    if h > 65535 or batch > 65535:
        raise ValueError("blend_overlap_add: output exceeds the launch grid")
    tiles, window, inv_wsum = (t.contiguous() for t in (tiles, window,
                                                         inv_wsum))
    out = torch.empty((batch, c, h, w), dtype=odt, device=tiles.device)
    lib = library("blend")
    fn = lib.pb_blend
    fn.argtypes = [_P, _I, _P, _P, _P, _I] + [_I] * 13 + [_P]
    fn.restype = _I
    err = fn(tiles.data_ptr(), dtype_code(tiles.dtype), window.data_ptr(),
             inv_wsum.data_ptr(), out.data_ptr(), dtype_code(odt), batch, c,
             th, tw, sh, sw, ph, pw, inv_wsum.shape[1], pt, pl, h, w,
             stream_of(tiles))
    count_launch("blend_overlap_add")
    check(lib, err, "blend_overlap_add")
    return out


def blend_overlap_add_backward(tiles: torch.Tensor, window: torch.Tensor,
                               inv_wsum: torch.Tensor, grid_info,
                               batch: int, crop,
                               grad_out: torch.Tensor) -> torch.Tensor:
    """The tiles' gradient of :func:`blend_overlap_add` for the output
    gradient ``grad_out`` ((batch, C, h, w), the output dtype), in the
    tiles' dtype and shape; bit-equal to autograd of
    :func:`blend_overlap_add_plain`. The other arguments as there."""
    if runs_plain(tiles):
        with torch.enable_grad():
            t = tiles.detach().requires_grad_()
            out = blend_overlap_add_plain(t, window, inv_wsum, grid_info,
                                          batch, crop, grad_out.dtype)
            return torch.autograd.grad(out, t, grad_out)[0]
    for t in (tiles, window, inv_wsum, grad_out):
        if t.device.type != "cuda":
            raise ValueError(f"blend_overlap_add_backward: expected CUDA "
                             f"tensors, got {t.device}")
    th, tw, sh, sw, ph, pw = (int(v) for v in grid_info)
    pt, pl, h, w = (int(v) for v in crop)
    c = tiles.shape[1]
    if tiles.shape != (th * tw * batch, c, ph, pw) or \
            window.shape != (ph, pw) or window.dtype != torch.float32 or \
            inv_wsum.dtype != torch.float32 or \
            pt + h > inv_wsum.shape[0] or pl + w > inv_wsum.shape[1] or \
            grad_out.shape != (batch, c, h, w):
        raise ValueError("blend_overlap_add_backward: shapes do not match "
                         "the grid")
    if (th - 1) * sh + ph > 65535 or batch > 65535:
        raise ValueError("blend_overlap_add_backward: canvas exceeds the "
                         "launch grid")
    tiles, window, inv_wsum, grad_out = (
        t.contiguous() for t in (tiles, window, inv_wsum, grad_out))
    grad = torch.empty_like(tiles)
    lib = library("blend")
    fn = lib.pb_blend_backward
    fn.argtypes = [_P, _I, _P, _P, _P, _I, _P] + [_I] * 13 + [_P]
    fn.restype = _I
    err = fn(tiles.data_ptr(), dtype_code(tiles.dtype), window.data_ptr(),
             inv_wsum.data_ptr(), grad_out.data_ptr(),
             dtype_code(grad_out.dtype), grad.data_ptr(), batch, c, th, tw,
             sh, sw, ph, pw, inv_wsum.shape[1], pt, pl, h, w,
             stream_of(tiles))
    count_backward("blend_overlap_add")
    check(lib, err, "blend_overlap_add_backward")
    return grad
