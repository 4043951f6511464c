"""Fused even-crop + replicate edge-pad + dtype cast onto the tile canvas.

Kernel: ``csrc/pad_cast.cu`` (replaces polyblur_tpu/ops/pallas/pad_cast.py::
edge_pad_cast): bands of canvas rows, 16-byte stores and loads. The patch
engine's ingest: the f32 -> work-dtype cast rides the pad's single pass
over device memory. Replicate padding commutes with an
elementwise cast, so the result is bit-identical to
``F.pad(x.to(dtype), mode='replicate')``.

Differentiable (ROADMAP B.1 item 1, the counterpart of the custom VJP at
polyblur_tpu/ops/pallas/pad_cast.py:120-160): the backward replays
autograd of :func:`edge_pad_cast_plain`, the transpose of replicate-pad +
cast, which sums each border's cotangent into its edge pixel (by
reductions: ``utils.imaging.replicate_pad``).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.imaging import replicate_pad
from ._build import (check, count_launch, dtype_code, library, runs_plain,
                     stream_of)
from .autograd import replay

__all__ = ["edge_pad_cast", "edge_pad_cast_plain"]

_I = ctypes.c_int
_P = ctypes.c_void_p


def edge_pad_cast_plain(x: torch.Tensor, crop_hw, pads,
                        out_dtype=None) -> torch.Tensor:
    """Plain version: ``x[..., :h, :w]`` replicate-padded by
    ``pads = (top, bottom, left, right)`` and cast to ``out_dtype``."""
    h, w = crop_hw
    pt, pb, pl, pr = pads
    odt = out_dtype or x.dtype
    return replicate_pad(x[..., :h, :w].float(), (pl, pr, pt, pb)).to(odt)


def edge_pad_cast(x: torch.Tensor, crop_hw, pads,
                  out_dtype=None) -> torch.Tensor:
    """(B, C, H, W) image -> (B, C, h+pt+pb, w+pl+pr) canvas in ``out_dtype``
    (default: the input dtype), where (h, w) = ``crop_hw`` <= (H, W) is the
    even-crop. CPU tensors take :func:`edge_pad_cast_plain`; CUDA tensors
    launch the kernel."""
    return replay(lambda t: _edge_pad_cast(t, crop_hw, pads, out_dtype),
                  lambda t: edge_pad_cast_plain(t, crop_hw, pads, out_dtype),
                  x)


def _edge_pad_cast(x: torch.Tensor, crop_hw, pads,
                   out_dtype=None) -> torch.Tensor:
    if runs_plain(x):
        return edge_pad_cast_plain(x, crop_hw, pads, out_dtype)
    if x.device.type != "cuda" or x.dim() != 4:
        raise ValueError(f"edge_pad_cast takes a (B, C, H, W) CPU or CUDA "
                         f"tensor, got {tuple(x.shape)} on {x.device}")
    h, w = crop_hw
    pt, pb, pl, pr = (int(p) for p in pads)
    if min(pt, pb, pl, pr) < 0 or h > x.shape[2] or w > x.shape[3]:
        raise ValueError(f"bad crop {crop_hw} / pads {pads} for "
                         f"{tuple(x.shape)}")
    odt = out_dtype or x.dtype
    x = x.contiguous()
    b, c, H_in, W_in = x.shape
    Hp, Wp = h + pt + pb, w + pl + pr
    out = torch.empty((b, c, Hp, Wp), dtype=odt, device=x.device)
    lib = library("pad_cast")
    fn = lib.pb_edge_pad_cast
    fn.argtypes = [_P, _I, _P, _I] + [_I] * 9 + [_P]
    fn.restype = _I
    err = fn(x.data_ptr(), dtype_code(x.dtype), out.data_ptr(),
             dtype_code(odt), b * c, H_in, W_in, h, w, pt, pl, Hp, Wp,
             stream_of(x))
    count_launch("edge_pad_cast")
    check(lib, err, "edge_pad_cast")
    return out
