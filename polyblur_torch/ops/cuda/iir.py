"""The domain transform's recursive filter: the bidirectional first-order
IIR along rows and along columns, and the tiles route's coefficient maps.

Kernels: ``csrc/iir.cu``.

* :func:`scan_rows` — replaces polyblur_tpu/ops/pallas/iir.py::
  iir_scan_rows_pallas (a warp takes the planes sharing one map, a lane a
  run of 16 elements; rows past 512 are split over the warps of a block);
* :func:`scan_cols` — the same recurrence down the columns (a block per
  strip of 32 columns, chunks of 32 rows scanned through shared memory),
  in place of the JAX code's swapaxes + row scan; it can also write the
  prefilter's ``noise = x - smooth``;
* :func:`dt_scan_rows` — the mega kernel's dt prefilter state
  (polyblur_fused.py:436-455) folded into the row pass: per tile, the
  joint-image derivatives over its channels, the feedback maps ``v =
  exp(dH * (-sqrt 2 / sigma_s))`` of one iteration, and the row pass with
  ``v_h`` in one launch, in the PR 3 kernel's scan order (bit-equal to
  the two launches it replaces); it returns the rows and ``v_v`` for
  :func:`scan_cols`.

The scans count as ``iir_scan_rows``, the dt stage's row pass as
``dt_scan_rows``. Both scans are differentiable in the signal and in ``v``
(ROADMAP B.1 item 8): each is an autograd Function (``autograd.replay``)
whose backward runs autograd of its plain version, as ``_iir_pallas``'s
custom VJP replays the associative scan (iir.py:110-127).
``dt_scan_rows`` serves the tiles route's forward only. The plain
versions run the TPU kernel's algorithm: the Hillis-Steele affine prefix
and suffix compositions of iir.py:47-73, log2(W) shifted tensor steps. The
kernels compose in other orders (the row pass in runs of 16 under a
32-lane scan; the dt stage's rows and the columns in chunks of 32), which
round differently; the recurrence contracts (``v <= exp(-sqrt 2 / sigma)
< 1``), so they agree to ~1e-6 (tests hold 1e-5).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import (check, check_cuda, count_launch, dtype_code, library,
                     runs_plain, stream_of)
from .autograd import records_graph, replay
from .polyblur_fused import _NULL_VIEW_ARGS, _VIEW_ARGTYPES, TileView

__all__ = ["iir_scan_rows_plain", "scan_rows", "scan_rows_plain",
           "scan_cols", "scan_cols_plain", "dt_scan_rows",
           "dt_scan_rows_plain", "dt_coeffs_plain"]

_I = ctypes.c_int
_P = ctypes.c_void_p


def _shift(v: torch.Tensor, k: int, fill: float, right: bool) -> torch.Tensor:
    """v shifted by k along the last axis, the vacated entries ``fill``."""
    pad = torch.full_like(v[..., :k], fill)
    if right:
        return torch.cat([pad, v[..., :-k]], -1)
    return torch.cat([v[..., k:], pad], -1)


def _affine_scan(a: torch.Tensor, b: torch.Tensor, reverse: bool):
    """Inclusive prefix (or, reversed, suffix) composition of the affine
    maps (a, b) along the last axis: iir.py:47-73."""
    w = a.shape[-1]
    step = 1
    while step < w:
        a_o = _shift(a, step, 1.0, not reverse)
        b_o = _shift(b, step, 0.0, not reverse)
        b = a * b_o + b
        a = a * a_o
        step *= 2
    return a, b


def iir_scan_rows_plain(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional IIR along the last axis, in f32 (iir.py:76-90):

    forward  y[i] = (1 - v[i]) x[i] + v[i] y[i-1]       (v[0] := 0)
    backward z[i] = (1 - v[i+1]) y[i] + v[i+1] z[i+1]   (v[W] := 0)

    :param x: (..., W); :param v: broadcastable to x, in [0, 1)
    """
    x = x.float()
    v = v.float().expand(x.shape)
    col = torch.arange(x.shape[-1], device=x.device)
    vf = torch.where(col == 0, torch.zeros_like(v), v)
    _, y = _affine_scan(vf, (1.0 - vf) * x, reverse=False)
    vs = torch.where(col == x.shape[-1] - 1, torch.zeros_like(v),
                     _shift(v, 1, 0.0, right=False))
    _, z = _affine_scan(vs, (1.0 - vs) * y, reverse=True)
    return z


def _planes_v(v: torch.Tensor, planes: int, h: int, w: int):
    """(v as contiguous f32 (m, h, w), vdiv): ``planes / m`` planes share
    one map."""
    v = v.float().reshape(-1, h, w).contiguous()
    if planes % v.shape[0]:
        raise ValueError(f"{v.shape[0]} coefficient maps for {planes} planes")
    return v, planes // v.shape[0]


def _per_plane(v: torch.Tensor, shape) -> torch.Tensor:
    """The maps ``v`` repeated for the planes of a (n, C, H, W) ``shape``
    (``repeat_interleave`` by expansion: its backward sums by reduction,
    not by the atomics of ``index_select``'s)."""
    n, c, h, w = shape
    v, vdiv = _planes_v(v, n * c, h, w)
    m = v.shape[0]
    return v[:, None].expand(m, vdiv, h, w).reshape(shape)


def scan_rows_plain(view: TileView, v: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scan_rows`."""
    x = view.tiles().float()
    return iir_scan_rows_plain(x, _per_plane(v, x.shape))


def scan_rows(view: TileView, v: torch.Tensor) -> torch.Tensor:
    """The bidirectional IIR along the rows of the (n, C, H, W) tiles of
    ``view`` (f32 or bf16) with feedback maps ``v``: (n C, H, W), or
    (n, H, W) shared by a tile's channels, or anything reshaping to (m, H,
    W) with m dividing n C. Returns (n, C, H, W) f32, differentiable in
    the tiles and in ``v``."""
    return replay(lambda d, vv: _scan_rows(view._replace(data=d), vv),
                  lambda d, vv: scan_rows_plain(view._replace(data=d), vv),
                  view.data, v)


def _scan_rows(view: TileView, v: torch.Tensor) -> torch.Tensor:
    if runs_plain(view.data):
        return scan_rows_plain(view, v)
    check_cuda("iir_scan_rows", view.data, v)
    h, w = view.patch
    c = view.channels
    v, vdiv = _planes_v(v, view.n * c, h, w)
    out = torch.empty((view.n, c, h, w), dtype=torch.float32,
                      device=view.data.device)
    lib = library("iir")
    fn = lib.pb_iir_rows
    fn.argtypes = [_I] + _VIEW_ARGTYPES + [_I] * 4 + [_P, _I, _P, _P]
    fn.restype = _I
    err = fn(dtype_code(view.data.dtype), *view.c_args(), view.n, c, h, w,
             v.data_ptr(), vdiv, out.data_ptr(), stream_of(out))
    count_launch("iir_scan_rows")
    check(lib, err, "iir_scan_rows (rows)")
    return out


def scan_cols_plain(x: torch.Tensor, v: torch.Tensor,
                    src: TileView | None = None):
    """Plain version of :func:`scan_cols`: the JAX code's swapaxes, row
    scan, swapaxes (not in place)."""
    vx = _per_plane(v, x.shape)
    out = iir_scan_rows_plain(x.transpose(-1, -2),
                              vx.transpose(-1, -2)).transpose(-1, -2)
    out = out.contiguous()
    if src is None:
        return out
    return out, src.tiles().float() - out


def scan_cols(x: torch.Tensor, v: torch.Tensor,
              src: TileView | None = None):
    """The bidirectional IIR down the columns of the (n, C, H, W) f32
    tensor ``x``, in place unless autograd records ``x`` (then into a
    copy); ``v`` as for :func:`scan_rows`. Differentiable in ``x``, ``v``
    and the tiles of ``src``.

    :param src: when given, the (n, C, H, W) tiles the prefilter smoothed;
        then also returns ``noise = src - out`` in f32
    :returns: out (on the card without a graph, ``x`` itself), or (out,
        noise)
    """
    inputs = (x, v) if src is None else (x, v, src.data)
    graph = records_graph(*inputs)

    def kernel(t, vv, *d):
        return _scan_cols(t.clone() if graph else t, vv,
                          src._replace(data=d[0]) if d else None)

    def plain(t, vv, *d):
        return scan_cols_plain(t, vv, src._replace(data=d[0]) if d else None)

    return replay(kernel, plain, *inputs)


def _scan_cols(x: torch.Tensor, v: torch.Tensor, src: TileView | None):
    if runs_plain(x):
        return scan_cols_plain(x, v, src)
    check_cuda("iir_scan_rows", x, v)
    n, c, h, w = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("scan_cols takes a contiguous f32 (n, C, H, W)")
    v, vdiv = _planes_v(v, n * c, h, w)
    noise = None
    src_args, src_dt = _NULL_VIEW_ARGS, torch.float32
    if src is not None:
        if (src.n, src.channels) + src.patch != (n, c, h, w):
            raise ValueError("scan_cols: src does not match x")
        noise = torch.empty_like(x)
        src_args, src_dt = src.c_args(), src.data.dtype
    lib = library("iir")
    fn = lib.pb_iir_cols
    fn.argtypes = ([_P, _I, _I, _I, _P, _I, _P, _I] + _VIEW_ARGTYPES
                   + [_I, _P, _P])
    fn.restype = _I
    err = fn(x.data_ptr(), n * c, h, w, v.data_ptr(), vdiv, x.data_ptr(),
             dtype_code(src_dt), *src_args, c,
             None if noise is None else noise.data_ptr(), stream_of(x))
    count_launch("iir_scan_rows")
    check(lib, err, "iir_scan_rows (columns)")
    return x if src is None else (x, noise)


def dt_coeffs_plain(view: TileView, coeffs: torch.Tensor):
    """The (n, H, W) f32 feedback maps (v_h, v_v) of one domain-transform
    iteration (sigma_H = sigma_s) of each tile of ``view``, from its
    channels' summed absolute differences, in the TPU kernel's order;
    ``coeffs`` is the (8,) ``pipeline._mega_pack`` vector (sigma_s,
    sigma_r at 6, 7)."""
    f = view.tiles().float()
    n, c, h, w = f.shape
    dx = torch.zeros((n, h, w - 1), dtype=torch.float32, device=f.device)
    dy = torch.zeros((n, h - 1, w), dtype=torch.float32, device=f.device)
    for ch in range(c):
        dx = dx + torch.abs(f[:, ch, :, 1:] - f[:, ch, :, :-1])
        dy = dy + torch.abs(f[:, ch, 1:, :] - f[:, ch, :-1, :])
    coeffs = coeffs.float()
    ratio = coeffs[6] / coeffs[7]
    log_a = torch.tensor(-math.sqrt(2.0), dtype=torch.float32,
                         device=f.device) / coeffs[6]
    zero = f.new_zeros(())
    dh = torch.cat([zero.expand(n, h, 1), ratio * dx], -1) + 1.0
    dv = torch.cat([zero.expand(n, 1, w), ratio * dy], -2) + 1.0
    # exp in float64 (see ops.sep_poly.gaussian_taps)
    return (torch.exp((dh * log_a).double()).float(),
            torch.exp((dv * log_a).double()).float())


def dt_scan_rows_plain(view: TileView, coeffs: torch.Tensor):
    """Plain version of :func:`dt_scan_rows`: :func:`dt_coeffs_plain`, then
    :func:`scan_rows_plain` with v_h."""
    v_h, v_v = dt_coeffs_plain(view, coeffs)
    return scan_rows_plain(view, v_h), v_v


#: Widest tile :func:`dt_scan_rows` launches for (csrc/iir.cu: one span of
#: 8 warps of 512 elements); the staged route's dt tiles are <= 512.
DT_MAX_WIDTH = 4096


def dt_scan_rows(view: TileView, coeffs: torch.Tensor):
    """The dt prefilter's maps and row pass of each tile of ``view`` (f32
    or bf16, (n, C, H, W) tiles) in one launch: ``rows``, the row pass of
    the tiles with the row map v_h (which stays on chip), (n, C, H, W) f32,
    and ``v_v``, the (n, H, W) f32 column map for :func:`scan_cols`.
    ``coeffs`` is the (8,) ``pipeline._mega_pack`` vector (sigma_s,
    sigma_r read on the card at 6, 7). Forward only."""
    if runs_plain(view.data):
        return dt_scan_rows_plain(view, coeffs)
    check_cuda("dt_scan_rows", view.data, coeffs)
    h, w = view.patch
    if w > DT_MAX_WIDTH:
        raise ValueError(f"dt_scan_rows: tiles {w} wide, the kernel takes "
                         f"at most {DT_MAX_WIDTH}")
    c = view.channels
    dev = view.data.device
    rows = torch.empty((view.n, c, h, w), dtype=torch.float32, device=dev)
    v_v = torch.empty((view.n, h, w), dtype=torch.float32, device=dev)
    coeffs = coeffs.float().contiguous()
    lib = library("iir")
    fn = lib.pb_dt_rows
    fn.argtypes = [_I] + _VIEW_ARGTYPES + [_I] * 4 + [_P] * 4
    fn.restype = _I
    err = fn(dtype_code(view.data.dtype), *view.c_args(), view.n, c, h, w,
             coeffs.data_ptr(), rows.data_ptr(), v_v.data_ptr(),
             stream_of(rows))
    count_launch("dt_scan_rows")
    check(lib, err, "dt_scan_rows")
    return rows, v_v
