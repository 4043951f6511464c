"""Gastal-Oliveira domain transform: the edge-aware smoothers of the
prefilter (port of polyblur_tpu/ops/domain_transform.py; reference
domain_transform.py:6-85 and domain_transform/NC.cpp:143-204).

The recurrence ``y[i] = (1 - V[i]) x[i] + V[i] y[i-1]`` runs forward and
backward along the rows, then along the columns, per iteration. On the card
both passes are the hand-written kernels of ``ops/cuda/iir.py``
(``csrc/iir.cu``): the row pass replaces ``iir_scan_rows_pallas`` and the
column pass the JAX code's swapaxes + row scan, so the vertical
derivatives stay in the (B, H, W) layout here. The JAX package's
``IIR_MAX_EDGE`` was a TPU VMEM limit; the kernels serve every size.

:func:`normalized_convolution` (``smoother='nc'``; no TPU kernel) is plain
PyTorch: a normalized box filter in the transformed domain, along the rows
then the columns, per iteration. A Python-number radius takes the
gather-free windowed form (a masked sum over ``2 ceil(r) + 1`` shifts), a
tensor radius (a ``sigma_s`` in the autograd graph) the summed-area table
with ``torch.searchsorted`` box bounds, as the JAX package chooses
(recorded as ``nc_box_filter`` / ``windowed`` or ``searchsorted``).

Differentiable in the image, the joint image and ``sigma_s`` / ``sigma_r``
(Python numbers or 0-d tensors, kept in the graph as the JAX package keeps
its traced sigmas): the scans are autograd Functions whose backward
replays their plain versions (the counterpart of ``_iir_pallas``'s VJP,
polyblur_tpu/ops/pallas/iir.py:110-127).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import record_dispatch
from .cuda.iir import scan_cols, scan_rows
from .cuda.polyblur_fused import TileView

__all__ = ["recursive_filter", "iir_scan_rows", "normalized_convolution"]


def iir_scan_rows(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional first-order IIR along the last axis (JAX
    ``iir_scan_rows`` semantics, computed in f32, returned in x's dtype):

    forward  y[i] = (1 - v[i]) x[i] + v[i] y[i-1]       (v[0] := 0)
    backward z[i] = (1 - v[i+1]) y[i] + v[i+1] z[i+1]   (v[W] := 0)

    :param x: (..., H, W) signal rows (or (W,))
    :param v: broadcastable to x, feedback coefficients in [0, 1)
    """
    shape = x.shape
    h, w = (shape[-2], shape[-1]) if x.dim() >= 2 else (1, shape[-1])
    x4 = x.contiguous().reshape(-1, 1, h, w)
    v3 = v.expand(shape).reshape(-1, h, w)
    return scan_rows(TileView.of_tiles(x4), v3).reshape(shape).to(x.dtype)


def _f32(v) -> torch.Tensor:
    """A Python number as a 0-d f32 tensor; a tensor cast to f32, in the
    graph."""
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.tensor(v, dtype=torch.float32)


def _domain_transform_derivatives(J: torch.Tensor, sigma_s, sigma_r):
    """(dHdx, dVdy), each (B, H, W), from the joint image
    (domain_transform.py:27-38), in the dtype the JAX package computes
    them in: J's when the sigmas are Python numbers (weakly typed there),
    at least f32 when either is a tensor. Unlike the JAX package, dVdy is
    not transposed: the column pass reads it as it is."""
    if isinstance(sigma_s, torch.Tensor) or isinstance(sigma_r,
                                                        torch.Tensor):
        ratio = _f32(sigma_s).to(J.device) / _f32(sigma_r).to(J.device)
        J = J.to(torch.promote_types(J.dtype, torch.float32))
    else:
        ratio = torch.tensor(np.float32(sigma_s) / np.float32(sigma_r),
                             device=J.device).to(J.dtype)
    didx = torch.abs(torch.diff(J, dim=-1)).sum(1)          # (B, H, W-1)
    didx = torch.nn.functional.pad(didx, (1, 0))
    didy = torch.abs(torch.diff(J, dim=-2)).sum(1)          # (B, H-1, W)
    didy = torch.nn.functional.pad(didy, (0, 0, 1, 0))
    return 1.0 + ratio * didx, 1.0 + ratio * didy


def _sigma_schedule(sigma_s, num_iterations: int):
    """Per-iteration sigma_H_i (Gastal eq. 14; domain_transform.py:50):
    Python numbers for a Python sigma_s, f32 tensors in the graph for a
    tensor one."""
    n = num_iterations
    return [sigma_s * math.sqrt(3.0) * 2.0 ** (n - (i + 1))
            / math.sqrt(4.0 ** n - 1.0) for i in range(n)]


def recursive_filter(img: torch.Tensor, sigma_s=60.0, sigma_r=0.4,
                     num_iterations: int = 3,
                     joint_image=None) -> torch.Tensor:
    """Edge-aware recursive smoothing (RF variant) of a (B, C, H, W)
    batch, guided by ``joint_image`` (default: the image itself).

    Per iteration i the feedback ``a_i = exp(-sqrt 2 / sigma_H_i)`` is
    raised to the domain-transform derivatives, ``V = a_i ** dHdx`` along
    the rows and ``a_i ** dVdy`` down the columns, shared by the channels.
    ``sigma_s`` and ``sigma_r`` are Python numbers or 0-d tensors.
    """
    record_dispatch("recursive_filter", "cuda")
    J = img if joint_image is None else joint_image
    # in f32, as the JAX pipeline divides its traced sigmas
    dhdx, dvdy = _domain_transform_derivatives(J.float(), sigma_s, sigma_r)
    F = img
    for sigma_h in _sigma_schedule(sigma_s, num_iterations):
        a = torch.exp(-math.sqrt(2.0) / _f32(sigma_h)).to(img.device)
        # pow in float64 (see ops.sep_poly.gaussian_taps)
        v_h = (a.double() ** dhdx.double()).float()
        v_v = (a.double() ** dvdy.double()).float()
        rows = scan_rows(TileView.of_tiles(F.contiguous()), v_h)
        F = scan_cols(rows, v_v).to(img.dtype)
    return F


def _box_filter_rows_windowed(F: torch.Tensor, ct: torch.Tensor,
                              box_radius: float) -> torch.Tensor:
    """Normalized box filter along the rows of ``F`` (B, C, H, W) in the
    transformed domain ``ct`` (B, H, W), gather-free: ``ct`` grows by >= 1
    a pixel, so the box ``{j : ct[i] - r < ct[j] <= ct[i] + r}`` lies
    within ``ceil(r)`` pixels of i, and its sum is a masked sum over that
    window of shifts (polyblur_tpu/ops/domain_transform.py:124-161)."""
    R = int(math.ceil(box_radius))
    w = F.shape[-1]
    inf = torch.full(ct.shape[:-1] + (R,), math.inf, dtype=ct.dtype,
                     device=ct.device)
    ct_pad = torch.cat([-inf, ct, inf], -1)
    F_pad = torch.nn.functional.pad(F, (R, R))
    lo, hi = ct - box_radius, ct + box_radius
    num = torch.zeros_like(F)
    den = torch.zeros(ct.shape, dtype=F.dtype, device=F.device)
    for d in range(-R, R + 1):
        ctj = ct_pad[..., R + d:R + d + w]
        m = ((ctj > lo) & (ctj <= hi)).to(F.dtype)
        num = num + m[:, None] * F_pad[..., R + d:R + d + w]
        den = den + m
    return num / (den[:, None] + 1e-4)


def _box_filter_rows(F: torch.Tensor, ct: torch.Tensor,
                     box_radius) -> torch.Tensor:
    """Normalized box filter along the rows in the transformed domain
    (NC.cpp:50-140): the windowed form for a Python-number radius, else
    the box bounds by ``torch.searchsorted`` (right-sided) on each row of
    ``ct`` and the sum as a difference of the summed-area table
    (polyblur_tpu/ops/domain_transform.py:164-206)."""
    if isinstance(box_radius, (int, float)):
        record_dispatch("nc_box_filter", "windowed")
        return _box_filter_rows_windowed(F, ct, box_radius)
    record_dispatch("nc_box_filter", "searchsorted")
    b, c, h, w = F.shape
    big = torch.full(ct.shape[:-1] + (1,), 2.0 ** 16 - 1.0, dtype=ct.dtype,
                     device=ct.device)
    ct_inf = torch.cat([ct, big], -1).contiguous()
    r = box_radius.to(ct.dtype)
    l_idx = torch.searchsorted(ct_inf, (ct - r).contiguous(), right=True)
    u_idx = torch.searchsorted(ct_inf, (ct + r).contiguous(), right=True)
    count = (u_idx - l_idx)[:, None].to(F.dtype)
    return _BoxSums.apply(F, l_idx, u_idx) / (count + 1e-4)


def _prefix_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[0, cumsum(x)]`` along the last axis of (B, C, H, W) ``x``, read
    at the (B, H, W) indices ``idx`` (in [0, W]) of every channel."""
    b, c, h, w = x.shape
    sat = torch.cat([x.new_zeros((b, c, h, 1)), torch.cumsum(x, dim=-1)],
                    -1)
    return torch.gather(sat, -1, idx[:, None].expand(b, c, h, w))


class _BoxSums(torch.autograd.Function):
    """``sum(F[..., l:u])`` per pixel, from the summed-area table: the
    (B, H, W) bounds ``l <= u`` are non-decreasing along each row (they are
    searchsorted from the increasing ``ct``). Autograd's backward of the
    gather would scatter-add with atomics on the card; here d box[j] /
    d F[i] = [l_j <= i < u_j] is summed from the prefix sums of the
    cotangent g: ``grad F[i] = P[#{j: l_j <= i}] - P[#{j: u_j <= i}]``,
    ``P = [0, cumsum(g)]``, gathers in the forward direction only, the
    same on every run."""

    @staticmethod
    def forward(ctx, F, l_idx, u_idx):
        ctx.save_for_backward(l_idx, u_idx)
        return _prefix_at(F, u_idx) - _prefix_at(F, l_idx)

    @staticmethod
    def backward(ctx, g):
        l_idx, u_idx = ctx.saved_tensors
        pos = torch.arange(g.shape[-1], device=g.device).expand(
            l_idx.shape).contiguous()
        cl = torch.searchsorted(l_idx.contiguous(), pos, right=True)
        cu = torch.searchsorted(u_idx.contiguous(), pos, right=True)
        return _prefix_at(g, cl) - _prefix_at(g, cu), None, None


def normalized_convolution(img: torch.Tensor, sigma_s=60.0, sigma_r=0.4,
                           num_iterations: int = 3) -> torch.Tensor:
    """Edge-aware smoothing, normalized-convolution variant (NC.cpp:143-204;
    polyblur_tpu/ops/domain_transform.py:209-229): per iteration, the
    normalized box filter of radius ``sqrt 3 sigma_H_i`` in the transformed
    domain along the rows (``ct_H``, the cumulated horizontal derivative),
    then along the columns (``ct_V``).

    :param img: (B, C, H, W)
    :param sigma_s, sigma_r: Python numbers or 0-d tensors
    :return: (B, C, H, W) smoothed image
    """
    dhdx, dvdy = _domain_transform_derivatives(img, sigma_s, sigma_r)
    ct_h = torch.cumsum(dhdx, dim=-1)                  # (B, H, W)
    ct_v = torch.cumsum(dvdy, dim=-2).transpose(-1, -2)  # (B, W, H)
    F = img
    for sigma_h in _sigma_schedule(sigma_s, num_iterations):
        box_radius = math.sqrt(3.0) * sigma_h
        F = _box_filter_rows(F, ct_h, box_radius)
        F = _box_filter_rows(F.transpose(-1, -2), ct_v, box_radius)
        F = F.transpose(-1, -2)
    return F
