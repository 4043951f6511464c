"""Gastal-Oliveira domain transform: the recursive-filter (RF) edge-aware
smoother of the prefilter (port of polyblur_tpu/ops/domain_transform.py:
29-121; reference domain_transform.py:6-85).

The recurrence ``y[i] = (1 - V[i]) x[i] + V[i] y[i-1]`` runs forward and
backward along the rows, then along the columns, per iteration. On the card
both passes are the hand-written kernels of ``ops/cuda/iir.py``
(``csrc/iir.cu``): the row pass replaces ``iir_scan_rows_pallas`` and the
column pass the JAX code's swapaxes + row scan, so the vertical
derivatives stay in the (B, H, W) layout here. The JAX package's
``IIR_MAX_EDGE`` was a TPU VMEM limit; the kernels serve every size. The
normalized-convolution variant (``smoother='nc'``, no TPU kernel) is not
ported yet (ROADMAP A.8).

Differentiable in the image, the joint image and ``sigma_s`` / ``sigma_r``
(Python numbers or 0-d tensors, kept in the graph as the JAX package keeps
its traced sigmas): the scans are autograd Functions whose backward
replays their plain versions (the counterpart of ``_iir_pallas``'s VJP,
polyblur_tpu/ops/pallas/iir.py:110-127).
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import record_dispatch
from .cuda.iir import scan_cols, scan_rows
from .cuda.polyblur_fused import TileView

__all__ = ["recursive_filter", "iir_scan_rows"]

_TODO_NC = "ROADMAP A.8 (the normalized-convolution smoother, smoother='nc')"


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
    (domain_transform.py:27-38). Unlike the JAX package, dVdy is not
    transposed: the column pass reads it as it is."""
    didx = torch.abs(torch.diff(J, dim=-1)).sum(1)          # (B, H, W-1)
    didx = torch.nn.functional.pad(didx, (1, 0))
    didy = torch.abs(torch.diff(J, dim=-2)).sum(1)          # (B, H-1, W)
    didy = torch.nn.functional.pad(didy, (0, 0, 1, 0))
    # in f32, as the JAX pipeline divides its traced sigmas
    ratio = _f32(sigma_s) / _f32(sigma_r)
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
