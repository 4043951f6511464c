"""Carry the JAX package's restoration parameters over to the port.

Polyblur has no learned weights: what a JAX configuration fixes is the
(8,) coefficient vector of the mega kernel (``pipeline._mega_pack``:
``[a3, a2, a1, beta, c, b, sigma_s, sigma_r]``), or the ``(params (N, 3),
coeffs (4,))`` pair of the fused polynomial, and the host tables, which
the port rebuilds bit-identically (tests/test_torch_tables.py). A trained
JAX ``PolyblurLayer`` carries its fitted scalars in a flax params tree,
which :func:`layer_params_from_jax` turns into the port's layer state.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import _mega_pack

__all__ = ["params_from_jax", "layer_params_from_jax"]

_FIELDS = ("c", "b", "alpha", "beta", "sigma_s", "sigma_r")


def params_from_jax(coeffs, device=None) -> torch.Tensor:
    """The port's (8,) f32 coefficient vector from the JAX package's.

    :param coeffs: the (8,) vector of ``polyblur_tpu.pipeline._mega_pack``
        as a NumPy array, or a mapping with the ``PolyblurConfig`` fields
        ``c, b, alpha, beta, sigma_s, sigma_r`` (e.g.
        ``dataclasses.asdict(cfg)``), or the ``(params, coeffs)`` pair of
        ``fused_polynomial_pallas`` — (N, 3) quadratic forms and (4,)
        Horner coefficients — which comes back as a pair of f32 tensors
        for ``ops.cuda.sep_poly_fused.fused_polynomial``
    """
    if isinstance(coeffs, dict):
        return _mega_pack(*(coeffs[k] for k in _FIELDS), device=device)
    if isinstance(coeffs, tuple):
        params, horner = (np.asarray(v, dtype=np.float32) for v in coeffs)
        if params.ndim != 2 or params.shape[1] != 3 or horner.shape != (4,):
            raise ValueError(f"expected ((N, 3) params, (4,) coeffs), got "
                             f"{params.shape}, {horner.shape}")
        return (torch.tensor(params, device=device),
                torch.tensor(horner, device=device))
    arr = np.asarray(coeffs, dtype=np.float32)
    if arr.shape != (8,):
        raise ValueError(f"expected an (8,) coefficient vector, got "
                         f"{arr.shape}")
    return torch.tensor(arr, device=device)


def layer_params_from_jax(params, device=None) -> dict:
    """``PolyblurLayer.state_dict()`` of a JAX ``PolyblurLayer``'s params.

    :param params: the flax params tree ``{"params": {"c", "b", "alpha",
        "beta"}}`` (NumPy or Python leaves, e.g. ``jax.tree.map(np.asarray,
        params)``), or its inner dict
    :returns: {name: 0-d f32 tensor} for ``layer.load_state_dict``
    """
    tree = params.get("params", params)
    return {k: torch.tensor(np.float32(np.asarray(tree[k])), device=device)
            for k in ("c", "b", "alpha", "beta")}
