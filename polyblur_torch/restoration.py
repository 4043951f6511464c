"""Polynomial restoration coefficients.

With blur operator K and gains (alpha, beta) the degree-3 filter is

    a3 = alpha/2 - beta + 2,  a2 = 3 beta - alpha - 6,  a1 = 5 - 3 beta + alpha/2
    out = a3 K^3 u + a2 K^2 u + a1 K u + beta u            (Horner evaluated)

(reference deblurring.py:113-239). The patch engine evaluates it per tile in
the spectral kernels of ops/cuda/polyblur_fused.py.
"""

from __future__ import annotations

__all__ = ["polynomial_coefficients"]


def polynomial_coefficients(alpha, beta):
    a3 = alpha / 2.0 - beta + 2.0
    a2 = 3.0 * beta - alpha - 6.0
    a1 = 5.0 - 3.0 * beta + alpha / 2.0
    return a3, a2, a1
