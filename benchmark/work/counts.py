"""The least work of the patch path's functions, and the H100's peaks.

Copied from the repository's ``chip_smoke.py`` (its ``fft_flops``,
``application_flops``, ``spectrum_flops``, ``maxima_flops``, ``bound_ms``
and peaks), which count what each function needs done, not what a kernel
does: a real 2D FFT of N = h w points as 2.5 N log2 N flops (half a
complex FFT's 5 N log2 N), each input byte read once and each output byte
written once. The bound of a function is then the same whatever kernel
implements it.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM, dense, at its 700 W limit (the data sheet)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
#: the peak that products of a work dtype's operands run at
KIND = {"bfloat16": "bf16", "float32": "f32"}


def fft_flops(h: int, w: int) -> float:
    """Flops of one real 2D FFT (forward or inverse) of an (h, w) plane."""
    return 2.5 * h * w * math.log2(h * w)


def application_flops(h: int, w: int) -> float:
    """One p(K) application to one (h, w) canvas plane given its real
    spectrum: rfft2, the product with the spectrum, irfft2."""
    return 2.0 * fft_flops(h, w) + 2.0 * h * (w // 2 + 1)


def spectrum_flops(h: int, w: int) -> float:
    """The kernel's spectrum on an (h, w) canvas (one real FFT of the
    placed taps) and the degree-3 Horner on it."""
    return fft_flops(h, w) + 6.0 * h * (w // 2 + 1)


def maxima_flops(c: int, h: int, w: int, angles: int = 7) -> float:
    """The estimate's directional maxima of one (c, h, w) image: gray and
    range normalization, the gradient pair through one forward and two
    inverse real FFTs, ``angles`` directional derivatives with |.| and
    max."""
    return (3.0 * fft_flops(h, w) + 4.0 * h * (w // 2 + 1)
            + (c + 3 + angles * 4) * h * w)


def gradient_flops(h: int, w: int) -> float:
    """The spectral gradient pair of one (h, w) plane: one forward and two
    inverse real FFTs and the two products (chip_smoke's halo count)."""
    return 3.0 * fft_flops(h, w) + 4.0 * h * (w // 2 + 1)


def bound_ms(nbytes: float, flops: float, kind: str) -> float:
    """Least time in ms of moving ``nbytes`` and doing ``flops`` at the
    ``kind`` peak: the larger of the two."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[kind]) * 1e3
