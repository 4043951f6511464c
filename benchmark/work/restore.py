"""Work of the restoration layer in one call: the kernel spectra and
every p(K) application (chip_smoke's ``kernel_spectrum`` and
``spectral_gemm`` bounds).

A spectrum reads the (n, 8) estimate rows and writes its (n, h, 2 kp)
f32 planes, kp the half-spectrum's width rounded up to 128, and does
``spectrum_flops`` per tile at the f32 peak. An application reads its
input planes and the spectrum once, writes its output once, and does
``application_flops`` per plane at the work dtype's peak. With the
edgetaper each iteration adds the degree-1 spectrum and three
applications on the padded canvas in f32, each with a blend of 4 f32
operations per element."""

from __future__ import annotations

from .counts import KIND, application_flops, bound_ms, spectrum_flops
from .shapes import Call


def packed_k(w: int) -> int:
    return -(-(w // 2 + 1) // 128) * 128


def _spectrum_ms(s: Call) -> float:
    q_bytes = s.n * s.h * 2 * packed_k(s.h) * 4
    return bound_ms(q_bytes + s.n * 8 * 4, s.n * spectrum_flops(s.h, s.h),
                    "f32")


def _application_ms(s: Call, in_bytes: float, out_bytes: float,
                    blend_el: int = 0) -> float:
    q_bytes = s.n * s.h * 2 * packed_k(s.h) * 4
    nbytes = in_bytes + out_bytes + q_bytes
    return max(bound_ms(nbytes, s.planes * application_flops(s.h, s.h),
                        KIND[s.kind]),
               bound_ms(nbytes, 4.0 * blend_el, "f32"))


def per_call_ms(s: Call) -> float:
    """Least device time in ms of the restoration of one call."""
    tile_wd = s.tile_el * s.esz
    tile_f32 = s.tile_el * 4
    canvas_f32 = s.planes * s.h * s.h * 4
    base = tile_f32 if s.prefilter else tile_wd
    one = _spectrum_ms(s)
    if s.taper:
        one += _spectrum_ms(s)
        one += _application_ms(s, base, canvas_f32, s.planes * s.h * s.h)
        one += 2 * _application_ms(s, canvas_f32, canvas_f32,
                                   s.planes * s.h * s.h)
        base = canvas_f32
    one += _application_ms(s, base, tile_f32 if s.halo else tile_wd)
    return s.n_iter * one
