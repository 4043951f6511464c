"""The estimation layer's share of its roofline, in %: the least device
time of every tile's blur estimate in the traced calls
(``benchmark.work.estimate``), over the device time of the kernels that
implement it, at the H100 SXM's published peaks."""

from benchmark.trace import device_us
from benchmark.work import estimate

#: the kernels of the estimate: the gray min/max, the normalization, the
#: derivative GEMM with the directional maxima (epilogues 0 and 3) and the
#: final model (``polyblur_torch/csrc/estimate.cu``)
PATTERNS = (r"::gray_minmax_kernel\b", r"::gray_norm_kernel\b",
            r"::est_gemm_kernel<[03],", r"::tile_est_final_kernel\b")


def read(rec):
    if rec.trace is None:
        return None
    t_us = device_us(rec.trace, PATTERNS)
    if t_us <= 0:
        return None
    return 100.0 * estimate.per_call_ms(rec.shapes) * rec.trace.calls * 1e3 / t_us
