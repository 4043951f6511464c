"""The features layer's share of its roofline, in %: the least device
time of the edgetaper's weights, the prefilter and the halo mask in the
traced calls (``benchmark.work.features``), over the device time of the
kernels that implement them, at the H100 SXM's published peaks. Nothing
to read in a configuration without these flags."""

from benchmark.trace import device_us
from benchmark.work import features

#: the taper weights (``features.cu``), the domain transform's IIR passes
#: (``iir.cu``) and the halo's two epilogues of the estimate GEMM (1:
#: input gradients, 2: the mask; ``estimate.cu``)
PATTERNS = (r"::taper_weights_kernel\b", r"::iir_rows_kernel\b",
            r"::iir_cols_kernel\b", r"::est_gemm_kernel<[12],")


def read(rec):
    if rec.trace is None:
        return None
    bound = features.per_call_ms(rec.shapes)
    t_us = device_us(rec.trace, PATTERNS)
    if bound is None or t_us <= 0:
        return None
    return 100.0 * bound * rec.trace.calls * 1e3 / t_us
