"""The restoration layer's share of its roofline, in %: the least device
time of the kernel spectra and every p(K) application of the traced calls
(``benchmark.work.restore``; with the edgetaper its three blurs per
iteration too), over the device time of the kernels that implement them,
at the H100 SXM's published peaks."""

from benchmark.trace import device_us
from benchmark.work import restore

#: the spectrum and the four DFT products of an application, in both of
#: the f32 dot modes' forms (``polyblur_torch/csrc/spectral.cu``)
PATTERNS = (r"::kernel_spectrum_kernel\b", r"::gemm_kernel<",
            r"::gemm_hi_kernel<")


def read(rec):
    if rec.trace is None:
        return None
    t_us = device_us(rec.trace, PATTERNS)
    if t_us <= 0:
        return None
    return 100.0 * restore.per_call_ms(rec.shapes) * rec.trace.calls * 1e3 / t_us
