"""Device ms per traced step in the operations that the autograd engine
launches while it evaluates a node of the backward graph: every device
operation whose launch (its runtime call) began inside a span
``autograd::engine::evaluate_function: ...`` (the kernels' autograd
Functions replaying their plain PyTorch backward, the blend's index
scatter). Nothing to read in a cell that takes no gradient. Layer
backward."""

from benchmark.trace import launched_in

SPAN = "autograd::engine::evaluate_function"


def read(rec):
    if rec.trace is None:
        return None
    t_us = launched_in(rec.trace, lambda name: name.startswith(SPAN))
    if t_us is None or t_us <= 0:
        return None
    return t_us / rec.trace.calls / 1e3
