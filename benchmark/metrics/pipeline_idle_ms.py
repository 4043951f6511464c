"""The device's idle ms per traced call while the host is in the stage
loop: inside the span ``pb.restore_tiles`` (the stage tables, the halo
gradients and each iteration's estimate, spectrum, prefilter, taper,
polynomial and halo launches; ``benchmark.spans``). Layer pipeline."""

from benchmark.spans import idle_ms_per_call


def read(rec):
    return idle_ms_per_call(rec.trace, ("pb.restore_tiles",))
