"""The device's idle ms per traced call while the host is in the patch
layer: inside the span ``pb.deblur_patches`` (grid plan, coefficient
copy, pad and blend launches) and outside the stage loop's
``pb.restore_tiles`` (``benchmark.spans``). Layer patches."""

from benchmark.spans import idle_ms_per_call


def read(rec):
    return idle_ms_per_call(rec.trace, ("pb.deblur_patches",),
                            ("pb.restore_tiles",))
