"""Kernel launches per call: the sum of the program's launch counters
(``polyblur_torch.ops.cuda._build.launches``) over one call, the mean over
the traced run's untraced calls. Layer pipeline."""

import statistics


def read(rec):
    if not rec.launches or not any(rec.launches):
        return None
    return statistics.fmean(rec.launches)
