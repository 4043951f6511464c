#!/usr/bin/env python3
"""Time the 12 MP main path of the tree in the current directory.

Run from the root of a tree on a machine with a card:
``python3 <tools dir>/main_path_ab.py [reps]`` — e.g. ``cd build/parent &&
python3 ../../tools/main_path_ab.py`` for an unpacked parent commit, so
that two trees are timed alike, in alternating processes. It builds the
tree's kernels, warms up, then per repetition prints the host time of a
``deblur_patches`` call (bench.py's 12 MP image from the tree's
``chip_smoke.make_12mp_image``; 448/384 tiles, bf16 work dtype, f32 out,
3 iterations, ``direct_separable``; median of 5 calls, each ending in a
synchronize, as ``chip_smoke.py`` times it), its MP/s, the host's enqueue
time (median of 5 calls from an idle card to the call's return, before
the synchronize: the Python and launch cost of the call, plus the wait of
its one host-to-device copy of the coefficients), and the device busy
time of one call traced with ``torch.profiler`` (the union of its
kernels' intervals). Imports no JAX.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    import polyblur_torch as pt
    from chip_smoke import make_12mp_image
    from polyblur_torch.ops import cuda as pcuda

    if not torch.cuda.is_available():
        print("main_path_ab: no CUDA device", file=sys.stderr)
        return 2
    pcuda.build()
    dev = torch.device("cuda")
    img = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                          device=dev)
    npx = img.shape[-2] * img.shape[-1]

    def call():
        return pt.deblur_patches(
            img, patch_size=448, overlap=64.0 / 448.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32, device=dev,
            method="direct_separable", n_iter=3, c=0.362, b=0.468,
            alpha=6.0, beta=1.0)

    for _ in range(3):
        call()
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 3):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        sec = statistics.median(times)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            enqueue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
            call()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in p.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, None
        for s, e in spans:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        print(f"main path: host {sec * 1e3:.3f} ms = {npx / 1e6 / sec:.2f} "
              f"MP/s, enqueue {statistics.median(enqueue) * 1e3:.3f} ms, "
              f"device busy {busy / 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
