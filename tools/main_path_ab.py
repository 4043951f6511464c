#!/usr/bin/env python3
"""Time grad-free paths of the tree in the current directory.

Run from the root of a tree on a machine with a card:
``python3 <tools dir>/main_path_ab.py [reps] [paths]`` — e.g. ``cd
build/parent && python3 ../../tools/main_path_ab.py 1 main,config2c``
for an unpacked parent commit, so that two trees are timed alike, in
alternating processes. ``paths`` is a comma-separated list of:

- ``main`` (the default): ``deblur_patches`` on bench.py's 12 MP image
  from the tree's ``chip_smoke.make_12mp_image`` (448/384 tiles, bf16
  work dtype, f32 out, 3 iterations, ``direct_separable``);
- ``config2``: BASELINE config 2 on the tree's
  ``chip_smoke.make_config2_image`` (1200 x 1600, ``deblur_patches`` at
  448 px and overlap 1/7, bf16 work, taper + dt prefilter + halo);
- ``config2b``: config 2 in f32 work dtype (the f32 dot mode's default
  ``'compensated'`` instantiations);
- ``config2c``: the same photo through ``polyblur_core(method='fft')``
  with config 2's flags;
- ``prefilter``: ``main`` with ``prefiltering=True`` and the default
  smoother (the bilateral stage on the 88 tiles of every iteration).

It builds the tree's kernels, then for each path in turn warms up and per
repetition prints the host time of a call (median of 5 calls, each ending
in a synchronize, as ``chip_smoke.py`` times it), its MP/s, the host's
enqueue time (median of 5 calls from an idle card to the call's return,
before the synchronize: the Python and launch cost of the call, plus the
wait of its host-to-device copies), and the device busy time of one call
traced with ``torch.profiler`` (the union of its kernels' intervals);
once per path, the sha256 of its output's bytes, so that two trees'
outputs can be compared bit for bit. Imports no JAX.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())


def busy_us(prof, torch) -> float:
    """The union of the traced CUDA kernels' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    import polyblur_torch as pt
    from chip_smoke import CFG2_KW, make_12mp_image, make_config2_image
    from polyblur_torch.ops import cuda as pcuda
    from polyblur_torch.pipeline import polyblur_core

    if not torch.cuda.is_available():
        print("main_path_ab: no CUDA device", file=sys.stderr)
        return 2
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    paths = (sys.argv[2] if len(sys.argv) > 2 else "main").split(",")
    unknown = set(paths) - {"main", "config2", "config2b", "config2c",
                            "prefilter"}
    if unknown:
        print(f"main_path_ab: unknown paths {sorted(unknown)}",
              file=sys.stderr)
        return 2
    pcuda.build()
    dev = torch.device("cuda")
    photo = torch.as_tensor(make_config2_image().transpose(2, 0, 1)[None]
                            .copy(), device=dev)
    img12 = torch.as_tensor(make_12mp_image(np.random.default_rng(0)),
                            device=dev)

    def patches12(img, **kw):
        return pt.deblur_patches(
            img, patch_size=448, overlap=64.0 / 448.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32, device=dev,
            method="direct_separable", n_iter=3, c=0.362, b=0.468,
            alpha=6.0, beta=1.0, **kw)

    def config2(img, wd):
        return pt.deblur_patches(
            img, patch_size=448, overlap=1.0 / 7.0, work_dtype=wd,
            out_dtype=torch.float32, device=dev, method="direct_separable",
            **CFG2_KW)

    calls = {
        "main": (img12, patches12),
        "prefilter": (img12, lambda img: patches12(img, prefiltering=True)),
        "config2": (photo, lambda img: config2(img, torch.bfloat16)),
        "config2b": (photo, lambda img: config2(img, torch.float32)),
        "config2c": (photo, lambda img: polyblur_core(
            img, device=dev, method="fft", **CFG2_KW)),
    }
    for path in paths:
        img, fn = calls[path]
        npx = img.shape[-2] * img.shape[-1]
        for _ in range(3):
            out = fn(img)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        print(f"{path}: output sha256 {digest[:16]}")
        for _ in range(reps):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(img)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            sec = statistics.median(times)
            enqueue = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(img)
                enqueue.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                fn(img)
                torch.cuda.synchronize()
            print(f"{path}: host {sec * 1e3:.3f} ms = "
                  f"{npx / 1e6 / sec:.2f} MP/s, enqueue "
                  f"{statistics.median(enqueue) * 1e3:.3f} ms, device busy "
                  f"{busy_us(prof, torch) / 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
