#!/usr/bin/env python3
"""Where the time goes in polyblur_torch's paths on one NVIDIA GPU.

Run from the repository root on a machine with a card:
``python3 tools/torch_profile.py [base] [features] [prefilter] [train]
[train_flags]`` (``base`` and ``features`` by default). For each path —
``base``: the 12 MP bf16
patch engine, the reference demo and the 2 MP corpus photo through the
blocked route, a 480 x 640 crop through the tiles route and through
``method='fft'``; ``features``: BASELINE config 2 (the 2 MP photo through
the patch engine in bf16 with the taper, the domain-transform prefilter
and the halo mask), config 2c (the same flags through ``method='fft'``)
and the 480 x 640 tiles route with every flag and the bilateral
smoother; ``prefilter``: the 12 MP bf16 patch engine with
``prefiltering=True`` and the default smoother (bilateral), printed with
the bilateral stage's share of the call's device busy time; ``train``: one
Adam step of the 12 MP bf16 patch layer
(chip_smoke's training phase (a)) and its forward alone;
``train_flags``: the same for BASELINE config 2 as a learnable layer
(chip_smoke's (f), bf16 work) and config 2c's layer (``method='fft'``,
chip_smoke's (g)); each ``train`` set also prints the backward's share of
the step's device busy time (1 - forward busy / step busy) — it times one
warm call on the host clock (ending in a synchronize), traces a second
with ``torch.profiler`` and prints the device time by kernel name, the
device busy time (the union of the kernels' intervals), the idle share
of the call, and the device time of the hand kernels (the ``__global__``
functions of ``csrc/``) beside that of every other kernel (PyTorch's:
the plain backward). Imports no JAX.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _png(path):
    from PIL import Image

    return (np.asarray(Image.open(path))[..., :3] / 255.0).astype(np.float32)


def _busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def _hand_kernel_names() -> set:
    """The ``__global__`` functions of ``polyblur_torch/csrc``."""
    root = os.path.join(os.getcwd(), "polyblur_torch", "csrc")
    names = set()
    for f in os.listdir(root):
        if f.endswith(".cu"):
            with open(os.path.join(root, f)) as src:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(", src.read()))
    return names


_HAND = None


def _is_hand(kernel: str) -> bool:
    """Whether a traced kernel is one of the hand kernels: its name is
    ``(anonymous namespace)::<a csrc __global__ function>``."""
    global _HAND
    if _HAND is None:
        _HAND = _hand_kernel_names()
    m = re.search(r"^(?:void )?\(anonymous namespace\)::(\w+)", kernel)
    return bool(m) and m.group(1) in _HAND


def profile(name, fn, top: int = 10, share_of: str | None = None) -> None:
    import torch
    from torch.profiler import ProfilerActivity

    from chip_smoke import kernel_device_ms

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the program's spans (``pb.*``) have device-side copies: no kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = _busy_ms(kernels)
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    hand = sum(e.device_time for e in kernels if _is_hand(e.name)) / 1e3
    total = kernel_device_ms(kernels)
    print(f"\n== {name}: host {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1.0 - busy / wall:.3f}, {len(kernels)} kernels; "
          f"hand kernels {hand:.2f} ms, other kernels {total - hand:.2f} ms")
    if share_of is not None:
        part = kernel_device_ms(kernels, share_of)
        print(f"   {share_of}: {part:.3f} ms = {part / busy:.3f} of the "
              f"device busy time")
    for k, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"   {t:9.3f} ms  {n:4d}x  {k[:90]}")
    return busy


def train_profile(name, layer, x, top: int = 14) -> None:
    """One Adam step of ``layer`` on (x, x) and its forward alone, and the
    backward's share of the step's device busy time."""
    import torch

    from polyblur_torch import make_train_step

    step = make_train_step(layer, torch.optim.Adam(layer.parameters(),
                                                   lr=1e-2))
    busy = profile(f"training step: {name}, one Adam step",
                   lambda: step(x, x), top=top)
    fwd = profile("the step's forward alone (the graph is built and dropped)",
                  lambda: torch.mean((layer(x) - x) ** 2))
    print(f"   backward share of the step's device busy time "
          f"{1.0 - fwd / busy:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    import polyblur_torch as pt
    from polyblur_torch.pipeline import polyblur_core

    sets = set(sys.argv[1:]) or {"base", "features"}
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain backward
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    dev = torch.device("cuda")
    kw = dict(n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0)
    peacock = _png("tests/data/peacock_defocus.png")
    photo = _png("tests/data/corpus_hr/peacock_tiled.png")
    rng = np.random.default_rng(0)
    big = np.tile(peacock, (7, 6, 1))[:3000, :4000]
    big = np.clip(big + rng.normal(0, 0.005, big.shape), 0, 1)
    img12 = torch.as_tensor(big.astype(np.float32).transpose(2, 0, 1)[None]
                            .copy(), device=dev)
    crop = torch.as_tensor(peacock[:480, :640].transpose(2, 0, 1)[None]
                           .copy(), device=dev)
    if "base" in sets:
        profile("12 MP patch engine, bf16 (the main path)", lambda: (
            pt.deblur_patches(img12, patch_size=448, overlap=64.0 / 448.0,
                              work_dtype=torch.bfloat16,
                              out_dtype=torch.float32, device=dev,
                              method="direct_separable", **kw)))
        profile("demo 700x500, blocked route",
                lambda: pt.polyblur_deblurring(peacock, device=dev, **kw))
        profile("2 MP 1600x1200, blocked route",
                lambda: pt.polyblur_deblurring(photo, device=dev, **kw))
        profile("480x640 tiles route, f32",
                lambda: pt.polyblur_deblurring(crop, device=dev, **kw))
        profile("480x640 method='fft'", lambda: pt.polyblur_deblurring(
            crop, device=dev, method="fft", **kw))
    if "features" in sets:
        flags = dict(remove_halo=True, edgetaping=True, prefiltering=True)
        cfg2 = dict(kw, smoother="domain_transform", **flags)
        # bench_suite's config 2 image: the peacock tiled to 1200 x 1600
        x2 = torch.as_tensor(np.tile(peacock, (3, 3, 1))[:1200, :1600]
                             .transpose(2, 0, 1)[None].copy(), device=dev)
        profile("config 2: 2 MP patch engine, bf16, taper + dt + halo",
                lambda: pt.deblur_patches(
                    x2, patch_size=448, overlap=1.0 / 7.0,
                    work_dtype=torch.bfloat16, out_dtype=torch.float32,
                    device=dev, method="direct_separable", **cfg2), top=14)
        profile("config 2c: 2 MP method='fft', taper + dt + halo",
                lambda: polyblur_core(x2, device=dev, method="fft", **cfg2))
        profile("480x640 tiles route, every flag (bilateral), f32",
                lambda: pt.polyblur_deblurring(crop, device=dev, **kw,
                                               **flags), top=14)
    if "prefilter" in sets:
        profile("12 MP patch engine, bf16, prefiltering (bilateral)",
                lambda: pt.deblur_patches(
                    img12, patch_size=448, overlap=64.0 / 448.0,
                    work_dtype=torch.bfloat16, out_dtype=torch.float32,
                    device=dev, method="direct_separable", prefiltering=True,
                    **kw), top=12, share_of="bilateral_kernel")
    if "train" in sets:
        from polyblur_torch import PolyblurLayer

        train_profile("12 MP bf16 patch layer", PolyblurLayer(
            n_iter=3, learnable=True, patch_size=448,
            patch_overlap=64.0 / 448.0, method="direct_separable",
            extra=dict(work_dtype=torch.bfloat16, out_dtype=torch.float32),
            device=dev), img12)
    if "train_flags" in sets:
        from polyblur_torch import PolyblurLayer

        x2 = torch.as_tensor(np.tile(peacock, (3, 3, 1))[:1200, :1600]
                             .transpose(2, 0, 1)[None].copy(), device=dev)
        flags = dict(remove_halo=True, edgetaping=True, prefiltering=True,
                     smoother="domain_transform")
        train_profile("config 2 layer, 2 MP bf16, taper + dt + halo",
                      PolyblurLayer(
                          n_iter=3, learnable=True, patch_size=448,
                          patch_overlap=1.0 / 7.0, method="direct_separable",
                          extra=dict(flags, work_dtype=torch.bfloat16,
                                     out_dtype=torch.float32), device=dev),
                      x2)
        train_profile("config 2c layer, 2 MP method='fft', taper + dt + halo",
                      PolyblurLayer(n_iter=3, learnable=True, method="fft",
                                    extra=flags, device=dev), x2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
