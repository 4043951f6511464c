"""Burst deblurring CLI — the serving path end to end on the port.

    python -m polyblur_torch.cli.burst --images 'shots/*.png' --outdir restored/
    python -m polyblur_torch.cli.burst --images ... --device cpu

The flags and defaults of the JAX package's ``cli/burst.py`` (:35-52),
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
Per image: native C++ decode (``runtime/native.py``) in a thread pool of
``--prefetch`` workers, so that image k + 1 decodes while the card works
on image k; only the (H, W, C) uint8 image crosses the link, from a pinned
host buffer with a ``non_blocking`` copy, and back. On the card:
dequantize -> ``patches.extract_patches`` (the ``edge_pad_cast`` kernel)
-> ``pipeline.polyblur_core`` on the tile batch with
``method='direct_separable'`` (the tiles route: ``tile_estimate``,
``kernel_spectrum``, ``spectral_gemm``) -> ``patches.overlap_add`` to f32
(``blend_overlap_add``) -> clip and quantize. Each image is written as
``<name>_restored.png`` into ``--outdir`` by a writer thread, so that its
PNG encode overlaps the next image's device work, at zlib level 1 (the
same pixels as PIL's default level 6, which the JAX package's CLI
writes, at a quarter of the encode time: at 12 MP the encode is the
host's largest cost); a line per image, then the MP/s of the whole
burst, writes included. :func:`main` returns the number of images.

The reference has no batch or serving tooling (one synchronous demo
script, main.py).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import glob
import os
import time

import numpy as np

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Burst Polyblur deblurring "
                                            "(PyTorch, CUDA)")
    p.add_argument("--images", type=str, required=True,
                   help="glob of input images (PNG/JPEG)")
    p.add_argument("--outdir", type=str, default="restored")
    p.add_argument("--N", type=int, default=3)
    p.add_argument("--alpha", type=float, default=6.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--c", type=float, default=0.362)
    p.add_argument("--b", type=float, default=0.468)
    p.add_argument("--patch_size", type=int, default=400)
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    return p


def _decode(path: str):
    """(path, (H, W, C) uint8, host decode seconds): the JAX package's
    requantization of the decoded [0, 1] floats (``* 255``, truncated)."""
    from ..runtime import native

    t0 = time.perf_counter()
    img = native.decode_image(path)
    u8 = np.ascontiguousarray(
        (img[..., None] if img.ndim == 2 else img) * 255.0).astype(np.uint8)
    return path, u8, time.perf_counter() - t0


def main(argv=None, stats: list | None = None) -> int:
    """Run the burst CLI on ``argv``. ``stats``, when given, receives one
    dict per image: ``path``, ``mp``, ``decode_ms`` (host),
    ``device_ms`` (the card's time from the upload's start to the
    download's end, CUDA events; the host clock on the CPU) and ``done``
    (``time.perf_counter()`` when its restored pixels reached the
    host)."""
    args = build_parser().parse_args(argv)

    import torch
    from PIL import Image

    from ..patches import extract_patches, overlap_add, plan_patch_grid
    from ..pipeline import polyblur_core, resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    paths = sorted(glob.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images!r}")
    os.makedirs(args.outdir, exist_ok=True)
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    def process(img_u8: torch.Tensor, grid) -> torch.Tensor:
        """(H, W, C) uint8 on the device in, (H, W, C) uint8 out."""
        x = img_u8.to(torch.float32)[None].permute(0, 3, 1, 2) / 255.0
        tiles = extract_patches(x.to(dt), grid)
        restored = polyblur_core(
            tiles, n_iter=args.N, c=args.c, b=args.b, alpha=args.alpha,
            beta=args.beta, method="direct_separable", device=dev)
        # blend straight to f32: no upcast pass over the tiles first
        out = overlap_add(restored, grid, 1, out_dtype=torch.float32)
        u8 = (255.0 * torch.clamp(out[0], 0.0, 1.0) + 0.5).to(torch.uint8)
        return u8.permute(1, 2, 0)

    total_mp = 0.0
    t_start = time.perf_counter()
    n_done = 0
    workers = max(1, args.prefetch)
    with torch.no_grad(), cf.ThreadPoolExecutor(workers) as pool, \
            cf.ThreadPoolExecutor(workers) as writer:
        writes = []
        for path, img_u8, dec_s in pool.map(_decode, paths):
            h, w = img_u8.shape[:2]
            grid = plan_patch_grid(h, w, args.patch_size, args.overlap)
            t0 = time.perf_counter()
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                src = torch.from_numpy(img_u8).pin_memory()
                start.record()
                res = process(src.to(dev, non_blocking=True), grid)
                host = torch.empty(res.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(res, non_blocking=True)
                end.record()
                end.synchronize()
                device_ms = start.elapsed_time(end)
            else:
                host = process(torch.from_numpy(img_u8), grid)
                device_ms = (time.perf_counter() - t0) * 1e3
            out_u8 = host.numpy()
            name = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(args.outdir, f"{name}_restored.png")
            writes.append(writer.submit(
                lambda a, f: Image.fromarray(a).save(f, compress_level=1),
                out_u8.squeeze(), out_path))
            total_mp += h * w / 1e6
            n_done += 1
            if stats is not None:
                stats.append(dict(path=path, mp=h * w / 1e6,
                                  decode_ms=dec_s * 1e3, device_ms=device_ms,
                                  done=time.perf_counter()))
            print(f"[{n_done}/{len(paths)}] {path} ({h}x{w}) -> {out_path}: "
                  f"decode {dec_s * 1e3:.1f} ms, device {device_ms:.1f} ms")
        for job in writes:
            job.result()  # raises a failed write
    dt_total = time.perf_counter() - t_start
    print(f"burst done: {n_done} images, {total_mp:.1f} MP in "
          f"{dt_total:.2f}s = {total_mp / dt_total:.1f} MP/s "
          f"(incl. the first image's kernel build, host codec and link "
          f"transfer; {dev})")
    return n_done


if __name__ == "__main__":
    main()
