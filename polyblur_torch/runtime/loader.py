"""Burst loader: overlapped host decode and tile staging feeding the card.

For sustained burst deblurring (BASELINE config 4) the host must decode and
tile image N+1 while the card deblurs image N. This loader runs the native
decode and tile extraction (``runtime/native.py``) in a background thread
pool, so steady-state throughput is max(device time, host time) instead of
their sum. For a CUDA target the tiles are staged in pinned host memory,
ready for a ``non_blocking`` copy to the card.

The reference has no data-loading machinery at all (images are read
synchronously with skimage, main.py:80); the JAX package's loader
(polyblur_tpu/runtime/loader.py) is this module's model.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from . import native
from ..patches import plan_patch_grid

__all__ = ["BurstLoader"]


class BurstLoader:
    """Iterate (tiles, grid, meta) batches ready for the card.

    :param paths: image paths (PNG/JPEG)
    :param patch_size, overlap: tile grid of the patch engine
    :param prefetch: number of staged images decoded ahead
    :param workers: decode threads (default: up to 4)
    :param device: the target: ``"cuda"`` (default) stages each image's
        (T, C, ph, pw) f32 tiles in a pinned host tensor, ``"cpu"`` in an
        ordinary one; either way the content is the native tiles'
    """

    def __init__(self, paths: Iterable[str], patch_size: int = 400,
                 overlap: float = 0.25, prefetch: int = 2,
                 workers: Optional[int] = None, device="cuda"):
        self.paths = list(paths)
        self.patch_size = patch_size
        self.overlap = overlap
        self.prefetch = max(1, prefetch)
        self.workers = workers or min(4, max(1, len(self.paths)))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BurstLoader(device='cuda') stages in pinned "
                               "memory and needs a CUDA device; pass "
                               "device='cpu'")

    def _stage(self, path: str):
        img = native.decode_image(path)  # (H, W, C) or (H, W)
        if img.ndim == 2:
            img = img[..., None]
        chw = np.ascontiguousarray(img.transpose(2, 0, 1))[None]
        h, w = chw.shape[-2:]
        grid = plan_patch_grid(h, w, self.patch_size, self.overlap)
        shape = (len(grid.coords), chw.shape[1]) + tuple(grid.patch_size)
        tiles = torch.empty(shape, dtype=torch.float32,
                            pin_memory=self.device.type == "cuda")
        native.extract_tiles(chw, grid, out=tiles.numpy())
        return tiles, grid, {"path": path, "shape": chw.shape}

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.workers) as pool:
                    futures = [pool.submit(self._stage, p)
                               for p in self.paths]
                    for fut in futures:
                        q.put(fut.result())
            except Exception as e:  # handed to the consumer, raised there
                q.put(e)
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item

    def __len__(self) -> int:
        return len(self.paths)
