"""Array layout and blending-window utilities.

NumPy ``(H, W)`` / ``(H, W, C)`` images are accepted at the API boundary and
converted to channel-first tensors; the blending windows are built on the
host in float64 NumPy and handed to the device as float32 constants.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_tensor", "to_array", "to_float", "to_uint",
           "build_window_np", "build_window", "crop",
           "pad_with_kernel", "crop_with_kernel", "replicate_pad",
           "clip_as_jax"]


def to_tensor(x: np.ndarray, dtype=torch.float32, device=None) -> torch.Tensor:
    """Convert an ``(H, W)`` or ``(H, W, C)`` ndarray into a ``(C, H, W)``
    tensor (reference utils.py:8-21: channel-first layout, float cast)."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[None]
    else:
        x = np.transpose(x, (2, 0, 1))
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def to_array(x: torch.Tensor) -> np.ndarray:
    """Convert a ``(B, C, H, W)`` / ``(C, H, W)`` tensor back to an
    ``(H, W, C)`` (or ``(H, W)``) ndarray (reference utils.py:24-31)."""
    x = np.squeeze(x.detach().to("cpu", torch.float32).numpy())
    if x.ndim == 2:
        return x
    return np.transpose(x, (1, 2, 0))


def to_float(img: np.ndarray) -> np.ndarray:
    """An image ndarray as float32, integers scaled by their dtype's
    maximum to [0, 1] (reference utils.py:34-38)."""
    img = np.asarray(img)
    if np.issubdtype(img.dtype, np.integer):
        img = img.astype(np.float32) / float(np.iinfo(img.dtype).max)
    return img.astype(np.float32)


def to_uint(img: np.ndarray) -> np.ndarray:
    """An image ndarray as uint8: clipped to [0, 1], times 255, rounded
    to nearest (reference utils.py:41-45)."""
    img = to_float(img)
    return (255.0 * np.clip(img, 0.0, 1.0) + 0.5).astype(np.uint8)


def crop(image: torch.Tensor, new_size) -> torch.Tensor:
    """Top-left crop to ``new_size`` where larger (filters.py:189-195)."""
    return image[..., :int(new_size[0]), :int(new_size[1])]


def _half_support(kernel=None, ksize: int = 3) -> int:
    return kernel.shape[-1] // 2 if kernel is not None else ksize // 2


def replicate_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """``F.pad(x, pads, mode='replicate')`` over the last two dims, pads
    ``(left, right, top, bottom)``. While autograd records ``x`` it is
    built from expanded edge rows and columns instead: the same values,
    and a backward that sums each border into its edge pixel by
    reductions (deterministic on the card, where the replicate pad's own
    backward accumulates with atomics); otherwise it is ``F.pad``'s one
    pass."""
    pl, pr, pt, pb = (int(p) for p in pads)
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    if not (torch.is_grad_enabled() and x.requires_grad):
        out = torch.nn.functional.pad(x.reshape(-1, 1, h, w),
                                      (pl, pr, pt, pb), mode="replicate")
        return out.reshape(*lead, *out.shape[-2:])
    x = torch.cat([x[..., :1, :].expand(*lead, pt, w), x,
                   x[..., h - 1:, :].expand(*lead, pb, w)], -2)
    hp = h + pt + pb
    return torch.cat([x[..., :1].expand(*lead, hp, pl), x,
                      x[..., w - 1:].expand(*lead, hp, pr)], -1)


def clip_as_jax(x: torch.Tensor, lo: float = 0.0,
                hi: float | None = 1.0) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``. While autograd records ``x`` it is
    ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is built: a value on
    a bound takes half the gradient there (``maximum`` / ``minimum`` split
    ties in both packages), where ``clamp`` passes all of it. Such ties
    are common, not rare: a clipped value is exactly the bound, and a
    ratio clipped at 0 is 0 wherever its numerator is. Otherwise it is
    ``clamp``'s one pass (the same values)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.clamp(lo, hi)
    x = torch.maximum(x, x.new_full((), lo))
    return x if hi is None else torch.minimum(x, x.new_full((), hi))


def pad_with_kernel(img: torch.Tensor, kernel=None, ksize: int = 3,
                    mode: str = "replicate") -> torch.Tensor:
    """Replicate-pad the two spatial dims by half the kernel support
    (utils.py:48-53); ``mode='circular'`` wraps instead."""
    ks = _half_support(kernel, ksize)
    if mode == "replicate":
        return replicate_pad(img, (ks,) * 4)
    out = torch.nn.functional.pad(img.reshape((-1, 1) + img.shape[-2:]),
                                  (ks,) * 4, mode=mode)
    return out.reshape(img.shape[:-2] + out.shape[-2:])


def crop_with_kernel(img: torch.Tensor, kernel=None,
                     ksize: int = 3) -> torch.Tensor:
    """Inverse of :func:`pad_with_kernel` (utils.py:56-61)."""
    ks = _half_support(kernel, ksize)
    return img[..., ks:-ks, ks:-ks]


def _kaiser_window(n: int, beta: float = 5.0) -> np.ndarray:
    # periodic kaiser window of length n (torch.kaiser_window(..., periodic=True))
    return np.kaiser(n + 1, beta)[:n]


def build_window_np(image_size, window_type: str = "kaiser") -> np.ndarray:
    """Separable 2D blending window for overlap-add tiling (reference
    deblurring.py:349-366: kaiser beta=5 / hann / hamming / bartlett, all
    periodic), as a float32 host array."""
    h, w = image_size
    if window_type == "kaiser":
        wi, wj = _kaiser_window(h), _kaiser_window(w)
    elif window_type == "hann":
        wi, wj = np.hanning(h + 1)[:h], np.hanning(w + 1)[:w]
    elif window_type == "hamming":
        wi, wj = np.hamming(h + 1)[:h], np.hamming(w + 1)[:w]
    elif window_type == "bartlett":
        wi, wj = np.bartlett(h + 1)[:h], np.bartlett(w + 1)[:w]
    else:
        raise ValueError(f"Window {window_type!r} not implemented")
    return (wi[:, None] * wj[None, :]).astype(np.float32)


def build_window(image_size, window_type: str = "kaiser",
                 device=None) -> torch.Tensor:
    """:func:`build_window_np` as an f32 tensor on ``device`` (default: the
    CPU)."""
    return torch.as_tensor(build_window_np(image_size, window_type),
                           device=device)
