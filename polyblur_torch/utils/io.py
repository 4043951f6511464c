"""Image I/O helpers (PIL, loaded on first use; the reference uses
scikit-image).

The reference's input handling (main.py:80-84): float32 in [0, 1], RGBA
collapsed to RGB. The same files and arrays as the JAX package's
``utils/io.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["imread_float", "imsave_uint8"]


def imread_float(path: str) -> np.ndarray:
    """Load an image as float32 (H, W) or (H, W, 3) in [0, 1]."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    if np.issubdtype(img.dtype, np.integer):
        img = img.astype(np.float32) / float(np.iinfo(img.dtype).max)
    else:
        img = img.astype(np.float32)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]  # drop alpha (reference: color.rgba2rgb)
    return img


def imsave_uint8(path: str, img: np.ndarray) -> None:
    """Write an (H, W) or (H, W, 3) image in [0, 1] as 8 bits, rounded
    to nearest (:func:`~polyblur_torch.utils.imaging.to_uint`)."""
    from PIL import Image

    from .imaging import to_uint

    Image.fromarray(to_uint(np.asarray(img, np.float32))).save(path)
