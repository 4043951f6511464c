"""Public API: the stateless deblurring module.

Mirrors the reference surface (deblurring.py:250-394), including the NumPy
adapter: ``(H, W)`` / ``(H, W, C)`` ndarrays are accepted and returned as
such; tensors must be ``(B, C, H, W)``. This slice of the port runs the
patch engine (``patch_decomposition=True``); the whole-image route and the
functional ``polyblur_deblurring`` come next.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .config import MODULE_DEFAULTS
from .patches import _resolve_device, deblur_patches
from .utils.imaging import to_array, to_tensor

__all__ = ["polyblur_deblurring", "PolyblurDeblurring"]

_TODO_WHOLE = ("ROADMAP A.5 (the whole-image polyblur_core / "
               "polyblur_deblurring route)")


def _resolve_auto(method: str) -> str:
    """``'auto'`` -> ``'direct_separable'``: the reference's
    direct-on-CUDA selection (main.py:109-112), and the only method the
    port runs (its CPU path is the plain version of the CUDA path)."""
    return "direct_separable" if method == "auto" else method


def _adapt_in(img, device: torch.device):
    """numpy (H,W)/(H,W,C) -> ((1,C,H,W) tensor, True); a (B,C,H,W)
    tensor -> (it on ``device``, False)."""
    if isinstance(img, np.ndarray):
        if img.ndim not in (2, 3):
            raise ValueError(
                "numpy input must be (H, W) or (H, W, C) — pass a "
                f"(B, C, H, W) tensor for batches; got shape {img.shape}")
        return to_tensor(img, device=device)[None], True
    img = torch.as_tensor(img, device=device)
    if img.dim() != 4:
        raise ValueError(
            f"expected (B, C, H, W) tensor or numpy image, got shape "
            f"{tuple(img.shape)}")
    return img, False


def polyblur_deblurring(img, *args, **kwargs):
    """Functional Polyblur on whole images — not ported yet."""
    raise NotImplementedError(f"polyblur_deblurring: see {_TODO_WHOLE}")


class PolyblurDeblurring(nn.Module):
    """Stateless deblurring module with the overlapping-patch engine.

    Holds no parameters or buffers (as the reference module). The
    constructor stores the patch configuration and the device; ``forward``
    matches the reference's surface and defaults (deblurring.py:266-268).
    Calls run on ``device`` (default ``"cuda"``, raising when no card is
    available; pass ``"cpu"`` for the plain PyTorch path).
    """

    def __init__(self, patch_decomposition: bool = False,
                 patch_size: int = 400, patch_overlap: float = 0.25,
                 batch_size: int = 0, device=None):
        super().__init__()
        self.patch_decomposition = patch_decomposition
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        # at most batch_size tile coordinates per pass; <= 0: all at once
        self.batch_size = batch_size
        self.device = device

    def forward(self, images, n_iter: int = 1, c=0.352, b=0.468, alpha=2.0,
                beta=4.0, sigma_s=2.0, ker_size: int = 25, sigma_r=0.4,
                q: float = 0.0, n_angles: int = 6,
                n_interpolated_angles: int = 30, remove_halo: bool = False,
                edgetaping: bool = False, prefiltering: bool = False,
                discard_saturation: bool = False,
                multichannel_kernel: bool = False, method: str = "auto",
                device=None):
        if not self.patch_decomposition:
            raise NotImplementedError(
                f"PolyblurDeblurring(patch_decomposition=False): see "
                f"{_TODO_WHOLE}")
        dev = _resolve_device(device if device is not None else self.device)
        cfg = MODULE_DEFAULTS.replace(
            n_iter=n_iter, c=c, b=b, alpha=alpha, beta=beta, sigma_r=sigma_r,
            sigma_s=sigma_s, ker_size=ker_size, q=q, n_angles=n_angles,
            n_interpolated_angles=n_interpolated_angles,
            remove_halo=remove_halo, edgetaping=edgetaping,
            prefiltering=prefiltering, discard_saturation=discard_saturation,
            multichannel_kernel=multichannel_kernel,
            method=_resolve_auto(method))
        x, was_numpy = _adapt_in(images, dev)
        out = deblur_patches(
            x, patch_size=self.patch_size, overlap=self.patch_overlap,
            batch_size=self.batch_size, device=dev,
            **cfg.traced_kwargs(), **cfg.static_kwargs())
        return to_array(out) if was_numpy else out
