"""The differentiable deblurring layer (port of polyblur_tpu/layers.py).

The reference exposes Polyblur as a parameterless ``torch.nn.Module`` so it
can sit inside training losses (deblurring.py:250-268, README.md:69-80).
Here:

* :class:`PolyblurLayer` — an ``nn.Module`` with the JAX layer's fields.
  With ``learnable=True`` the pipeline scalars (c, b, alpha, beta) are f32
  ``nn.Parameter`` s initialized at the given values (its ``state_dict``
  holds them under those names), so a training loop can fit the
  deblurring strength end to end (BASELINE config 5).
* :func:`polyblur_apply` — the functional form.

Gradients run through the kernels' autograd Functions (forward on the
card, plain PyTorch backward; ``ops/cuda/autograd.py``), with any feature
flag in ``extra`` (``prefiltering``, ``edgetaping``, ``remove_halo``): the
tiles and patch routes' backward then replays the scan route on their
tiles, the bilateral filter and the IIR scans replay their plain
versions.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from .patches import deblur_patches
from .pipeline import polyblur_core, resolve_device

__all__ = ["PolyblurLayer", "polyblur_apply", "SCALARS"]

#: the learnable scalars, in the JAX layer's order of declaration
SCALARS = ("c", "b", "alpha", "beta")


def polyblur_apply(img, c=0.362, b=0.468, alpha=2.0, beta=4.0,
                   **static_kwargs) -> torch.Tensor:
    """Functional layer: ``polyblur_core`` differentiable in ``img`` and
    in the four scalars (Python numbers or 0-d tensors; clip and argmin
    have gradients defined almost everywhere)."""
    return polyblur_core(img, c=c, b=b, alpha=alpha, beta=beta,
                         **static_kwargs)


class PolyblurLayer(nn.Module):
    """Deblurring layer.

    :param n_iter: Polyblur iterations
    :param c, b, alpha, beta: the pipeline scalars (initial values when
        ``learnable``)
    :param learnable: make (c, b, alpha, beta) f32 parameters
    :param method: ``'fft'`` (exact), ``'direct_separable'`` (the
        kernels' route) or ``'direct'`` (spatial convolutions, the
        reference's method on CUDA)
    :param remat: checkpoint each iteration (recomputed in the backward)
    :param patch_size: > 0 routes the forward through the patch engine
        (``deblur_patches``) with ``patch_overlap``: the megapixel
        training configuration
    :param extra: further keywords of ``polyblur_core`` (or of
        ``deblur_patches``, e.g. ``work_dtype``, ``out_dtype``)
    :param device: where the layer runs (default ``"cuda"``; raises
        without a card — pass ``"cpu"`` for the plain PyTorch path)

    Example::

        layer = PolyblurLayer(n_iter=2, learnable=True)
        out = layer(blurry)
    """

    def __init__(self, n_iter: int = 3, c: float = 0.362, b: float = 0.468,
                 alpha: float = 6.0, beta: float = 1.0,
                 learnable: bool = False, method: str = "fft",
                 remat: bool = False, patch_size: int = 0,
                 patch_overlap: float = 0.25, extra: Optional[dict] = None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.n_iter = int(n_iter)
        self.learnable = bool(learnable)
        self.method = method
        self.remat = bool(remat)
        self.patch_size = int(patch_size)
        self.patch_overlap = patch_overlap
        self.extra: Any = extra
        for name, v in zip(SCALARS, (c, b, alpha, beta)):
            if learnable:
                setattr(self, name, nn.Parameter(torch.tensor(
                    float(v), dtype=torch.float32, device=self.device)))
            else:
                setattr(self, name, float(v))

    def forward(self, img) -> torch.Tensor:
        x = torch.as_tensor(img, device=self.device)
        kw = dict(self.extra or {})
        scalars = {name: getattr(self, name) for name in SCALARS}
        if self.patch_size > 0:
            return deblur_patches(x, patch_size=self.patch_size,
                                  overlap=self.patch_overlap,
                                  n_iter=self.n_iter, method=self.method,
                                  remat=self.remat, device=self.device,
                                  **scalars, **kw)
        return polyblur_core(x, n_iter=self.n_iter, method=self.method,
                             remat=self.remat, device=self.device,
                             **scalars, **kw)
