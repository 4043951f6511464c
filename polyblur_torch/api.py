"""Public API: the functional entry point and the stateless module.

Mirrors the reference surface (deblurring.py:23-96, :250-394), including
the NumPy adapter: ``(H, W)`` / ``(H, W, C)`` ndarrays are accepted and
returned as such; tensors must be ``(B, C, H, W)``. Calls run on
``device`` (default ``"cuda"``, raising when no card is available; pass
``"cpu"`` for the plain PyTorch path).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import FUNCTIONAL_DEFAULTS, MODULE_DEFAULTS
from .envelopes import (AUTO_TILE_MIN_AREA, BLOCKED_COST_MACS_PX,
                        TILE_FIXED_MACS)
from .patches import deblur_patches
from .pipeline import mega_tile_cap, polyblur_core, resolve_device
from .utils.imaging import clip_as_jax, to_array, to_tensor
from .utils.profiling import force_execution, record_dispatch, stage_timer

__all__ = ["polyblur_deblurring", "PolyblurDeblurring"]

#: Candidate (patch, step) grids of ``method='auto'`` tiling, as in the
#: JAX package (api.py:37), so that both tile the same images alike.
_TILE_CANDIDATES = ((576, 512), (448, 384), (320, 256))


def _auto_tile_wanted(h: int, w: int, cap: int) -> bool:
    """Whether ``method='auto'`` considers tiling: the image is past the
    tiles route's edge and at least ``AUTO_TILE_MIN_AREA`` pixels."""
    return max(h, w) > cap and h * w >= AUTO_TILE_MIN_AREA


def _tile_macs(ph: int, pw: int) -> float:
    """Modeled MACs of one patch-engine tile per channel and iteration:
    the x-DFT pair linear in width, the y-DFT pair quadratic in height,
    times the packed half-spectrum depth (the JAX package's model)."""
    hh, wc = ph + 24, pw + 24
    kp = -(-(wc // 2 + 1) // 128) * 128
    return float((2 * hh * wc + 4 * hh * hh) * 2 * kp)


def _auto_tile_plan(h: int, w: int, cap: int):
    """(patch_size, overlap) of the cheapest candidate tiling, or None when
    the whole-image blocked route is modeled cheaper (the JAX package's
    cost model and constants, not fitted to the H100)."""
    best = None
    for p, s in _TILE_CANDIDATES:
        if p > cap:
            continue
        ch = int(math.ceil(max(h - p, 0) / s)) * s + p
        cw = int(math.ceil(max(w - p, 0) / s)) * s + p
        n_tiles = ((ch - p) // s + 1) * ((cw - p) // s + 1)
        cost = n_tiles * (_tile_macs(p, p) + TILE_FIXED_MACS)
        if best is None or cost < best[0]:
            best = (cost, p, s)
    if best is not None and best[0] < BLOCKED_COST_MACS_PX * h * w:
        return best[1], (best[1] - best[2]) / best[1]
    return None


def _resolve_auto(method: str) -> str:
    """``'auto'`` -> ``'direct_separable'``: the reference's direct-on-CUDA
    selection (main.py:109-112), the JAX package's choice on its TPU."""
    return "direct_separable" if method == "auto" else method


def _run_verbose(x: torch.Tensor, cfg, dev: torch.device) -> torch.Tensor:
    """The reference's per-stage timing prints (deblurring.py:59-90), as
    the JAX package's ``_run_verbose`` (api.py:109-175): the scan route's
    stages run one by one, each forced to finish (the device synchronized)
    before its line is printed. The returned pixels are those of
    ``verbose=False``: the same stages as ``polyblur_core``'s scan route,
    and where ``polyblur_core`` takes the tiles route instead
    (``pipeline._mega_static_ok``), its result."""
    from .estimation import gaussian_blur_estimation
    from .ops.fourier import spectral_gradients
    from .pipeline import _mega_static_ok, edge_aware_filtering
    from .restoration import inverse_filtering_rank3

    start = time.time()
    impred = x
    grad_img = spectral_gradients(x) if cfg.remove_halo else None
    if grad_img is not None:
        force_execution(grad_img[0])
    print("-- init tensors:      %1.5f" % (time.time() - start))

    for n in range(cfg.n_iter):
        start = time.time()
        kernel = gaussian_blur_estimation(
            impred, c=cfg.c, b=cfg.b, q=cfg.q, n_angles=cfg.n_angles,
            n_interpolated_angles=cfg.n_interpolated_angles,
            ker_size=cfg.ker_size, discard_saturation=cfg.discard_saturation,
            multichannel=cfg.multichannel_kernel,
            return_2d_filters=cfg.method != "direct_separable")
        force_execution(kernel)
        print("-- blur estimation %d: %1.5f" % (n + 1, time.time() - start))

        start = time.time()
        noise = None
        if cfg.prefiltering:
            impred, noise = edge_aware_filtering(
                impred, cfg.sigma_s, cfg.sigma_r, smoother=cfg.smoother)
        impred = inverse_filtering_rank3(
            impred, kernel, alpha=cfg.alpha, beta=cfg.beta,
            remove_halo=cfg.remove_halo, do_edgetaper=cfg.edgetaping,
            grad_img=grad_img, method=cfg.method, ker_size=cfg.ker_size)
        if noise is not None:
            impred = impred + noise
        impred = clip_as_jax(impred)
        force_execution(impred)
        print("-- deblurring %d:      %1.5f" % (n + 1, time.time() - start))

    if _mega_static_ok(cfg.method, cfg.remat, cfg.discard_saturation,
                       cfg.multichannel_kernel, cfg.prefiltering,
                       cfg.smoother, cfg.q, cfg.ker_size, cfg.n_angles,
                       cfg.n_interpolated_angles, x.shape[-2], x.shape[-1]):
        return polyblur_core(x, device=dev, **cfg.traced_kwargs(),
                             **cfg.static_kwargs())
    return impred


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


def polyblur_deblurring(img, n_iter: int = 1, c=0.352, b=0.768, alpha=2.0,
                        beta=3.0, sigma_r=0.8, sigma_s=2.0,
                        ker_size: int = 25, q: float = 0.0,
                        n_angles: int = 6, n_interpolated_angles: int = 30,
                        remove_halo: bool = False, edgetaping: bool = False,
                        prefiltering: bool = False,
                        discard_saturation: bool = False,
                        multichannel_kernel: bool = False,
                        method: str = "auto", verbose: bool = False,
                        device=None):
    """Blind deblurring of mildly blurred image(s) — functional Polyblur.

    The reference's 17-keyword surface (deblurring.py:23-96) and defaults,
    except ``method``: ``'auto'`` resolves to ``'direct_separable'`` and,
    for images of at least 4 MP past the tiles route's 640 px edge, runs
    the overlapping-patch engine on the cheapest of the 576/512, 448/384
    and 320/256 grids (blur estimated per tile), exactly the images the
    JAX package tiles on its TPU. Everything smaller, and every explicit
    ``method``, runs whole-image (``pipeline.polyblur_core``). Odd sizes
    are edge-padded to even around the patch engine, so the output shape
    always matches the input.

    :param img: numpy ``(H, W)``/``(H, W, C)`` image or ``(B, C, H, W)``
        tensor in [0, 1]; the return type matches
    :param verbose: print the reference's per-stage timing lines
        (:func:`_run_verbose`; on the auto-tiled route one line for the
        whole patch engine); the returned pixels are those of
        ``verbose=False``
    :param device: where to run (default ``"cuda"``; raises without a
        card — pass ``"cpu"`` for the plain PyTorch path)
    """
    dev = resolve_device(device)
    x, was_numpy = _adapt_in(img, dev)
    cfg = FUNCTIONAL_DEFAULTS.replace(
        n_iter=n_iter, c=c, b=b, alpha=alpha, beta=beta, sigma_r=sigma_r,
        sigma_s=sigma_s, ker_size=ker_size, q=q, n_angles=n_angles,
        n_interpolated_angles=n_interpolated_angles, remove_halo=remove_halo,
        edgetaping=edgetaping, prefiltering=prefiltering,
        discard_saturation=discard_saturation,
        multichannel_kernel=multichannel_kernel,
        method=_resolve_auto(method))
    kw = dict(**cfg.traced_kwargs(), **cfg.static_kwargs())
    h, w = x.shape[-2:]
    plan = None
    if method == "auto":
        cap = mega_tile_cap(prefiltering, cfg.smoother)
        if _auto_tile_wanted(h, w, cap):
            plan = _auto_tile_plan(h, w, cap)
    if plan is not None:
        record_dispatch("polyblur_deblurring", f"auto_tiled/{plan[0]}")
        # the patch engine even-crops: edge-pad odd axes by one first
        xe = x
        if h % 2 or w % 2:
            xe = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
        with stage_timer("polyblur_deblurring (auto-tiled, incl. any "
                         "compile)", verbose=verbose):
            out = deblur_patches(xe, patch_size=plan[0], overlap=plan[1],
                                 batch_size=0, device=dev, **kw)
            if verbose:
                force_execution(out)
        out = out[..., :h, :w]
    elif verbose:
        out = _run_verbose(x, cfg, dev)
    else:
        out = polyblur_core(x, device=dev, **kw)
    return to_array(out) if was_numpy else out


class PolyblurDeblurring(nn.Module):
    """Stateless deblurring module with an optional overlapping-patch
    engine.

    Holds no parameters or buffers (as the reference module). The
    constructor stores the patch configuration and the device; ``forward``
    matches the reference's surface and defaults (deblurring.py:266-268).
    ``patch_decomposition=False`` runs whole-image (``polyblur_core``).
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
        dev = resolve_device(device if device is not None else self.device)
        cfg = MODULE_DEFAULTS.replace(
            n_iter=n_iter, c=c, b=b, alpha=alpha, beta=beta, sigma_r=sigma_r,
            sigma_s=sigma_s, ker_size=ker_size, q=q, n_angles=n_angles,
            n_interpolated_angles=n_interpolated_angles,
            remove_halo=remove_halo, edgetaping=edgetaping,
            prefiltering=prefiltering, discard_saturation=discard_saturation,
            multichannel_kernel=multichannel_kernel,
            method=_resolve_auto(method))
        x, was_numpy = _adapt_in(images, dev)
        kw = dict(**cfg.traced_kwargs(), **cfg.static_kwargs())
        if self.patch_decomposition:
            out = deblur_patches(
                x, patch_size=self.patch_size, overlap=self.patch_overlap,
                batch_size=self.batch_size, device=dev, **kw)
        else:
            out = polyblur_core(x, device=dev, **kw)
        return to_array(out) if was_numpy else out
