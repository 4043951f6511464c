"""The Polyblur main loop: estimate -> polynomial deconvolution, iterated.

Two routes, dispatched as the JAX package's ``polyblur_core`` dispatches
(polyblur_tpu/pipeline.py:182-264), with the card in the TPU's place:

* the tiles route: images up to ``MEGA_MAX_TILE`` with the
  ``direct_separable`` method run :func:`restore_tiles` on the image as one
  tile. The TPU mega kernel runs the N iterations of one tile inside one
  VMEM-resident program; here each stage runs over all tiles at once, with
  the intermediates in device memory: per iteration ``tile_estimate``
  (3 launches), ``kernel_spectrum`` (1) and the four ``spectral_gemm``
  products of ``spectral_poly``. The state is stored in the work dtype
  after every iteration, as the TPU kernel stores it. The patch engine
  runs the same loop over its tiles.
* the scan route: every other image and method, a Python loop of the
  whole-image estimate (``estimation.gaussian_blur_estimation``) and
  ``restoration.inverse_filtering_rank3``.

The routes do not depend on the device: a CPU tensor runs every kernel's
plain version along the route the card would take.
"""

from __future__ import annotations

import torch

from .envelopes import MEGA_MAX_TILE, MEGA_MAX_TILE_DT
from .estimation import gaussian_blur_estimation
from .ops.cuda.polyblur_fused import (TileView, kernel_spectrum,
                                      polyblur_tiles_fused, spectral_poly,
                                      stage_tables, tile_estimate)
from .restoration import inverse_filtering_rank3, polynomial_coefficients
from .utils.profiling import record_dispatch

__all__ = ["restore_tiles", "_mega_pack", "polyblur_core", "mega_tile_cap",
           "resolve_device"]

_TODO_PREFILTER = ("ROADMAP B.8-B.10 (the prefilter: bilateral and "
                   "domain-transform smoothers)")
_TODO_FEATURES = "ROADMAP B.10 (halo removal and edgetaper)"


def _mega_pack(c, b, alpha, beta, sigma_s, sigma_r,
               device=None) -> torch.Tensor:
    """(8,) f32 coefficient vector of the per-tile stages:
    [a3, a2, a1, beta, c, b, sigma_s, sigma_r]."""
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    return torch.tensor([float(v) for v in (a3, a2, a1, beta, c, b, sigma_s,
                                            sigma_r)],
                        dtype=torch.float32, device=device)


def restore_tiles(tiles, coeffs: torch.Tensor, n_iter: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """N blind Polyblur iterations on every tile of ``tiles``.

    :param tiles: a :class:`TileView` (tiles cut from a canvas without a
        copy) or an (N, C, ph, pw) tile batch, in the work dtype
    :param coeffs: (8,) f32 from :func:`_mega_pack`, on the tiles' device
    :param out: optional (N, C, ph, pw) destination
    :returns: the restored (N, C, ph, pw) tiles in the work dtype
    """
    view = tiles if isinstance(tiles, TileView) else TileView.of_tiles(tiles)
    ph, pw = view.patch
    data = view.data
    if out is None:
        out = torch.empty((view.n, view.channels, ph, pw), dtype=data.dtype,
                          device=data.device)
    if n_iter < 1:
        out.copy_(view.tiles())
        return out
    tables = stage_tables(ph, pw, data.dtype, str(data.device))
    src = view
    for _ in range(n_iter):
        est = tile_estimate(src, coeffs)
        qhat2 = kernel_spectrum(est, coeffs, tables)
        spectral_poly(src, qhat2, tables, out)
        src = TileView.of_tiles(out)
    return out


def resolve_device(device) -> torch.device:
    """The device a call runs on: CUDA unless the caller asks for another;
    asking for (or defaulting to) CUDA without a card raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "polyblur_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def mega_tile_cap(prefiltering: bool, smoother: str) -> int:
    """Largest image edge of the tiles route for this feature set."""
    return (MEGA_MAX_TILE_DT
            if prefiltering and smoother == "domain_transform"
            else MEGA_MAX_TILE)


def _mega_static_ok(method, discard_saturation, multichannel_kernel,
                    prefiltering, smoother, q, ker_size, n_angles,
                    n_interpolated_angles, h, w, disable=False) -> bool:
    """Static eligibility of the tiles route: the JAX package's predicate
    with the card where it requires a TPU (and no ``remat``, which has no
    effect here)."""
    cap = mega_tile_cap(prefiltering, smoother)
    return (method == "direct_separable" and not disable
            and not (discard_saturation or multichannel_kernel)
            and (not prefiltering
                 or smoother in ("bilateral", "domain_transform"))
            and q == 0.0 and ker_size == 25 and n_angles == 6
            and n_interpolated_angles == 30
            and max(h, w) <= cap)


def polyblur_core(img, n_iter: int = 1, c=0.352, b=0.768, alpha=2.0,
                  beta=3.0, sigma_r=0.8, sigma_s=2.0, ker_size: int = 25,
                  q: float = 0.0, n_angles: int = 6,
                  n_interpolated_angles: int = 30, remove_halo: bool = False,
                  edgetaping: bool = False, prefiltering: bool = False,
                  discard_saturation: bool = False,
                  multichannel_kernel: bool = False, method: str = "fft",
                  smoother: str = "bilateral", remat: bool = False,
                  _disable_mega: bool = False, device=None) -> torch.Tensor:
    """Blind deblurring of a batch of whole images (deblurring.py:23-96,
    same defaults): per iteration, re-estimate the anisotropic Gaussian
    blur from the current prediction, apply the degree-3 polynomial
    inverse filter, clip.

    :param img: (B, C, H, W) tensor or array in [0, 1], moved to ``device``
        (default ``"cuda"``; raises without a card — pass ``"cpu"`` for
        the plain PyTorch path)
    :param remat: a memory knob of the JAX package's autodiff; no effect
        here (the port is forward-only)
    :return: (B, C, H, W) restored images in the input dtype
    """
    dev = resolve_device(device)
    x = torch.as_tensor(img, device=dev)
    if x.dim() != 4:
        raise ValueError(f"expected a (B, C, H, W) image batch, got "
                         f"{tuple(x.shape)}")
    if prefiltering:
        raise NotImplementedError(f"prefiltering: see {_TODO_PREFILTER}")
    if remove_halo or edgetaping:
        raise NotImplementedError(f"see {_TODO_FEATURES}")
    if _mega_static_ok(method, discard_saturation, multichannel_kernel,
                       prefiltering, smoother, q, ker_size, n_angles,
                       n_interpolated_angles, x.shape[-2], x.shape[-1],
                       disable=_disable_mega):
        record_dispatch("polyblur_core", "tiles")
        coeffs = _mega_pack(c, b, alpha, beta, sigma_s, sigma_r, device=dev)
        return polyblur_tiles_fused(x, coeffs, n_iter)
    record_dispatch("polyblur_core", f"scan/{method}")
    impred = x
    for _ in range(int(n_iter)):
        kernel = gaussian_blur_estimation(
            impred, c=c, b=b, q=q, n_angles=n_angles,
            n_interpolated_angles=n_interpolated_angles, ker_size=ker_size,
            discard_saturation=discard_saturation,
            multichannel=multichannel_kernel,
            return_2d_filters=method != "direct_separable")
        impred = inverse_filtering_rank3(impred, kernel, alpha=alpha,
                                         beta=beta, method=method,
                                         ker_size=ker_size)
        # inverse_filtering_rank3 clamps to [0, 1] on every route (the
        # separable route inside its kernel)
    return impred
