"""The Polyblur main loop: estimate -> polynomial deconvolution, iterated.

Two routes, dispatched as the JAX package's ``polyblur_core`` dispatches
(polyblur_tpu/pipeline.py:182-264), with the card in the TPU's place:

* the tiles route: images up to ``MEGA_MAX_TILE`` with the
  ``direct_separable`` method run :func:`restore_tiles` on the image as one
  tile. The TPU mega kernel runs the N iterations of one tile inside one
  VMEM-resident program; here each stage runs over all tiles at once, with
  the intermediates in device memory: per iteration ``tile_estimate``
  (4 launches), ``kernel_spectrum`` (1) and the four ``spectral_gemm``
  products of ``spectral_poly``. The state is stored in the work dtype
  after every iteration, as the TPU kernel stores it. The patch engine
  runs the same loop over its tiles.
* the scan route: every other image and method (``'fft'``, ``'direct'``,
  the estimate's other branches, the ``'nc'`` smoother), a Python loop of
  the whole-image estimate (``estimation.gaussian_blur_estimation``), the
  optional edge-aware prefilter (:func:`edge_aware_filtering`) and
  ``restoration.inverse_filtering_rank3`` (with the optional edgetaper and
  halo masking).

The feature flags run on both routes. On the tiles route they are stages
of :func:`restore_tiles` (the counterpart of the TPU kernel's in-kernel
flags, polyblur_fused.py:374-517): the prefilter (``bilateral`` or the
one-iteration domain transform ``dt``), the taper (3 blends with the
degree-1 operator), the polynomial, the halo mask and the noise, in the
TPU kernel's order and rounding (f32 between the stages, the work dtype
only for the DFT operands and the stored state).

The routes do not depend on the device: a CPU tensor runs every kernel's
plain version along the route the card would take.

Both routes are differentiable in the image and in (c, b, alpha, beta),
with every feature flag: the tiles route through one autograd Function
(``ops.cuda.polyblur_fused.polyblur_tiles_fused``: its kernels forward;
backward, autograd of :func:`restore_tiles`' plain versions without a
flag, and with one of :func:`_ref_pipeline`, the scan route on the same
tiles, as the JAX package's custom VJPs replay it), the scan route
through the Functions of its kernels (the bilateral filter and the IIR
scans among them) and plain PyTorch, also in ``sigma_s`` / ``sigma_r``.
Its clips follow ``jnp.clip``'s tie rule while a graph is recorded
(``utils.imaging.clip_as_jax``). As in the JAX package, ``remat=True``
refuses the tiles route, sends the scan route's polynomial down the plain
composition (``prefer_xla``) and checkpoints each iteration
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on the
scan body, polyblur_tpu/pipeline.py:232-264).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

from .envelopes import MEGA_MAX_TILE, MEGA_MAX_TILE_DT
from .estimation import gaussian_blur_estimation
from .ops.bilateral import bilateral_filter
from .ops.cuda._build import plain_mode, plain_versions
from .ops.cuda.autograd import records_graph
from .ops.cuda.bilateral import bilateral
from .ops.cuda.features import halo_grads, halo_mask, taper_weights
from .ops.cuda.iir import dt_scan_rows, scan_cols
from .ops.cuda.polyblur_fused import (HALF, TileView, kernel_spectrum,
                                      polyblur_image_fused,
                                      polyblur_tiles_fused, spectral_poly,
                                      stage_tables, tile_estimate)
from .ops.domain_transform import normalized_convolution, recursive_filter
from .ops.fourier import spectral_gradients
from .ops.sep_poly import f32_vector
from .restoration import inverse_filtering_rank3, polynomial_coefficients
from .utils.imaging import clip_as_jax
from .utils.profiling import annotate, record_dispatch, span

__all__ = ["restore_tiles", "_mega_pack", "_ref_pipeline", "polyblur_core",
           "mega_tile_cap", "resolve_device", "edge_aware_filtering",
           "prefilter_of", "mega_padded_eligible", "mega_restore_padded"]

_N_TAPERS = 3


def _mega_pack(c, b, alpha, beta, sigma_s, sigma_r,
               device=None) -> torch.Tensor:
    """(8,) f32 coefficient vector of the per-tile stages:
    [a3, a2, a1, beta, c, b, sigma_s, sigma_r]. Each value is a Python
    number or a 0-d tensor; tensors stay in the autograd graph."""
    a3, a2, a1 = polynomial_coefficients(alpha, beta)
    return f32_vector((a3, a2, a1, beta, c, b, sigma_s, sigma_r), device)


def prefilter_of(prefiltering: bool, smoother: str):
    """The tiles route's prefilter for the pipeline's keywords: None,
    ``'dt'`` for the domain transform, else ``'bilateral'`` (as
    polyblur_tpu/patches.py:395-403 and pipeline.py:216-218 map them)."""
    if not prefiltering:
        return None
    return "dt" if smoother == "domain_transform" else "bilateral"


@functools.lru_cache(maxsize=4)
def _unit_horner(device: str) -> torch.Tensor:
    """Horner coefficients (0, 0, 1, 0): the degree-1 spectrum p(z) = z."""
    return torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=torch.float32,
                        device=device)


def _restore_iteration(src: TileView, est: torch.Tensor,
                       qhat2: torch.Tensor, coeffs: torch.Tensor, tables,
                       out: torch.Tensor | None, do_taper: bool, grads,
                       prefilter) -> torch.Tensor:
    """One iteration's restoration, into ``out`` (a new tensor when None;
    polyblur_fused.py:473-517). With no flag it is one ``p(K)``
    application, clipped; the flags add their stages: smooth + noise from
    the iterate, the replicate-padded smooth part tapered 3 times, ``o =
    crop(p(K) xc)`` unclipped, the halo mask against ``crop(xc)``, clip,
    ``+ noise``, clip. Everything between the stages is f32."""
    f32 = torch.float32
    noise = None
    base = src
    if prefilter is not None:
        with span("pb.prefilter"):
            if prefilter == "bilateral":
                # the mega kernel's prefilter ignores sigma_s / sigma_r:
                # (5, 5, 0.1)
                smooth, noise = bilateral(src, out_dtype=f32,
                                          with_noise=True)
            else:
                rows, v_v = dt_scan_rows(src, coeffs)
                smooth, noise = scan_cols(rows, v_v, src=src)
        base = TileView.of_tiles(smooth)
    poly_src, poly_src1, pad, ucmp = base, None, HALF, base
    if do_taper:
        with span("pb.taper"):
            n, c = src.n, src.channels
            h, wc = tables.h, tables.wc
            khat2 = kernel_spectrum(est, _unit_horner(str(est.device)),
                                    tables)
            av, ah = taper_weights(est, h, wc)
            xc = torch.empty((n, c, h, wc), dtype=f32, device=est.device)
            # in a bf16 work dtype the canvas also in bf16, which the next
            # product reads as rounded (the first product rounds what it
            # reads to the work dtype)
            wd = tables.fwd_t.dtype
            xr = torch.empty_like(xc, dtype=wd) if wd == torch.bfloat16 \
                else None
            u, u1, pad = base, None, HALF
            for _ in range(_N_TAPERS):
                # xc = a u + (1 - a) K u, blended in the product's epilogue
                spectral_poly(u, khat2, tables, xc, pad=pad, crop=0,
                              clip=False, out_dtype=f32, taper=(av, ah),
                              rounded=xr, view1=u1)
                u, pad = TileView.of_tiles(xc), 0
                u1 = None if xr is None else TileView.of_tiles(xr)
            poly_src, poly_src1 = u, u1
            ucmp = TileView.of_tiles(xc[:, :, HALF:h - HALF, HALF:wc - HALF])
    if grads is not None:
        with span("pb.polynomial"):
            o = spectral_poly(poly_src, qhat2, tables, pad=pad, clip=False,
                              out_dtype=f32, view1=poly_src1)
        with span("pb.halo"):
            return halo_mask(o, grads, ucmp, noise, out)
    with span("pb.polynomial"):
        return spectral_poly(poly_src, qhat2, tables, out, pad=pad,
                             noise=noise, view1=poly_src1)


@annotate("pb.restore_tiles")
def restore_tiles(tiles, coeffs: torch.Tensor, n_iter: int,
                  out: torch.Tensor | None = None, do_taper: bool = False,
                  do_halo: bool = False, prefilter=None) -> torch.Tensor:
    """N blind Polyblur iterations on every tile of ``tiles``.

    :param tiles: a :class:`TileView` (tiles cut from a canvas without a
        copy) or an (N, C, ph, pw) tile batch, in the work dtype
    :param coeffs: (8,) f32 from :func:`_mega_pack`, on the tiles' device
    :param out: optional (N, C, ph, pw) destination
    :param do_taper, do_halo, prefilter: the feature flags (prefilter in
        {None, 'bilateral', 'dt'}); the halo mask's input gradients come
        from the tiles as given, once per call
    :returns: the restored (N, C, ph, pw) tiles in the work dtype

    While autograd records a graph through the tiles or ``coeffs`` (the
    plain replay of the tiles-level Functions without a flag) every
    iteration writes a new tensor: no write lands in a tensor the graph
    has read, and ``out`` must be None. With a flag on, the tiles-level
    Functions run this only forward: their backward replays the scan
    route (:func:`_ref_pipeline`), so the flag stages need no graph.
    """
    if prefilter not in (None, "bilateral", "dt"):
        raise ValueError(f"unknown tiles-route prefilter {prefilter!r}")
    view = tiles if isinstance(tiles, TileView) else TileView.of_tiles(tiles)
    ph, pw = view.patch
    data = view.data
    graph = records_graph(data, coeffs)
    if n_iter < 1:
        if out is None:
            return view.tiles().clone()
        out.copy_(view.tiles())
        return out
    if out is None and not graph:
        out = torch.empty((view.n, view.channels, ph, pw), dtype=data.dtype,
                          device=data.device)
    tables = stage_tables(ph, pw, data.dtype, str(data.device))
    grads = None
    if do_halo:
        with span("pb.halo"):
            grads = halo_grads(view)
    src = view
    for _ in range(n_iter):
        with span("pb.estimate"):
            est = tile_estimate(src, coeffs)
        with span("pb.spectrum"):
            qhat2 = kernel_spectrum(est, coeffs, tables)
        res = _restore_iteration(src, est, qhat2, coeffs, tables, out,
                                 do_taper, grads, prefilter)
        src = TileView.of_tiles(res)
    return res


def _ref_pipeline(tiles: torch.Tensor, coeffs: torch.Tensor, n_iter: int,
                  do_taper: bool = False, do_halo: bool = False,
                  prefilter=None) -> torch.Tensor:
    """The scan route on a tile batch, with the feature flags of the tiles
    route: what the tiles-level Functions' backward replays with a flag on
    (polyblur_tpu/ops/pallas/polyblur_fused.py:912-929). ``polyblur_core``
    with ``method='direct_separable'`` and the tiles route disabled, on the
    tiles' device and dtype, all tiles as one batch: the edgetaper then
    divides by the batch-global maximum (``edgetaper.py``), where the
    kernels' forward divides per tile, as in the JAX package. alpha comes
    back from the Horner coefficients, ``2 (a3 + beta - 2)``; (c, b,
    sigma_s, sigma_r) are ``coeffs[4:8]``, in the graph."""
    a3, beta = coeffs[0], coeffs[3]
    smoother = "domain_transform" if prefilter == "dt" else "bilateral"
    return polyblur_core(tiles, n_iter=n_iter, c=coeffs[4], b=coeffs[5],
                         alpha=2.0 * (a3 + beta - 2.0), beta=beta,
                         sigma_s=coeffs[6], sigma_r=coeffs[7],
                         method="direct_separable", edgetaping=do_taper,
                         remove_halo=do_halo,
                         prefiltering=prefilter is not None,
                         smoother=smoother, _disable_mega=True,
                         device=tiles.device)


def _same_mode():
    """``checkpoint``'s contexts: the recompute, on the autograd thread,
    runs the kernels or the plain versions as the forward's thread did."""
    return contextlib.nullcontext(), plain_versions(plain_mode())


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


def _mega_static_ok(method, remat, discard_saturation, multichannel_kernel,
                    prefiltering, smoother, q, ker_size, n_angles,
                    n_interpolated_angles, h, w, disable=False) -> bool:
    """Static eligibility of the tiles route: the JAX package's predicate
    (polyblur_tpu/pipeline.py:47-64, ``remat`` refuses it) with the card
    where it requires a TPU."""
    cap = mega_tile_cap(prefiltering, smoother)
    return (method == "direct_separable" and not disable and not remat
            and not (discard_saturation or multichannel_kernel)
            and (not prefiltering
                 or smoother in ("bilateral", "domain_transform"))
            and q == 0.0 and ker_size == 25 and n_angles == 6
            and n_interpolated_angles == 30
            and max(h, w) <= cap)


def mega_padded_eligible(grid_info, ker_size: int = 25, q: float = 0.0,
                         n_angles: int = 6, n_interpolated_angles: int = 30,
                         method: str = "fft", smoother: str = "bilateral",
                         prefiltering: bool = False,
                         discard_saturation: bool = False,
                         multichannel_kernel: bool = False,
                         remat: bool = False, _disable_mega: bool = False,
                         **_ignored) -> bool:
    """Whether :func:`mega_restore_padded` (and the patch engine's staged
    route) takes a grid of ``grid_info = (th, tw, step_h, step_w, ph,
    pw)`` tiles with these keywords: the JAX package's predicate
    (polyblur_tpu/pipeline.py:79-102) with the card in the TPU's place,
    on any device. Other keywords, the JAX package's ``_mega_interpret``
    among them, are ignored, as there."""
    ph, pw = grid_info[4:]
    return _mega_static_ok(method, remat, discard_saturation,
                           multichannel_kernel, prefiltering, smoother, q,
                           ker_size, n_angles, n_interpolated_angles, ph, pw,
                           disable=_disable_mega)


def mega_restore_padded(padded: torch.Tensor, grid_info, n_iter: int = 1,
                        c=0.352, b=0.768, alpha=2.0, beta=3.0, sigma_r=0.8,
                        sigma_s=2.0, ker_size: int = 25, q: float = 0.0,
                        n_angles: int = 6, n_interpolated_angles: int = 30,
                        remove_halo: bool = False, edgetaping: bool = False,
                        prefiltering: bool = False,
                        discard_saturation: bool = False,
                        multichannel_kernel: bool = False,
                        method: str = "fft", smoother: str = "bilateral",
                        remat: bool = False, _disable_mega: bool = False,
                        pad_lanes: bool = False):
    """The restored tiles of a pre-padded canvas, or None.

    :param padded: the (B, C, H, W) canvas of a regular tile grid (the
        replicate-padded image, e.g. from ``ops.cuda.pad_cast.
        edge_pad_cast``), in the work dtype
    :param grid_info: the static (th, tw, step_h, step_w, ph, pw) plan
    :param pad_lanes: the JAX package's padding of the tile width to 128
        TPU lanes for its fused overlap-add; the card's blend reads the
        tiles as they are, so it changes nothing here
    :returns: the restored (th tw B, C, ph, pw) tiles, tile-major (the
        ``extract_patches`` layout), or None where
        :func:`mega_padded_eligible` refuses the configuration (the caller
        then extracts the tiles and runs ``polyblur_core``)

    The counterpart of polyblur_tpu/pipeline.py:105-150: each tile is cut
    from the canvas by index (no extracted tile tensor), through
    ``ops.cuda.polyblur_fused.polyblur_image_fused`` (its kernels on a
    CUDA canvas, their plain versions on a CPU one), with the feature
    flags mapped as the JAX package maps them.
    """
    if not mega_padded_eligible(
            grid_info, method=method, remat=remat,
            discard_saturation=discard_saturation,
            multichannel_kernel=multichannel_kernel,
            prefiltering=prefiltering, smoother=smoother, q=q,
            ker_size=ker_size, n_angles=n_angles,
            n_interpolated_angles=n_interpolated_angles,
            _disable_mega=_disable_mega):
        return None
    record_dispatch("deblur_patches", "mega_image_dma")
    coeffs = _mega_pack(c, b, alpha, beta, sigma_s, sigma_r,
                        device=padded.device)
    return polyblur_image_fused(padded, coeffs, n_iter, tuple(grid_info),
                                do_taper=edgetaping, do_halo=remove_halo,
                                prefilter=prefilter_of(prefiltering,
                                                       smoother))


def _check_smoother(smoother: str) -> None:
    if smoother not in ("bilateral", "domain_transform", "nc"):
        raise ValueError(f"unknown smoother {smoother!r}")


def edge_aware_filtering(img: torch.Tensor, sigma_s, sigma_r,
                         smoother: str = "bilateral"):
    """Split an image into smooth + noise components (deblurring.py:99-110):
    the bilateral filter (5 x 5, sigma_spatial 5, sigma_color 0.1 — it does
    not read sigma_s / sigma_r), or one iteration of the domain transform:
    its recursive filter (``'domain_transform'``) or its normalized
    convolution (``'nc'``)."""
    _check_smoother(smoother)
    if smoother == "bilateral":
        smooth = bilateral_filter(img)
    elif smoother == "domain_transform":
        smooth = recursive_filter(img, sigma_s=sigma_s, sigma_r=sigma_r,
                                  num_iterations=1)
    else:
        smooth = normalized_convolution(img, sigma_s=sigma_s,
                                        sigma_r=sigma_r, num_iterations=1)
    return smooth, img - smooth


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
    blur from the current prediction, optionally split off the noise
    (``prefiltering`` with ``smoother``), apply the degree-3 polynomial
    inverse filter (optionally edge-tapered, ``edgetaping``, and
    halo-masked, ``remove_halo``, against gradients of the original input
    computed once), add the noise back, clip.

    :param img: (B, C, H, W) tensor or array in [0, 1], moved to ``device``
        (default ``"cuda"``; raises without a card — pass ``"cpu"`` for
        the plain PyTorch path)
    :param c, b, alpha, beta, sigma_s, sigma_r: Python numbers or 0-d
        tensors; the result is differentiable in them and in ``img``
        (in ``sigma_s`` / ``sigma_r`` through the domain transform)
    :param method: ``'fft'``, ``'direct_separable'`` (the kernels:
        the tiles route, else the scan route's spectral polynomial) or
        ``'direct'`` (three grouped spatial convolutions per iteration,
        ``ops.conv``)
    :param smoother: the prefilter's ``'bilateral'``,
        ``'domain_transform'`` or ``'nc'`` (normalized convolution)
    :param remat: checkpoint each iteration of the scan route (its
        activations are recomputed in the backward), with the polynomial
        on the plain composition and the tiles route refused, as the JAX
        package routes ``remat``
    :return: (B, C, H, W) restored images in the input dtype
    """
    dev = resolve_device(device)
    x = torch.as_tensor(img, device=dev)
    if x.dim() != 4:
        raise ValueError(f"expected a (B, C, H, W) image batch, got "
                         f"{tuple(x.shape)}")
    if prefiltering:
        _check_smoother(smoother)
    if _mega_static_ok(method, remat, discard_saturation,
                       multichannel_kernel, prefiltering, smoother, q,
                       ker_size, n_angles, n_interpolated_angles,
                       x.shape[-2], x.shape[-1], disable=_disable_mega):
        record_dispatch("polyblur_core", "tiles")
        coeffs = _mega_pack(c, b, alpha, beta, sigma_s, sigma_r, device=dev)
        return polyblur_tiles_fused(x, coeffs, n_iter, do_taper=edgetaping,
                                    do_halo=remove_halo,
                                    prefilter=prefilter_of(prefiltering,
                                                           smoother))
    record_dispatch("polyblur_core", f"scan/{method}")
    grad_img = spectral_gradients(x) if remove_halo else None
    # the separable route's kernels clip without features; every other
    # case takes one more clip, as the JAX package's scan body
    clip_again = (method != "direct_separable" or prefiltering
                  or remove_halo or edgetaping)

    def body(impred):
        kernel = gaussian_blur_estimation(
            impred, c=c, b=b, q=q, n_angles=n_angles,
            n_interpolated_angles=n_interpolated_angles, ker_size=ker_size,
            discard_saturation=discard_saturation,
            multichannel=multichannel_kernel,
            return_2d_filters=method != "direct_separable")
        noise = None
        if prefiltering:
            impred, noise = edge_aware_filtering(impred, sigma_s, sigma_r,
                                                 smoother=smoother)
        restored = inverse_filtering_rank3(
            impred, kernel, alpha=alpha, beta=beta, remove_halo=remove_halo,
            do_edgetaper=edgetaping, grad_img=grad_img, method=method,
            ker_size=ker_size, prefer_xla=remat)
        if noise is not None:
            restored = restored + noise
        # inverse_filtering_rank3 clips to [0, 1] on every route (the
        # separable route inside its kernel); the noise, the features and
        # the other methods take one more clip (pipeline.py:254-258): the
        # same values, and jnp.clip's half gradient at the bounds again
        return clip_as_jax(restored) if clip_again else restored

    impred = x
    for _ in range(int(n_iter)):
        if remat and torch.is_grad_enabled():
            impred = checkpoint(body, impred, use_reentrant=False,
                                context_fn=_same_mode)
        else:
            impred = body(impred)
    return impred
