"""Overlapping-patch engine: tiled deblurring with windowed overlap-add.

The reference's patch decomposition (deblurring.py:266-394): the image is
even-cropped, replicate-padded to a tile grid, every tile is deblurred with
its own blur estimate, and the tiles are blended back by a Kaiser-windowed
overlap-add. On the card the path is the kernels of ``ops/cuda``:

    edge_pad_cast -> N x (tile_estimate, kernel_spectrum, spectral_gemm x 4)
                  -> blend_overlap_add

Tiles are cut from the padded canvas by index (no extracted tile tensor);
every regular grid and every batch size takes this one route, with the
feature flags (prefilter, edgetaper, halo removal) as stages of
``pipeline.restore_tiles``, wherever the JAX package's mega-kernel routes
take the configuration (their static predicate on the tile size,
``pipeline.mega_padded_eligible``: ``'direct_separable'``, no ``remat``,
q = 0, no saturation mask or multichannel kernel, ker_size 25, 6 + 1 angles
interpolated to 30, the bilateral or domain-transform smoother, tiles
within ``pipeline.mega_tile_cap``). Every other configuration, and every
irregular grid (an overlap past 50%, or coordinates off one step), takes
the composed route of the JAX package (patches.py:479-500): extract the
tiles, run ``pipeline.polyblur_core`` on them, blend. An irregular grid
is blended by plain PyTorch slice-adds in the grid's coordinate order,
as the JAX package's scatter-add chain (patches.py:268-300).

Both routes are differentiable in the image and in (c, b, alpha, beta),
with every feature flag. The staged route is a chain of three autograd
Functions mirroring the JAX package's custom VJPs: ``edge_pad_cast``,
``polyblur_image_fused`` and ``blend_overlap_add``, for every batch
size; each runs its kernels forward and autograd of its plain versions
backward, except that with a flag on ``polyblur_image_fused``'s
backward replays the scan route on all the grid tiles as one batch (its
taper normalized by the batch-global maximum), as the JAX package's
flagged VJPs do.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .ops.cuda.overlap_add import blend_overlap_add
from .ops.cuda.pad_cast import edge_pad_cast
from .ops.cuda.polyblur_fused import polyblur_image_fused
from .pipeline import (_mega_pack, mega_padded_eligible, polyblur_core,
                       prefilter_of, resolve_device)
from .utils.imaging import build_window_np, clip_as_jax
from .utils.profiling import annotate, record_dispatch, span

__all__ = ["PatchGrid", "plan_patch_grid", "extract_patches", "overlap_add",
           "deblur_patches"]


class PatchGrid(NamedTuple):
    """Static tiling plan."""
    orig_size: tuple          # (h, w) after the even-crop
    padded_size: tuple        # (H, W) of the padded canvas
    patch_size: tuple         # (ph, pw)
    coords: tuple             # ((i0, j0), ...) top-left corners
    pad: tuple                # (top, bottom, left, right)


def plan_patch_grid(h: int, w: int, patch_size=400,
                    overlap=0.25) -> PatchGrid:
    """The tile grid of deblurring.py:281-298. ``patch_size`` / ``overlap``
    take an int/float (square tiles) or an ``(h, w)`` pair. The step is
    truncated, ``int(p * (1 - overlap))``, never rounded, as in the
    reference."""
    h -= h % 2
    w -= w % 2
    ph, pw = ((patch_size, patch_size) if isinstance(patch_size, int)
              else (int(patch_size[0]), int(patch_size[1])))
    ov_h, ov_w = ((overlap, overlap) if isinstance(overlap, (int, float))
                  else (overlap[0], overlap[1]))
    step_h = int(ph * (1.0 - ov_h))
    step_w = int(pw * (1.0 - ov_w))
    new_h = int(math.ceil(max(h - ph, 0) / step_h) * step_h) + ph
    new_w = int(math.ceil(max(w - pw, 0) / step_w) * step_w) + pw
    pad_top = (new_h - h) // 2
    pad_bottom = new_h - h - pad_top
    pad_left = (new_w - w) // 2
    pad_right = new_w - w - pad_left
    coords = tuple(
        (int(i), int(j))
        for i in np.arange(0, new_h - ph + 1, step_h)
        for j in np.arange(0, new_w - pw + 1, step_w)
    )
    return PatchGrid((h, w), (new_h, new_w), (ph, pw), coords,
                     (pad_top, pad_bottom, pad_left, pad_right))


def _grid_steps(grid: PatchGrid):
    """(Th, Tw, step_h, step_w) if the tile grid is regular and the overlap
    is at most 50% per axis, else None."""
    ph, pw = grid.patch_size
    H, W = grid.padded_size
    rows = sorted({i for (i, _) in grid.coords})
    cols = sorted({j for (_, j) in grid.coords})
    if len(grid.coords) != len(rows) * len(cols):
        return None
    step_h = rows[1] - rows[0] if len(rows) > 1 else ph
    step_w = cols[1] - cols[0] if len(cols) > 1 else pw
    if rows != [k * step_h for k in range(len(rows))]:
        return None
    if cols != [k * step_w for k in range(len(cols))]:
        return None
    if not (ph // 2 <= step_h <= ph and pw // 2 <= step_w <= pw):
        return None
    if (len(rows) - 1) * step_h + ph != H or (len(cols) - 1) * step_w + pw != W:
        return None
    return len(rows), len(cols), step_h, step_w


def extract_patches(images: torch.Tensor, grid: PatchGrid) -> torch.Tensor:
    """(B, C, H, W) -> (T*B, C, ph, pw) tile batch (T outer, B inner). The
    canvas comes from :func:`edge_pad_cast` (the kernel on CUDA tensors)."""
    padded = edge_pad_cast(images, grid.orig_size, grid.pad)
    ph, pw = grid.patch_size
    tiles = torch.stack([padded[..., i0:i0 + ph, j0:j0 + pw]
                         for (i0, j0) in grid.coords])
    return tiles.reshape((-1,) + tiles.shape[2:])


@functools.lru_cache(maxsize=4)
def _blend_constants(grid: PatchGrid, window_type: str, device):
    """(window (ph, pw), reciprocal window sum (H, W)) as f32 tensors; the
    sum and its reciprocal are taken in float64 on the host. Cached per
    grid: at 12 MP the host sum and its copy to the card would otherwise
    cost several times the whole device path."""
    ph, pw = grid.patch_size
    window_np = build_window_np((ph, pw), window_type)
    wsum = np.zeros(grid.padded_size, np.float64)
    for (i0, j0) in grid.coords:
        wsum[i0:i0 + ph, j0:j0 + pw] += window_np
    inv = (1.0 / (wsum + 1e-8)).astype(np.float32)
    return (torch.as_tensor(window_np, device=device),
            torch.as_tensor(inv, device=device))


def overlap_add(patches: torch.Tensor, grid: PatchGrid, batch: int,
                window_type: str = "kaiser", out_dtype=None) -> torch.Tensor:
    """Blend (T*B, C, ph, pw) tiles back into (B, C, h, w): windowed sum,
    times the reciprocal window sum, clipped to [0, 1], cropped to the
    original content; ``out_dtype`` defaults to the tile dtype. A regular
    grid accumulates in f32 (:func:`blend_overlap_add`), an irregular one
    in the wider of the tile and output dtypes
    (:func:`_overlap_add_irregular`)."""
    reg = _grid_steps(grid)
    if reg is None:
        return _overlap_add_irregular(patches, grid, batch, window_type,
                                      out_dtype)
    window, inv_wsum = _blend_constants(grid, window_type, patches.device)
    pt, _, pl, _ = grid.pad
    h, w = grid.orig_size
    return blend_overlap_add(patches, window, inv_wsum,
                             reg + grid.patch_size, batch, (pt, pl, h, w),
                             out_dtype)


def _overlap_add_irregular(patches: torch.Tensor, grid: PatchGrid,
                           batch: int, window_type: str,
                           out_dtype) -> torch.Tensor:
    """The JAX package's blend of an irregular grid (patches.py:268-300),
    in plain PyTorch: the windowed tiles summed by slice-adds in
    ``grid.coords`` order (its ``.at[].add`` chain; a slice-add, unlike
    ``index_add_`` on the card, adds in one fixed order, and its backward
    is slicing), times the f32 reciprocal window sum, clipped, cast and
    cropped, all in the wider of the tile and output dtypes."""
    ph, pw = grid.patch_size
    H, W = grid.padded_size
    blend_dt = patches.dtype
    if (out_dtype is not None and torch.finfo(out_dtype).bits
            > torch.finfo(blend_dt).bits):
        blend_dt = out_dtype
    window, inv_wsum = _blend_constants(grid, window_type, patches.device)
    tiles = patches[..., :pw].to(blend_dt) * window.to(blend_dt)
    tiles = tiles.reshape(len(grid.coords), batch, -1, ph, pw)
    out = tiles.new_zeros((batch, tiles.shape[2], H, W))
    for t, (i0, j0) in enumerate(grid.coords):
        out[..., i0:i0 + ph, j0:j0 + pw] += tiles[t]
    out = clip_as_jax(out * inv_wsum.to(blend_dt))
    if out_dtype is not None:
        out = out.to(out_dtype)
    pt, _, pl, _ = grid.pad
    h, w = grid.orig_size
    return out[..., pt:pt + h, pl:pl + w]


def _join_axis(tiles: torch.Tensor, s: int, p: int,
               axis: int) -> torch.Tensor:
    """Overlap-add of a regular tile axis: ``canvas[..., k*s + i, ...] +=
    tiles[k][..., i, ...]`` for T tiles of length ``p`` at step ``s``
    (``p - s <= s``), by one reshape per half and one shifted add, no
    scatter (polyblur_tpu/patches.py:144-175, the same adds in the same
    order). ``axis`` indexes the per-tile layout ``tiles.shape[1:]``; the
    joined axis, of length ``(T - 1) s + p``, takes its place. An axis
    second from last keeps the last axis in place, as in the JAX
    package."""
    pad = torch.nn.functional.pad
    o = p - s
    T = tiles.shape[0]
    axis = axis % (tiles.dim() - 1)
    L = T * s + o
    if axis + 1 == tiles.dim() - 2:
        w = tiles.shape[-1]
        x = torch.movedim(tiles, 0, -3)                 # (..., T, p, W)
        lead = x.shape[:-3]
        canvas = pad(x[..., :s, :].reshape(lead + (T * s, w)), (0, 0, 0, o))
        if o:
            rights = pad(x[..., s:, :], (0, 0, 0, s - o))
            rights = rights.reshape(lead + (T * s, w))[..., :L - s, :]
            canvas = canvas + pad(rights, (0, 0, s, 0))
        return canvas
    x = torch.movedim(tiles, axis + 1, -1)              # (T, ..., p)
    x = torch.movedim(x, 0, -2)                         # (..., T, p)
    lead = x.shape[:-2]
    canvas = pad(x[..., :s].reshape(lead + (T * s,)), (0, o))
    if o:
        rights = pad(x[..., s:], (0, s - o)).reshape(lead + (T * s,))
        canvas = canvas + pad(rights[..., :L - s], (s, 0))
    return torch.movedim(canvas, -1, axis)


def _restoration_params(n_iter: int = 1, c=0.352, b=0.768, alpha=2.0,
                        beta=3.0, sigma_r=0.8, sigma_s=2.0,
                        remove_halo: bool = False, edgetaping: bool = False,
                        prefiltering: bool = False,
                        smoother: str = "bilateral", **_static):
    """(n_iter, (c, b, alpha, beta, sigma_s, sigma_r), the feature-flag
    keywords of ``pipeline.restore_tiles``) of a configuration
    ``pipeline.mega_padded_eligible`` admits (its other keywords are those
    the predicate read). The prefilter is ``'dt'`` for the
    domain-transform smoother and ``'bilateral'`` otherwise
    (polyblur_tpu/patches.py:395-403)."""
    flags = dict(do_taper=bool(edgetaping), do_halo=bool(remove_halo),
                 prefilter=prefilter_of(prefiltering, smoother))
    return int(n_iter), (c, b, alpha, beta, sigma_s, sigma_r), flags


_CORE_KEYWORDS = frozenset(inspect.signature(polyblur_core).parameters
                           ) - {"img", "device"}


@annotate("pb.deblur_patches")
def deblur_patches(images, patch_size=400, overlap=0.25,
                   window_type: str = "kaiser",
                   batch_size: Optional[int] = None, out_dtype=None,
                   work_dtype=None, device=None, **polyblur_kwargs) -> torch.Tensor:
    """Whole patch path: pad -> per-tile blind deblurring -> overlap-add.

    :param images: (B, C, H, W) tensor or array in [0, 1]; moved to
        ``device``
    :param device: where to run (default ``"cuda"``; raises when CUDA is
        missing — pass ``"cpu"`` for the plain PyTorch path)
    :param work_dtype: dtype the tiles are computed in (default: the input
        dtype); an f32 image with ``work_dtype=torch.bfloat16`` is the
        serving configuration — the cast rides the canvas edge-pad's pass
    :param out_dtype: output dtype (default: the working dtype); a regular
        grid's blend accumulates in f32, an irregular one's in the wider
        of the working and output dtypes (:func:`overlap_add`)
    :param batch_size: at most this many tile coordinates per pass through
        the stages (the memory ceiling of the reference's host loop);
        ``None`` or ``<= 0`` runs every tile at once
    :param overlap: any overlap in [0, 1) per axis; past 50% the grid is
        irregular and takes the composed route
    :param polyblur_kwargs: the pipeline keywords (n_iter, c, b, alpha,
        beta, remove_halo, edgetaping, prefiltering, smoother, ...).
        ``method='direct_separable'`` takes the staged route where the
        JAX package's mega kernels would
        (``pipeline.mega_padded_eligible``); ``'fft'``, the
        default as in the JAX package, ``'direct'``, ``remat=True``, the
        estimate's other branches, the ``'nc'`` smoother and tiles past
        ``pipeline.mega_tile_cap`` the composed one. ``c, b, alpha, beta``
        (and ``sigma_s``, ``sigma_r``) may be 0-d tensors: the result is
        differentiable in them and in ``images``, flags included.
    :returns: (B, C, h, w) with (h, w) the even-cropped input size
    """
    dev = resolve_device(device)
    x = torch.as_tensor(images, device=dev)
    if x.dim() != 4:
        raise ValueError(f"expected a (B, C, H, W) image batch, got "
                         f"{tuple(x.shape)}")
    unknown = sorted(set(polyblur_kwargs) - _CORE_KEYWORDS)
    if unknown:
        # both routes refuse what polyblur_core would: the staged route
        # reads only some of the keywords
        raise TypeError(f"deblur_patches: unexpected keyword(s) {unknown}")
    with span("pb.plan"):
        b = x.shape[0]
        grid = plan_patch_grid(x.shape[-2], x.shape[-1], patch_size, overlap)
        reg = _grid_steps(grid)
        wd = work_dtype or x.dtype
        n_tiles = len(grid.coords)
        chunk = (n_tiles if batch_size is None or batch_size <= 0
                 else min(batch_size, n_tiles))
        gi = None if reg is None else reg + grid.patch_size
        staged = gi is not None and mega_padded_eligible(gi,
                                                         **polyblur_kwargs)
    if not staged:
        # as the JAX package: its mega-kernel routes refuse these
        record_dispatch("deblur_patches", "composed")
        tiles = extract_patches(x.to(wd), grid)
        restored = torch.cat([
            polyblur_core(tiles[t0 * b:(t0 + chunk) * b], device=dev,
                          **polyblur_kwargs)
            for t0 in range(0, n_tiles, chunk)])
        return overlap_add(restored, grid, b, window_type, out_dtype)
    record_dispatch("deblur_patches", "staged_tiles")
    with span("pb.pad"):
        canvas = edge_pad_cast(x, grid.orig_size, grid.pad, wd)
    # the plan's second part, after the pad's launch: the coefficients'
    # copy from pageable host memory synchronizes the stream
    with span("pb.plan"):
        n_iter, params, flags = _restoration_params(**polyblur_kwargs)
        coeffs = _mega_pack(*params, device=dev)
        window, inv_wsum = _blend_constants(grid, window_type, dev)
    pt, _, pl, _ = grid.pad
    h, w = grid.orig_size
    state = polyblur_image_fused(canvas, coeffs, n_iter, gi, chunk, **flags)
    with span("pb.blend"):
        return blend_overlap_add(state, window, inv_wsum, gi, b,
                                 (pt, pl, h, w), out_dtype)
