"""The per-tile stages of the patch engine and of the whole-image tiles
route: blur estimate, kernel spectrum and the spectral polynomial, as
kernels over a tile batch.

Replaces the TPU mega kernel polyblur_tpu/ops/pallas/polyblur_fused.py::
_make_kernel (blend, DMA and tiles modes). The TPU runs one program per
tile with every intermediate in VMEM and blends its output using neighbour
strips carried across programs that run in order. A 472 x 472 f32 canvas
is ~870 KB, far over an SM's 227 KB of shared memory, and CUDA blocks run
in no order, so the program splits into stages over the whole tile batch
with the intermediates in device memory (see ``pipeline.restore_tiles``):

* :func:`tile_estimate`  — ``csrc/estimate.cu``, 4 launches;
* :func:`kernel_spectrum` — ``csrc/spectral.cu``, 1 launch;
* :func:`spectral_poly`  — ``csrc/spectral.cu`` ``spectral_gemm``, 4 launches;
  with ``taper`` the last one also runs the edgetaper's blend
  (polyblur_fused.py:493-498) in its epilogue.

The tiles mode (:func:`polyblur_tiles_fused`, the whole-image route for
images of 640 px or less) runs the same stages on the image itself as one
tile, at its own (H, W); the canvas mode (:func:`polyblur_image_fused`)
runs them on the patch engine's tiles, cut from the padded canvas by
index, for every batch size (the windowed blend is its own kernel and
Function, ``overlap_add.blend_overlap_add``). Both are differentiable
(ROADMAP B.1 items 2-4, 7-8): each is one autograd Function
(``autograd.replay``) whose backward runs autograd, on the saved inputs,
of the same stages' plain versions without a feature flag, and with one
of ``pipeline._ref_pipeline`` (the scan route on all the tiles as one
batch), as the JAX package's custom VJPs replay it.
The ``launch_*`` functions are the launches themselves, counted under the
caller's name, so that ``fused_polynomial``
and ``directional_maxima`` (ops/cuda/sep_poly_fused.py, est_fused.py)
reuse these kernels with counters of their own.

Each has a plain PyTorch version beside it that rounds where the kernel
(and the TPU kernel) rounds: the state and every DFT-product operand in the
work dtype, accumulation and spectra in f32 (with f32 operands the
kernel's products run 3xTF32, ~2^-22 relative per product, or under the
f32 dot mode ``'highest'`` six products of a three-piece split, against
the plain version's full f32; ``sep_poly_fused.dot_variant`` picks the
instantiation at each launch). The plain estimate and
spectrum are composed of the steps of ``estimation`` and ``ops.sep_poly``,
fed with the kernels' host tables. The wrappers take the plain version for
CPU tensors (and inside ``plain_versions()``); for CUDA tensors they launch
or raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ...estimation import (angle_grids, blur_direction, clamped_variances,
                           directional_maxima, normalize_range, weighted_sum)
from ...utils.imaging import replicate_pad
from ..sep_poly import (_horner_spectrum, gaussian_taps, otf_from_taps,
                        quadratic_form)
from ..spectral_matmul import _derivative_matrix_np, require_full_f32
from ..tables import (N_ANGLES, N_INTERP, _dft_operands_packed,
                      _interp_weights_np, _packed_k, _tap_tables_np,
                      _ydft_mats_np)
from ._build import (check, check_cuda, count_feed, count_launch,
                     dtype_code, library, runs_plain, stream_of)
from .autograd import records_graph, replay

__all__ = ["TileView", "EstimateTables", "estimate_tables", "StageTables",
           "stage_tables", "TablePieces", "table_pieces", "tile_estimate",
           "tile_estimate_plain", "kernel_spectrum", "kernel_spectrum_plain",
           "spectrum_plain", "spectral_poly", "spectral_poly_plain",
           "taper_blend_plain", "polyblur_tiles_fused", "polyblur_image_fused",
           "estimate_rows", "estimate_launches", "launch_estimate",
           "launch_spectrum", "launch_spectral_gemm",
           "spectral_gemm_launches", "mode1_feed", "fwd_shifts", "HALF",
           "MAX_HALF", "pad64"]

HALF = 12            # kernel half-support (ker_size 25)
MAX_HALF = 15        # 31 taps: the tap tables' 32 columns
_N_EST = 8           # est row: [idx, mn, mo, sigma2, rho2, qa, qb, qc]
_DEG6 = 6.0 * math.pi / 180.0

_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


class TileView(NamedTuple):
    """``n`` tiles of size ``patch`` cut from ``data`` without copying.

    ``data`` is either a (B, C, H, W) canvas — tile n is grid tile
    ``tile0 + n // batch`` of image ``n % batch``, grid tile t at
    ``((t // tiles_w) * step[0], (t % tiles_w) * step[1])`` — or an
    (N, C, ph, pw) tile batch (:meth:`of_tiles`)."""
    data: torch.Tensor
    batch: int
    tile0: int
    n: int
    tiles_w: int
    step: tuple
    patch: tuple

    @staticmethod
    def of_tiles(x: torch.Tensor) -> "TileView":
        n = x.shape[0]
        return TileView(x, n, 0, n, 1, (0, 0), tuple(x.shape[-2:]))

    @property
    def channels(self) -> int:
        return self.data.shape[1]

    def tiles(self) -> torch.Tensor:
        """The (n, C, ph, pw) tiles as one tensor (a copy for a canvas)."""
        if self.batch == self.data.shape[0] and self.tiles_w == 1 \
                and self.step == (0, 0) and self.n == self.batch:
            return self.data
        ph, pw = self.patch
        sh, sw = self.step
        out = []
        for q in range(self.n // self.batch):
            t = self.tile0 + q
            i0, j0 = (t // self.tiles_w) * sh, (t % self.tiles_w) * sw
            out.append(self.data[:, :, i0:i0 + ph, j0:j0 + pw])
        return torch.cat(out, 0)

    def c_args(self) -> list:
        """(ptr, sB, sC, sR, batch, tile0, tiles_w, step_h, step_w)."""
        d = self.data
        if d.dim() != 4 or d.stride(3) != 1:
            raise ValueError("TileView data must be (B, C, H, W) with unit "
                             "column stride")
        return [d.data_ptr(), d.stride(0), d.stride(1), d.stride(2),
                self.batch, self.tile0, self.tiles_w, self.step[0],
                self.step[1]]


_VIEW_ARGTYPES = [_P, _L, _L, _L] + [_I] * 5
#: c_args of no view (a NULL pointer the kernel does not read)
_NULL_VIEW_ARGS = [None, 0, 0, 0, 1, 0, 1, 0, 0]


class EstimateTables(NamedTuple):
    """Constant tables of the blur estimate for one tile size."""
    dw: torch.Tensor     # (pw, pw) f32 x-derivative
    dh: torch.Tensor     # (ph, ph) f32 y-derivative
    cs: torch.Tensor     # (n_angles + 1, 2) f32 cos/sin of the angles
    wts: torch.Tensor    # (30, 7) f32 Keys interpolation weights
    dw2: torch.Tensor    # (P, pw, pad64(pw)) f32 tf32 pieces of dw: [hi; lo]
                         # (3xTF32), [hi; mid; lo] ('highest')
    dh2: torch.Tensor    # (P, ph, pad64(ph)) f32 pieces of dh


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 ``a`` rounded to the nearest tf32, ties away from zero (the
    kernel's ``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_tf32(a: np.ndarray, pieces: int = 2) -> np.ndarray:
    """(pieces, rows, pad64(cols)) tf32 pieces of an f32 matrix, K
    zero-padded as the GEMM's table maps read it: [hi; lo] with hi =
    tf32(a), lo = tf32(a - hi) (3xTF32), or for ``pieces=3`` [hi; mid; lo],
    each the rounding of what the larger pieces leave (``'highest'``)."""
    out, r = [], np.asarray(a, np.float32)
    for _ in range(pieces):
        p = _tf32(r)
        out.append(_k_padded(p))
        r = r - p
    return np.stack(out)


@functools.lru_cache(maxsize=8)
def estimate_tables(ph: int, pw: int, device: str,
                    n_angles: int = N_ANGLES,
                    pieces: int = 2) -> EstimateTables:
    """The estimate tables for (ph, pw) tiles on ``device`` (built once on
    the host and cached), the derivative GEMM's split into ``pieces`` tf32
    pieces (2 + the f32 dot mode's variant). The directional angles are
    the JAX kernel's, ``k pi / n_angles`` in Python floats, their cos / sin
    rounded to f32 (polyblur_tpu/ops/pallas/est_fused.py:33)."""
    if n_angles < 1:
        raise ValueError(f"n_angles must be >= 1, got {n_angles}")
    angles = [k * math.pi / n_angles for k in range(n_angles + 1)]
    cs = np.array([[math.cos(t), math.sin(t)] for t in angles], np.float32)
    dw, dh = _derivative_matrix_np(pw), _derivative_matrix_np(ph)
    return EstimateTables(*(torch.tensor(a, device=device) for a in (
        dw, dh, cs, _interp_weights_np(), _split_tf32(dw, pieces),
        _split_tf32(dh, pieces))))


class StageTables(NamedTuple):
    """Constant tables of the spectral polynomial on one canvas and dtype:
    (ph, pw) tiles replicate-padded by ``pad`` to an (h, wc) canvas. The
    product tables are the GEMM operands of ``csrc/spectral.cu`` as they
    lie in memory: K-major, K zero-padded to a multiple of 64
    (:func:`pad64`)."""
    pad: int             # pad/crop width: the half-support, or 0 (canvas
                         # = the tile)
    er: torch.Tensor     # (128, kp) f32 x tap phases (cos)
    ei: torch.Tensor     # (128, kp) f32 x tap phases (-sin)
    cyt: torch.Tensor    # (h, 32) f32 y tap phases (cos)
    syt: torch.Tensor    # (h, 32) f32 y tap phases (sin)
    fwd_t: torch.Tensor  # (2 kp, pad64(wc)) work dtype, x-rDFT [Cf | -Sf]^T
    inv_t: torch.Tensor  # (wc, 2 kp) work dtype, inverse [Ai ; Bi]^T
    ydft: torch.Tensor   # (2 h, pad64(2 h)) work dtype, [[Cy, Sy], [-Sy, Cy]]
    ydft_inv: torch.Tensor  # (2 h, pad64(2 h)), [[Cy, -Sy], [Sy, Cy]]
    half: int = HALF     # kernel half-support of the tap tables

    @property
    def h(self) -> int:
        return self.cyt.shape[0]

    @property
    def wc(self) -> int:
        return self.inv_t.shape[0]


def pad64(n: int) -> int:
    """``n`` rounded up to a whole number of 64 elements: the K widths of
    the GEMM tables and of the stacked y-DFT intermediates (one 128-byte
    bf16 row of a shared-memory stage)."""
    return -(-n // 64) * 64


def _k_padded(a: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0], pad64(a.shape[1])), np.float32)
    out[:, :a.shape[1]] = a
    return out


@functools.lru_cache(maxsize=16)
def stage_tables(ph: int, pw: int, dtype: torch.dtype, device: str,
                 pad: int = HALF, half: int = HALF) -> StageTables:
    """The spectral tables for (ph, pw) tiles padded by ``pad`` in work
    dtype ``dtype`` on ``device`` (built once on the host from
    ops/tables.py and cached). The kernel taps span 2 ``half`` + 1 (25 on
    the patch engine's path; ``half`` <= ``MAX_HALF``).

    The y-DFT pair acts on stacked real and imaginary parts: the forward
    ``[Yr ; Yi] = [[Cy, Sy], [-Sy, Cy]] [Rr ; Ri]`` and the inverse
    ``[[Cy, -Sy], [Sy, Cy]]``, so that no product needs a half-swap or a
    sign in its operand loads; every entry is +-Cy or +-Sy, rounded to the
    work dtype alike."""
    if not 0 <= half <= MAX_HALF:
        raise ValueError(f"half-support {half} past the {2 * MAX_HALF + 1}"
                         f"-tap tables")
    h, wc = ph + 2 * pad, pw + 2 * pad
    er, ei, cyt, syt = _tap_tables_np(h, wc, half)
    fwd, inv = _dft_operands_packed(wc)
    cy, sy = _ydft_mats_np(h)
    t2 = np.block([[cy, sy], [-sy, cy]])
    t3 = np.block([[cy, -sy], [sy, cy]])

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    def wd(a):
        return f32(a).to(dtype)

    return StageTables(pad, f32(er), f32(ei), f32(cyt), f32(syt),
                       wd(_k_padded(fwd.T)), wd(inv.T), wd(_k_padded(t2)),
                       wd(_k_padded(t3)), half)


#: F^T's shifted copies of :func:`fwd_shifts`: one per column a 16-byte
#: block holds of bf16
SHIFTS = 8


@functools.lru_cache(maxsize=16)
def fwd_shifts(wc: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """``(SHIFTS, 2 kp, pad64(wc + SHIFTS - 1))``: copy d of the work-dtype
    x-rDFT table F^T (:class:`StageTables` ``fwd_t``, the same values)
    moved d columns right, zeros elsewhere. ``spectral_gemm``'s first
    product on the TMA feed (:func:`mode1_feed`) reads its tiles from d
    columns left of their padded origin, the nearest 16-byte block, and
    copy d of the table beside them; copy 0 is ``fwd_t`` itself."""
    fwd, _ = _dft_operands_packed(wc)
    ft = torch.tensor(np.ascontiguousarray(fwd.T), device=device).to(dtype)
    out = torch.zeros((SHIFTS, ft.shape[0], pad64(wc + SHIFTS - 1)),
                      dtype=dtype, device=device)
    for d in range(SHIFTS):
        out[d, :, d:d + wc] = ft
    return out


class TablePieces(NamedTuple):
    """The product tables of the (h, wc) canvas's f32 :class:`StageTables`
    in their three tf32 pieces, ``(3, rows, ld)`` f32 each ([hi; mid; lo],
    :func:`_split_tf32`), for ``spectral_gemm``'s ``'highest'`` kernel: it
    takes each table's pieces by TMA instead of splitting the table in
    every block."""
    fwd_t: torch.Tensor     # (3, 2 kp, pad64(wc))
    inv_t: torch.Tensor     # (3, wc, 2 kp)
    ydft: torch.Tensor      # (3, 2 h, pad64(2 h))
    ydft_inv: torch.Tensor  # (3, 2 h, pad64(2 h))


@functools.lru_cache(maxsize=16)
def table_pieces(h: int, wc: int, device: str) -> TablePieces:
    """The three-piece split of :func:`stage_tables`' product tables for an
    (h, wc) canvas (they depend on the canvas alone), built once on the
    host from the same f32 values and cached."""
    fwd, inv = _dft_operands_packed(wc)
    cy, sy = _ydft_mats_np(h)
    mats = (fwd.T, inv.T, np.block([[cy, sy], [-sy, cy]]),
            np.block([[cy, -sy], [sy, cy]]))
    return TablePieces(*(torch.tensor(_split_tf32(m, 3), device=device)
                         for m in mats))


# ------------------------------------------------------------- estimation

def _gray_norm_plain(view: TileView) -> torch.Tensor:
    """(n, ph, pw) min/max-normalized gray images of the tiles: channel sum
    times 1/C, as the estimate kernel's stage 1."""
    x = view.tiles().float()
    c = x.shape[1]
    gray = x[:, 0]
    for ch in range(1, c):
        gray = gray + x[:, ch]
    return normalize_range(gray * torch.tensor(1.0 / c, dtype=torch.float32))


def _maxima_plain(view: TileView, n_angles: int = N_ANGLES) -> torch.Tensor:
    """(n, n_angles + 1) directional gradient maxima of the tiles'
    normalized gray images (stages 1-3 of the estimate kernel): the steps
    of ``estimation`` on the kernel's tables."""
    require_full_f32(view.data)
    t = estimate_tables(*view.patch, str(view.data.device), n_angles)
    g = _gray_norm_plain(view)
    return directional_maxima(g @ t.dw.T, t.dh @ g, t.cs)


def _directional_vals_plain(view: TileView) -> torch.Tensor:
    """(n, 30) Keys-interpolated directional gradient maxima of the tiles
    (the values the blur direction is the argmin of)."""
    t = estimate_tables(*view.patch, str(view.data.device))
    return weighted_sum(t.wts, _maxima_plain(view))


def tile_estimate_plain(view: TileView, coeffs: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tile_estimate`: same arithmetic order."""
    return estimate_rows(_directional_vals_plain(view), coeffs)


def estimate_rows(vals: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """The (n, 8) estimate rows of the (n, 30) interpolated directional
    maxima ``vals`` (stage 3 of the estimate kernel)."""
    grid = angle_grids(N_ANGLES, N_INTERP)[1].to(vals.device)
    idx, mn, mo, _ = (v[:, 0] for v in blur_direction(vals, grid))
    sigma2, rho2 = clamped_variances(mn, mo, coeffs[4], coeffs[5])
    theta = idx.float() * torch.tensor(_DEG6, dtype=torch.float32)
    qa, qb, qc = quadratic_form(sigma2, rho2, theta)
    return torch.stack([idx.float(), mn, mo, sigma2, rho2, qa, qb, qc], 1)


def _band_rows(ph: int, n: int) -> int:
    """Rows per band of the gray min/max pass (stage 1): ~1024 blocks over
    the n tiles, at least one row each."""
    return max(1, -(-ph * n // 1024))


def _pitch4(n: int) -> int:
    """Row pitch of the estimate's normalized planes (16-byte rows)."""
    return -(-n // 4) * 4


def estimate_launches(view: TileView, name: str,
                      coeffs: torch.Tensor | None = None,
                      n_angles: int = N_ANGLES, mode_free: bool = False):
    """The four launches of ``csrc/estimate.cu`` over the tiles of
    ``view``, not yet run: (maxima (n, n_angles + 1) f32, est (n, 8) f32,
    [stage 1,
    .., stage 4]), each a callable that launches its stage and counts it
    under ``name`` (``name[highest]`` in the f32 dot mode's ``'highest'``
    case, which f32 tiles take under that mode unless ``mode_free``).
    Stage 1 is the gray min/max pass, 2 the normalization (g and its
    transpose, split for the tensor cores; in f32 for ``'highest'``, whose
    GEMM splits them), 3 the derivative GEMM with the
    directional maxima, 4 the final model (it writes ``est``; at
    ``n_angles`` = 6 only). Run in order they are the estimate; one alone
    reruns its stage on what the last run left."""
    from .sep_poly_fused import dot_variant, launch_name  # imports us

    check_cuda(name, view.data)
    if view.n > 65535:
        raise ValueError(f"{name}: {view.n} tiles exceed the launch grid")
    variant = dot_variant(view.data.dtype, mode_free)
    ph, pw = view.patch
    t = estimate_tables(ph, pw, str(view.data.device), n_angles, 2 + variant)
    dev = view.data.device
    rows = _band_rows(ph, view.n)
    mm = torch.empty((view.n, -(-ph // rows), 2), dtype=torch.float32,
                     device=dev)
    # g and g^T: hi and lo, or in f32 for 'highest' (its GEMM splits them)
    pieces = 1 if variant else 2
    g2 = torch.empty((view.n, pieces, ph, _pitch4(pw)), dtype=torch.float32,
                     device=dev)
    gt2 = torch.empty((view.n, pieces, pw, _pitch4(ph)), dtype=torch.float32,
                      device=dev)
    maxima = torch.empty((view.n, n_angles + 1), dtype=torch.float32,
                         device=dev)
    est = torch.empty((view.n, _N_EST), dtype=torch.float32, device=dev)
    if coeffs is None:
        coeffs = torch.zeros(8, dtype=torch.float32, device=dev)
    coeffs = coeffs.float().contiguous()
    check_cuda(name, coeffs)
    lib = library("estimate")
    fn = lib.pb_tile_estimate
    fn.argtypes = ([_I, _I] + _VIEW_ARGTYPES + [_I] * 6 + [_P] * 10
                   + [_I, _P])
    fn.restype = _I
    args = ([dtype_code(view.data.dtype)] + view.c_args()
            + [view.n, view.channels, ph, pw, rows, n_angles + 1]
            + [p.data_ptr() for p in (t.dw2, t.dh2, t.cs, t.wts, coeffs, mm,
                                      g2, gt2, maxima, est)]
            + [variant, stream_of(view.data)])
    counter = launch_name(name, variant)

    # the tensors behind the pointers in args, alive while a launch may run
    keep = (t, coeffs, mm, g2, gt2, maxima, est)

    def launch(stage):
        def run():
            err = fn(stage, *args)
            count_launch(counter)
            check(lib, err, f"{name} stage {stage}")
        run.tensors = keep
        return run

    return maxima, est, [launch(s) for s in (1, 2, 3, 4)]


def launch_estimate(view: TileView, stages, name: str,
                    coeffs: torch.Tensor | None = None,
                    n_angles: int = N_ANGLES, mode_free: bool = False):
    """Launch the given stages (of 1-4; see :func:`estimate_launches`)
    over the tiles of ``view``, each counted under ``name``. Returns
    (maxima (n, n_angles + 1) f32, est (n, 8) f32); ``est`` is written by
    stage 4 only."""
    if 4 in stages and n_angles != N_ANGLES:
        raise ValueError(f"{name}: the final stage is built for n_angles="
                         f"{N_ANGLES}")
    maxima, est, runs = estimate_launches(view, name, coeffs, n_angles,
                                          mode_free)
    for stage in stages:
        runs[stage - 1]()
    return maxima, est


def tile_estimate(view: TileView, coeffs: torch.Tensor) -> torch.Tensor:
    """Blind blur estimate of every tile of ``view``.

    :param coeffs: (8,) f32 ``[a3, a2, a1, beta, c, b, sigma_s, sigma_r]``
    :returns: (n, 8) f32 rows ``[idx, mn, mo, sigma2, rho2, qa, qb, qc]``:
        the argmin angle index (theta = idx * 6 degrees), the interpolated
        normal and orthogonal maxima, the clamped variances and the
        kernel's quadratic form.
    """
    if runs_plain(view.data):
        return tile_estimate_plain(view, coeffs)
    return launch_estimate(view, (1, 2, 3, 4), "tile_estimate", coeffs)[1]


# ---------------------------------------------------------- kernel spectrum

def spectrum_plain(qa, qb, qc, coeffs: torch.Tensor,
                   tables: StageTables) -> torch.Tensor:
    """(n, h, 2 kp) packed ``[p(K_hat) | p(K_hat)] / h`` of the kernels
    with quadratic forms (qa, qb, qc), each (n,): the steps of
    ``ops.sep_poly`` on the kernel's tables."""
    require_full_f32(qa)
    h = tables.cyt.shape[0]
    km = gaussian_taps(qa, qb, qc, tables.half)
    khat = otf_from_taps(km, tables.er, tables.ei, tables.cyt, tables.syt)
    qhat = _horner_spectrum(khat, (coeffs[0], coeffs[1], coeffs[2],
                                   coeffs[3]))
    return torch.cat([qhat, qhat], -1) * torch.tensor(1.0 / h,
                                                      dtype=torch.float32)


def kernel_spectrum_plain(est: torch.Tensor, coeffs: torch.Tensor,
                          tables: StageTables) -> torch.Tensor:
    """Plain version of :func:`kernel_spectrum`."""
    return spectrum_plain(est[:, 5], est[:, 6], est[:, 7], coeffs, tables)


def launch_spectrum(q: torch.Tensor, off: int, coeffs: torch.Tensor,
                    tables: StageTables, name: str) -> torch.Tensor:
    """Launch ``pb_kernel_spectrum`` on the rows of ``q`` (n, stride) f32
    whose columns ``off .. off + 2`` hold (qa, qb, qc), counted under
    ``name``; ``coeffs`` starts with [a3, a2, a1, beta]."""
    check_cuda(name, q, coeffs, tables.er)
    n = q.shape[0]
    h, kp = tables.cyt.shape[0], tables.er.shape[1]
    q = q.float().contiguous()
    coeffs = coeffs.float().contiguous()
    if coeffs.numel() < 4 or q.dim() != 2 or q.shape[1] < off + 3:
        raise ValueError(f"{name}: bad quadratic-form rows {tuple(q.shape)} "
                         f"or coefficients {tuple(coeffs.shape)}")
    qhat2 = torch.empty((n, h, 2 * kp), dtype=torch.float32, device=q.device)
    lib = library("spectral")
    fn = lib.pb_kernel_spectrum
    fn.argtypes = [_P, _I, _I] + [_P] * 5 + [_I] * 4 + [_P, _P]
    fn.restype = _I
    err = fn(q.data_ptr(), q.shape[1], off, coeffs.data_ptr(),
             tables.er.data_ptr(), tables.ei.data_ptr(),
             tables.cyt.data_ptr(), tables.syt.data_ptr(), n, h, kp,
             tables.half, qhat2.data_ptr(), stream_of(q))
    count_launch(name)
    check(lib, err, name)
    return qhat2


def kernel_spectrum(est: torch.Tensor, coeffs: torch.Tensor,
                    tables: StageTables) -> torch.Tensor:
    """(n, h, 2 kp) packed ``[p(K_hat) | p(K_hat)] / h`` spectra of the
    tiles' estimated kernels (``est`` from :func:`tile_estimate`)."""
    if runs_plain(est):
        return kernel_spectrum_plain(est, coeffs, tables)
    return launch_spectrum(est, 5, coeffs, tables, "kernel_spectrum")


# ------------------------------------------------------ spectral polynomial

class _Geometry(NamedTuple):
    h: int               # canvas rows
    wc: int              # canvas columns
    pad: int             # replicate pad of the input tiles
    crop: int            # crop of the output planes
    wd: torch.dtype      # work dtype (the DFT operands)
    out: tuple           # (n, C, oh, ow) of the output


def _geometry(view: TileView, tables: StageTables, pad, crop,
              name: str) -> _Geometry:
    """The canvas of ``tables``, the input pad and output crop (default
    ``tables.pad``), checked against the tiles: (h - 2 pad, wc - 2 pad)
    must be their patch, and they must be f32 or the work dtype."""
    h, wc = tables.h, tables.wc
    pad = tables.pad if pad is None else int(pad)
    crop = tables.pad if crop is None else int(crop)
    wd = tables.fwd_t.dtype
    if view.patch != (h - 2 * pad, wc - 2 * pad) or crop < 0 \
            or view.data.dtype not in (wd, torch.float32):
        raise ValueError(f"{name}: {view.patch} {view.data.dtype} tiles do "
                         f"not match the ({h}, {wc}) {wd} canvas at pad "
                         f"{pad}")
    return _Geometry(h, wc, pad, crop, wd,
                     (view.n, view.channels, h - 2 * crop, wc - 2 * crop))


def spectral_poly_plain(view: TileView, qhat2: torch.Tensor,
                        tables: StageTables,
                        out: torch.Tensor | None = None,
                        clip: bool = True, pad: int | None = None,
                        crop: int | None = None,
                        noise: torch.Tensor | None = None,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`spectral_poly`: the same four products on
    the same tables and stacked layout, each operand rounded to the work
    dtype just before its product."""
    require_full_f32(view.data)
    g = _geometry(view, tables, pad, crop, "spectral_poly")
    x = view.tiles()
    n, c, ph, pw = x.shape
    kp = qhat2.shape[-1] // 2
    h, q, oh, ow = g.h, g.crop, g.out[2], g.out[3]

    def op(u):
        return u.to(g.wd).float()

    xc = replicate_pad(x.float().reshape(n * c, ph, pw), (g.pad,) * 4)
    r = op(xc) @ tables.fwd_t[:, :g.wc].float().T            # (P, h, 2kp)
    rst = torch.cat([r[..., :kp], r[..., kp:]], 1)           # [Rr ; Ri]
    y = tables.ydft[:, :2 * h].float() @ op(rst)             # [Yr ; Yi]
    qs = qhat2[..., :kp].repeat(1, 2, 1)                     # (n, 2h, kp)
    pst = (y.reshape(n, c, 2 * h, kp) * qs[:, None]).reshape(y.shape)
    z = tables.ydft_inv[:, :2 * h].float() @ op(pst)         # [Zr ; Zi]
    zz = torch.cat([z[:, :h], z[:, h:]], -1)                 # [Zr | Zi]
    o = op(zz)[:, q:q + oh] @ tables.inv_t.float()[q:q + ow].T
    if clip:
        o = o.clamp(0.0, 1.0)
    if noise is not None:
        o = (o + noise.reshape(o.shape)).clamp(0.0, 1.0)
    res = o.to(out_dtype or g.wd).reshape(g.out)
    if out is None:
        return res
    out.copy_(res)
    return out


def taper_blend_plain(u: TileView, pad: int, av: torch.Tensor,
                      ah: torch.Tensor, ku: torch.Tensor,
                      xc: torch.Tensor) -> torch.Tensor:
    """One blend of the edgetaper, ``xc = a pad(u) + (1 - a) ku`` with
    ``a = av[i] ah[j]`` per tile (polyblur_fused.py:493-498), into the
    (n, C, h, wc) f32 canvas ``xc``: the plain version of
    :func:`spectral_poly`'s ``taper``, with ``ku`` its unclipped f32
    application. ``u`` (f32 or the work dtype) is replicate-padded by
    ``pad``; with ``pad = 0`` it may be ``xc`` itself."""
    n, c, h, wc = xc.shape
    x = u.tiles().float()
    if pad:
        x = replicate_pad(x, (pad,) * 4)
    a = av[:, None, :, None] * ah[:, None, None, :]
    xc.copy_(a * x + (1.0 - a) * ku)
    return xc


def _check_taper(name: str, g: _Geometry, clip: bool, noise, odt, taper):
    """The taper's (av, ah) as contiguous f32 after checking that the
    application can blend: the whole canvas out in f32, no clip, no
    noise."""
    av, ah = taper
    n = g.out[0]
    if g.crop or clip or noise is not None or odt != torch.float32 \
            or av.shape != (n, g.h) or ah.shape != (n, g.wc):
        raise ValueError(f"{name}: the taper blends the whole canvas in "
                         f"f32, unclipped and without noise")
    return av.float().contiguous(), ah.float().contiguous()


def mode1_feed(src_dtype: torch.dtype, work_dtype: torch.dtype, base: int,
               strides, sizes) -> str:
    """How ``spectral_gemm``'s first product takes its tiles from their
    (B, C, H, W) source, of element ``strides`` and ``sizes`` at address
    ``base``: ``"tma"`` where the work dtype is bf16, the source bf16 or
    f32, and the base and the row pitch, and the channel and image strides
    where there is more than one, whole 16-byte blocks, as a TMA map needs
    them (the tiles themselves may start anywhere: the map spans the whole
    source); otherwise ``"gather"``, the producer warpgroups' loads, which
    take any stride."""
    if work_dtype != torch.bfloat16 \
            or src_dtype not in (torch.bfloat16, torch.float32):
        return "gather"
    esz = 2 if src_dtype == torch.bfloat16 else 4
    s_b, s_c, s_r = strides[:3]
    n_b, n_c = sizes[:2]
    if base % 16 or (s_r * esz) % 16 or (n_c > 1 and (s_c * esz) % 16) \
            or (n_b > 1 and (s_b * esz) % 16):
        return "gather"
    return "tma"


def spectral_gemm_launches(view: TileView, qhat2: torch.Tensor,
                           tables: StageTables, out: torch.Tensor | None,
                           clip: bool, name: str, pad: int | None = None,
                           crop: int | None = None,
                           noise: torch.Tensor | None = None,
                           out_dtype: torch.dtype | None = None,
                           taper=None, rounded: torch.Tensor | None = None,
                           view1: TileView | None = None):
    """The four ``pb_spectral_gemm`` launches of one application, not yet
    run: (out, [mode 1, mode 2, mode 3, mode 4]), each a callable that
    launches its product and counts it under ``name`` (``name[highest]``
    for an f32 work dtype under the f32 dot mode ``'highest'``), mode 1
    also its feed (:func:`mode1_feed`) in ``_build.feeds``; see
    :func:`spectral_poly`. Run in order they are the application; one alone
    is a product on the intermediates the last run left."""
    from .sep_poly_fused import dot_variant, launch_name  # imports us

    check_cuda(name, view.data, qhat2, tables.fwd_t)
    g = _geometry(view, tables, pad, crop, name)
    variant = dot_variant(g.wd)
    counter = launch_name(name, variant)
    c = view.channels
    kp = _packed_k(g.wc)
    planes = view.n * c
    odt = out_dtype or g.wd
    if qhat2.shape != (view.n, g.h, 2 * kp) or odt not in (g.wd,
                                                            torch.float32):
        raise ValueError(f"{name}: qhat2/tables do not match the tiles")
    if planes > 65535:
        raise ValueError(f"{planes} planes exceed the launch grid")
    if out is None:
        out = torch.empty(g.out, dtype=odt, device=view.data.device)
    elif out.shape != g.out or out.dtype != odt or not out.is_contiguous():
        raise ValueError(f"{name}: bad out tensor")
    if noise is not None:
        check_cuda(name, noise)
        if noise.shape != g.out or noise.dtype != torch.float32 \
                or not noise.is_contiguous():
            raise ValueError(f"{name}: bad noise tensor")
    av = ah = None
    if taper is not None:
        check_cuda(name, *taper)
        av, ah = _check_taper(name, g, clip, noise, odt, taper)
    if rounded is not None and (
            taper is None or g.wd != torch.bfloat16
            or rounded.shape != g.out or rounded.dtype != g.wd
            or not rounded.is_contiguous()):
        raise ValueError(f"{name}: bad rounded tensor")
    view1 = view if view1 is None else view1
    if view1.patch != view.patch or view1.n != view.n \
            or view1.channels != c \
            or view1.data.dtype not in (g.wd, torch.float32):
        raise ValueError(f"{name}: mode 1's tiles do not match the tiles")
    qhat2 = qhat2.contiguous()
    # the 'highest' kernel takes each table in its three tf32 pieces
    tabs = table_pieces(g.h, g.wc, str(view.data.device)) if variant \
        else tables
    # RS / PS: (planes, kp, pad64(2h)); ZZ: (planes, h, 2kp), in mid_a
    # after RS has been read
    l2 = pad64(2 * g.h)
    dev = out.device
    mid_a = torch.empty(planes * max(kp * l2, g.h * 2 * kp), dtype=g.wd,
                        device=dev)
    mid_b = torch.empty(planes * kp * l2, dtype=g.wd, device=dev)
    lib = library("spectral")
    fn = lib.pb_spectral_gemm
    fn.argtypes = ([_I, _I] + _VIEW_ARGTYPES + [_I] + [_P] * 3 + [_I]
                   + [_P] * 2 + [_I] * 9 + [_P] * 2 + [_I, _P] + [_I] * 5
                   + [_P])
    fn.restype = _I

    def source(v):
        """The C arguments of the tiles ``v``: the view, whether f32, and
        mode 1's feed with the source's (B, H, W), which its TMA map
        spans."""
        d = v.data
        f = mode1_feed(d.dtype, g.wd, d.data_ptr(), d.stride(), d.shape)
        return ([dtype_code(g.wd)] + v.c_args()
                + [int(d.dtype == torch.float32)],
                [int(f == "tma"), d.shape[0], d.shape[2], d.shape[3]], f)

    args, src4, _ = source(view)
    args1, src1, feed = source(view1)
    # the TMA feed's table is F^T's shifted copies
    fwd = fwd_shifts(g.wc, g.wd, str(view.data.device)) if feed == "tma" \
        else tabs.fwd_t
    rest = [int(odt == torch.float32), qhat2.data_ptr(),
            None if noise is None else noise.data_ptr(), planes, c]
    weights = [None, None] if av is None else [av.data_ptr(), ah.data_ptr()]
    rnd = None if rounded is None else rounded.data_ptr()
    stream = stream_of(out)

    def launch(mode, tab, mid, dst, tile, half):
        a, src = (args1, src1) if mode == 1 else (args, src4)

        def run():
            err = fn(mode, *a, tab.data_ptr(),
                     None if mid is None else mid.data_ptr(),
                     dst.data_ptr(), *rest, *tile, g.h, g.wc, kp, half,
                     int(clip), *weights, g.pad, rnd, *src, variant,
                     stream)
            count_launch(counter)
            if mode == 1:
                count_feed(feed)
            check(lib, err, f"{name} mode {mode}")
        # the tensors behind the pointers in args, rest and weights (qhat2,
        # av and ah may be contiguous copies made here), alive while the
        # launch may run
        run.tensors = (view.data, view1.data, qhat2, noise, av, ah, rounded)
        return run

    # (mode, table, operand read, destination, tile size, pad or crop):
    # RS -> mid_a, PS -> mid_b, ZZ -> mid_a, x' -> out
    return out, [
        launch(1, fwd, None, mid_a, view.patch, g.pad),
        launch(2, tabs.ydft, mid_a, mid_b, view.patch, g.pad),
        launch(3, tabs.ydft_inv, mid_b, mid_a, view.patch, g.pad),
        launch(4, tabs.inv_t, mid_a, out, g.out[2:], g.crop)]


def launch_spectral_gemm(view: TileView, qhat2: torch.Tensor,
                         tables: StageTables, out: torch.Tensor | None,
                         clip: bool, name: str, pad: int | None = None,
                         crop: int | None = None,
                         noise: torch.Tensor | None = None,
                         out_dtype: torch.dtype | None = None,
                         taper=None, rounded: torch.Tensor | None = None,
                         view1: TileView | None = None) -> torch.Tensor:
    """One application: the four launches of
    :func:`spectral_gemm_launches` in order."""
    out, launches = spectral_gemm_launches(view, qhat2, tables, out, clip,
                                           name, pad, crop, noise, out_dtype,
                                           taper, rounded, view1)
    for run in launches:
        run()
    return out


def spectral_poly(view: TileView, qhat2: torch.Tensor, tables: StageTables,
                  out: torch.Tensor | None = None, clip: bool = True,
                  pad: int | None = None, crop: int | None = None,
                  noise: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None,
                  taper=None, rounded: torch.Tensor | None = None,
                  view1: TileView | None = None) -> torch.Tensor:
    """One application of the spectral polynomial ``qhat2`` to every tile
    and channel: ``crop(p(K) pad(x))`` on the (h, wc) canvas of ``tables``,
    clipped to [0, 1] when ``clip``, with ``noise`` added and clipped again
    when given, in ``out_dtype`` (default: the work dtype).

    :param view: the tiles x, in the work dtype (``tables.fwd_t.dtype``)
        or in f32 (rounded to the work dtype as the first product reads
        them)
    :param qhat2: (n, h, 2 kp) f32 from :func:`kernel_spectrum`
    :param out: optional destination; it may be the tensor ``view`` reads
        (the first product consumes x before the last writes).
    :param pad: replicate pad of the tiles onto the canvas (default
        ``tables.pad``; 0 when the tiles are the canvas)
    :param crop: crop of the output from the canvas (default
        ``tables.pad``; 0 keeps the whole canvas)
    :param noise: f32 planes of the output's shape, added after the clip
    :param taper: the edgetaper's per-tile weights ``(av (n, h), ah (n,
        wc))``: the output (the whole canvas, ``crop=0``, f32, unclipped)
        becomes ``a pad(x) + (1 - a) p(K) pad(x)`` with ``a = av[i]
        ah[j]``, blended in the last product's epilogue (see
        :func:`taper_blend_plain`); ``out`` may be the canvas ``x`` reads
    :param rounded: with the taper in a bf16 work dtype, a canvas of the
        output's shape in bf16 that gets the output rounded to it besides
        (in the last product's epilogue): the next application's ``view1``
    :param view1: the tiles ``x`` rounded to the work dtype, which the
        first product reads in place of ``view`` (it rounds them so); may
        be ``rounded`` itself
    """
    if runs_plain(view.data):
        if taper is None:
            return spectral_poly_plain(view, qhat2, tables, out, clip, pad,
                                       crop, noise, out_dtype)
        g = _geometry(view, tables, pad, crop, "spectral_poly")
        _check_taper("spectral_poly", g, clip, noise, out_dtype or g.wd,
                     taper)
        ku = spectral_poly_plain(view, qhat2, tables, None, clip, pad, crop,
                                 noise, out_dtype)
        if out is None:
            out = torch.empty_like(ku)
        taper_blend_plain(view, g.pad, *taper, ku, out)
        if rounded is not None:
            rounded.copy_(out)
        return out
    return launch_spectral_gemm(view, qhat2, tables, out, clip,
                                "spectral_gemm", pad, crop, noise, out_dtype,
                                taper, rounded, view1)


# ------------------------------------------------------------- tiles mode

def polyblur_tiles_fused(x: torch.Tensor, coeffs: torch.Tensor,
                         n_iter: int, do_taper: bool = False,
                         do_halo: bool = False,
                         prefilter: str | None = None) -> torch.Tensor:
    """N blind Polyblur iterations on a (T, C, Ht, Wt) tile batch, each
    tile its own blur estimate (rectangles and odd sizes fine): the
    counterpart of the TPU mega kernel's tiles mode
    (polyblur_tpu/ops/pallas/polyblur_fused.py::polyblur_tiles_fused), run
    as the per-tile stages above at the tiles' own shape, 9 launches per
    iteration without the feature flags (see ``pipeline.restore_tiles``).

    Differentiable in ``x`` and ``coeffs`` (ROADMAP B.1 items 4, 7-8, the
    custom VJP at polyblur_fused.py:896-946): the kernels forward;
    backward, autograd of the same stages' plain versions without a flag,
    and with one of ``pipeline._ref_pipeline`` on ``x`` (the scan route,
    whose taper normalizes over the whole batch where the kernels'
    normalizes per tile), as the JAX package's VJP replays.

    :param coeffs: (8,) f32 from ``pipeline._mega_pack``
    :param do_taper, do_halo, prefilter: the feature flags (prefilter in
        {None, 'bilateral', 'dt'})
    """
    from ...pipeline import _ref_pipeline, restore_tiles

    flags = dict(do_taper=do_taper, do_halo=do_halo, prefilter=prefilter)

    def run(t, co):
        return restore_tiles(TileView.of_tiles(t.contiguous()), co, n_iter,
                             **flags)

    def ref(t, co):
        return _ref_pipeline(t, co, n_iter, **flags)

    return replay(run, ref if any(flags.values()) else run, x, coeffs)


# ------------------------------------------------------- canvas (patch) modes

def _restore_canvas(canvas: torch.Tensor, coeffs: torch.Tensor, n_iter: int,
                    grid_info, chunk, flags: dict) -> torch.Tensor:
    """(th tw B, C, ph, pw) restored tiles of the regular grid
    ``grid_info = (th, tw, sh, sw, ph, pw)`` on the (B, C, H, W) canvas,
    cut by index, at most ``chunk`` grid tiles per pass through the stages
    (all when None or <= 0). Without a graph the chunks write into one
    preallocated batch; while recording one they are concatenated."""
    from ...pipeline import restore_tiles

    th, tw, sh, sw, ph, pw = grid_info
    b, c = canvas.shape[:2]
    n_tiles = th * tw
    chunk = n_tiles if not chunk or chunk <= 0 else min(chunk, n_tiles)
    graph = records_graph(canvas, coeffs)
    state = None if graph else torch.empty(
        (n_tiles * b, c, ph, pw), dtype=canvas.dtype, device=canvas.device)
    parts = []
    for t0 in range(0, n_tiles, chunk):
        nt = min(chunk, n_tiles - t0)
        view = TileView(canvas, b, t0, nt * b, tw, (sh, sw), (ph, pw))
        dst = None if graph else state[t0 * b:(t0 + nt) * b]
        parts.append(restore_tiles(view, coeffs, n_iter, out=dst, **flags))
    return torch.cat(parts) if graph else state


def _ref_image_pipeline(canvas: torch.Tensor, coeffs: torch.Tensor,
                        n_iter: int, grid_info, flags: dict) -> torch.Tensor:
    """``pipeline._ref_pipeline`` on every grid tile of the canvas, cut as
    one (th tw B, C, ph, pw) batch, tile-major (polyblur_fused.py:861-870),
    whatever the forward's ``chunk``."""
    from ...pipeline import _ref_pipeline

    th, tw, sh, sw, ph, pw = grid_info
    b = canvas.shape[0]
    tiles = TileView(canvas, b, 0, th * tw * b, tw, (sh, sw), (ph, pw))
    return _ref_pipeline(tiles.tiles(), coeffs, n_iter, **flags)


def polyblur_image_fused(canvas: torch.Tensor, coeffs: torch.Tensor,
                         n_iter: int, grid_info, chunk=None,
                         do_taper: bool = False, do_halo: bool = False,
                         prefilter: str | None = None) -> torch.Tensor:
    """N blind Polyblur iterations on every tile of a regular grid on the
    padded (B, C, H, W) canvas, cut by index (the counterpart of the TPU
    mega kernel's DMA mode, polyblur_fused.py::polyblur_image_fused).

    :param grid_info: (th, tw, sh, sw, ph, pw)
    :param chunk: grid tiles per pass through the stages (None: all)
    :returns: the (th tw B, C, ph, pw) restored tiles, tile-major, in the
        canvas dtype

    Differentiable in ``canvas`` and ``coeffs`` (ROADMAP B.1 items 2-3,
    7-8, the custom VJPs at polyblur_fused.py:792-845 and :848-893), as
    :func:`polyblur_tiles_fused`; with a flag on the backward replays the
    scan route on all grid tiles as one batch (:func:`_ref_image_pipeline`).
    The JAX package's blend mode (item 2) fuses the windowed blend into its
    kernel and so has a VJP of its own; here the blend is a separate kernel
    on every batch size, and one image takes this Function followed by
    ``overlap_add.blend_overlap_add``'s.
    """
    flags = dict(do_taper=do_taper, do_halo=do_halo, prefilter=prefilter)

    def run(cv, co):
        return _restore_canvas(cv, co, n_iter, grid_info, chunk, flags)

    def ref(cv, co):
        return _ref_image_pipeline(cv, co, n_iter, grid_info, flags)

    return replay(run, ref if any(flags.values()) else run, canvas, coeffs)
