"""Spectral polynomial deconvolution with parametric kernels (plain torch).

The estimator's sampled anisotropic Gaussian kernel

    k[t, j] = exp(-0.5 (a t^2 + 2 b t j + c j^2)) / N,   t, j in [-half, half]

is centrally symmetric, so its OTF on the padded canvas (``p2o`` of the
kernel, reference filters.py:255) is real and analytic in the quadratic
form (a, b, c), and the whole degree-3 polynomial is diagonal in the 2D DFT
of the replicate-padded tile:

    p(K) u = idft2( p(K_hat) * dft2(u_padded) ),
    p(z)   = ((a3 z + a2) z + a1) z + beta.

This is exactly the reference's fft method (deblurring.py:141-169). The OTF
is rebuilt from the tap-phase tables of ops/tables.py; the plain version of
the per-tile ``kernel_spectrum`` kernel (ops/cuda/polyblur_fused.py) is built
from the steps here.

:func:`compute_polynomial_separable` is the whole-image route's polynomial,
routed as in the JAX package (ops/sep_poly.py:215-285) with the card in the
TPU's place: the fused kernel (``ops/cuda/sep_poly_fused.fused_polynomial``)
on canvases up to ``FUSED_MAX_CANVAS``, the overlap-save block grid of the
same kernel above it. :func:`_spectral2d`, the whole-canvas ``rfft2``
composition, is the plain reference both are held to. The route does not
depend on the device: CPU tensors run the kernel wrappers' plain versions
along the same route.
"""

from __future__ import annotations

import torch

from ..envelopes import BLOCK_COST_CONST, FUSED_MAX_CANVAS
from ..utils.imaging import pad_with_kernel
from ..utils.profiling import record_dispatch
from .spectral_matmul import require_full_f32
from .tables import _tap_tables_np

__all__ = ["gaussian_quadratic_coeffs", "quadratic_form", "gaussian_taps",
           "otf_from_taps", "kernel_spectrum", "compute_polynomial_separable",
           "spectral_blur"]

def quadratic_form(sigma2, rho2, theta):
    """(a, b, c) of the kernel's quadratic form from the variances along
    and across the blur direction ``theta`` (radians)."""
    t = -theta
    ct = torch.cos(t)
    st = torch.sin(t)
    inv_l1 = 1.0 / sigma2
    inv_l2 = 1.0 / rho2
    a = ct * ct * inv_l1 + st * st * inv_l2
    b = st * ct * (inv_l1 - inv_l2)
    c = ct * ct * inv_l2 + st * st * inv_l1
    return a, b, c


def gaussian_quadratic_coeffs(sigma, rho, theta):
    """(a, b, c) of the kernel's quadratic form, from (sigma, rho, theta).

    Matches the inverse covariance of blur_estimation.py:189-208 (the
    reference negates theta): a multiplies x^2 (columns), c multiplies y^2
    (rows), b the cross term.
    """
    return quadratic_form(sigma * sigma, rho * rho, theta)


def gaussian_taps(a, b, c, half: int = 12) -> torch.Tensor:
    """(N, 2 half + 1, 2 half + 1) sampled kernels, normalized to sum 1;
    rows are y offsets j, columns x offsets t."""
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=a.device)
    af = a.float()[:, None, None]
    bf = b.float()[:, None, None]
    cf = c.float()[:, None, None]
    tx = t[None, None, :]
    ty = t[None, :, None]
    q = af * tx * tx + 2.0 * bf * tx * ty + cf * ty * ty
    # exp in float64: MKL's single-precision exp on the CPU can return
    # values ~1e-4 off on part of a tensor when its first call in a process
    # runs on several threads at once; the float64 exp rounds to the f32
    # taps within an ulp
    km = torch.exp(-0.5 * q.double()).float()
    return km * (1.0 / km.sum(dim=(-2, -1), keepdim=True))


def otf_from_taps(km, er, ei, cyt, syt) -> torch.Tensor:
    """(N, h, kp) real OTF of the taps ``km`` from the tap-phase tables of
    ``_tap_tables_np``: per row offset j the tap row's x-spectrum, then the
    y-offset phases combine the rows."""
    taps = km.shape[-1]
    hr = km @ er[:taps]
    hi = km @ ei[:taps]
    return cyt[:, :taps] @ hr + syt[:, :taps] @ hi


def kernel_spectrum(a, b, c, h: int, w: int, half: int = 12) -> torch.Tensor:
    """(N, h, w//2+1) real OTF of the sampled anisotropic Gaussian on the
    (h, w) circular canvas — ``p2o(kernel, (h, w))`` evaluated analytically
    (the kernel is centrally symmetric, so the imaginary part is zero)."""
    tables = (torch.tensor(v, device=a.device)
              for v in _tap_tables_np(h, w, half))
    return otf_from_taps(gaussian_taps(a, b, c, half),
                         *tables)[..., :w // 2 + 1]


def _horner_spectrum(khat, horner):
    a3, a2, a1, beta = horner
    return ((a3 * khat + a2) * khat + a1) * khat + beta


def _fused_path_eligible(h: int, w: int, prepad: bool,
                         half: int = 12) -> bool:
    """Whether the single-canvas fused kernel runs this shape (the JAX
    package's test with the card in its TPU's place): the (padded) canvas
    edge is at most ``FUSED_MAX_CANVAS``."""
    pad = 2 * half if prepad else 0
    return max(h, w) + pad <= FUSED_MAX_CANVAS


def _spectral2d(x: torch.Tensor, a, b, c, horner, half: int) -> torch.Tensor:
    """p(K) on an (N, H, W) canvas batch — circular, exact — through
    ``rfft2`` / ``irfft2`` (the JAX package's CPU route), in f32 under
    either f32 dot mode (see ``ops.spectral_matmul``)."""
    require_full_f32(x)
    n, h, w = x.shape
    qhat = _horner_spectrum(kernel_spectrum(a, b, c, h, w, half), horner)
    X = torch.fft.rfft2(x.float())
    return torch.fft.irfft2(qhat * X, s=(h, w)).to(x.dtype)


def compute_polynomial_separable(img: torch.Tensor, sigma, rho, theta,
                                 alpha, beta, prepad: bool = False,
                                 clip: bool = False,
                                 ker_size: int = 25,
                                 prefer_xla: bool = False) -> torch.Tensor:
    """Degree-3 polynomial deconvolution with per-sample Gaussian params.

    :param img: (B, C, H, W). With ``prepad`` the replicate padding by the
        kernel half-support and the final crop are fused in; otherwise the
        caller has padded already.
    :param sigma, rho, theta: (B, C) or (B, 1) per-sample blur parameters
    :param alpha, beta: Python numbers or 0-d tensors (differentiable)
    :param prefer_xla: take the plain whole-canvas composition
        (:func:`_spectral2d`) instead of the kernels, as the JAX package
        does under ``remat`` (its XLA route; ops/sep_poly.py:230, :271)
    :return: same shape and dtype as ``img``; spectra and accumulation f32
    """
    a3 = (alpha / 2.0 - beta + 2.0)
    a2 = (3.0 * beta - alpha - 6.0)
    a1 = (5.0 - 3.0 * beta + alpha / 2.0)
    return _apply_param_operator(img, sigma, rho, theta, (a3, a2, a1, beta),
                                 prepad=prepad, clip=clip, ker_size=ker_size,
                                 prefer_xla=prefer_xla)


def spectral_blur(img: torch.Tensor, sigma, rho, theta,
                  ker_size: int = 25) -> torch.Tensor:
    """One application of the sampled-kernel blur K — circular convolution
    with the estimator's 2D kernel on the given canvas, the reference's
    ``convolve2d(img, kernel, method='fft')`` — for the edgetaper blend of
    parametric kernels: the degree-1 spectrum p(z) = z through the same
    fused or blocked route, with no pad and no clip."""
    return _apply_param_operator(img, sigma, rho, theta, (0.0, 0.0, 1.0, 0.0),
                                 prepad=False, clip=False, ker_size=ker_size,
                                 prefer_xla=False)


def _clip(out: torch.Tensor, clip: bool) -> torch.Tensor:
    return out.clamp(0.0, 1.0) if clip else out


def _apply_param_operator(img, sigma, rho, theta, horner, prepad: bool,
                          clip: bool, ker_size: int,
                          prefer_xla: bool) -> torch.Tensor:
    """Routing of the spectrum-diagonal parametric operator: the fused
    kernel when the canvas fits ``FUSED_MAX_CANVAS``, the overlap-save
    block grid of the same kernel above it; with ``prefer_xla`` the plain
    whole-canvas composition, recorded under the JAX package's names."""
    from .cuda.sep_poly_fused import fused_polynomial

    if sigma.dim() != 2:
        raise ValueError("sigma/rho/theta must be (B, C') tensors")
    bsz, csz, h, w = img.shape
    half = ker_size // 2
    if half > 15:
        raise ValueError("ker_size > 31 exceeds the kernel tap tables")
    use_fused = (not prefer_xla
                 and _fused_path_eligible(h, w, prepad, half=half))
    if prepad and not use_fused:
        record_dispatch("compute_polynomial_separable",
                        "xla_sep/prepad" if prefer_xla else "prepad")
        out = _apply_param_operator(
            pad_with_kernel(img, ksize=2 * half + 1), sigma, rho, theta,
            horner, prepad=False, clip=False, ker_size=ker_size,
            prefer_xla=prefer_xla)
        return _clip(out[..., half:-half, half:-half], clip)
    if sigma.shape[1] != csz:
        sigma, rho, theta = (v.expand(bsz, csz) for v in (sigma, rho, theta))
    a, b, c = gaussian_quadratic_coeffs(*(v.reshape(-1).float()
                                          for v in (sigma, rho, theta)))
    x = img.reshape(bsz * csz, h, w)
    if use_fused:
        record_dispatch("compute_polynomial_separable", "fused")
        out = fused_polynomial(x, torch.stack([a, b, c], -1),
                               f32_vector(horner, x.device), prepad, clip,
                               half)
        return out.reshape(bsz, csz, h, w)
    if prefer_xla:
        record_dispatch("compute_polynomial_separable", "xla_sep")
        out = _spectral2d(x, a, b, c, horner, half)
        return _clip(out.reshape(bsz, csz, h, w), clip)
    record_dispatch("compute_polynomial_separable", "blocked")
    out = _blocked_polynomial(x, a, b, c, horner, half)
    return _clip(out.reshape(bsz, csz, h, w), clip)


def f32_vector(values, device) -> torch.Tensor:
    """An (n,) f32 vector of Python numbers and 0-d tensors; the tensors
    stay in the autograd graph."""
    if not any(isinstance(v, torch.Tensor) for v in values):
        return torch.tensor([float(v) for v in values], dtype=torch.float32,
                            device=device)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in values])


def _plan_block_grid(h: int, w: int, ap: int, cap: int = FUSED_MAX_CANVAS,
                     block: int | None = None):
    """(th, b0h, tw, b0w) block grid of :func:`_blocked_polynomial`,
    identical to the JAX package's planner: per axis, t blocks of
    b0 = ceil(dim / t) (b0 >= 2 ap; canvas b0 + 2 ap <= cap); jointly, the
    least ``th tw ch8 cw128 (ch8 + cw128 + BLOCK_COST_CONST)`` with the
    canvas edges rounded up to 8 rows and 128 columns. ``block`` forces a
    square block (tests)."""
    def axis_candidates(dim):
        if block is not None:
            b0 = max(block, 2 * ap)
            if b0 + 2 * ap > cap:
                raise ValueError(
                    f"block override {block} builds a {b0 + 2 * ap}px "
                    f"canvas past the cap {cap}")
            return [(-(-dim // b0), b0)]
        cands = []
        t = 1
        while True:
            b0 = max(-(-dim // t), 2 * ap)
            if b0 + 2 * ap <= cap:
                cands.append((t, b0))
            if b0 == 2 * ap:
                break
            t += 1
        if not cands:
            raise ValueError(f"axis {dim} has no blocked plan under "
                             f"canvas cap {cap} (apron {ap})")
        return cands

    best = None
    for th, b0h in axis_candidates(h):
        ch = -(-(b0h + 2 * ap) // 8) * 8
        for tw, b0w in axis_candidates(w):
            cw = -(-(b0w + 2 * ap) // 128) * 128
            cost = th * tw * ch * cw * (ch + cw + BLOCK_COST_CONST)
            if best is None or cost < best[0]:
                best = (cost, th, b0h, tw, b0w)
    return best[1:]


def _block_view(x: torch.Tensor, half: int, block: int | None = None):
    """The overlap-save blocks of an (N, H, W) canvas batch as a
    :class:`TileView` of N-plane tiles, and the plan (th, b0h, tw, b0w, ap):
    the canvas is wrap-extended by the apron ap = 3 half + 4 and zero
    beyond it out to the block grid (those cores are cropped at the end);
    block (i, j) is its (b0h + 2 ap, b0w + 2 ap) window at (i b0h, j b0w),
    cut by the kernels without a copy."""
    from .cuda.polyblur_fused import TileView

    n, h, w = x.shape
    ap = 3 * half + 4
    th, b0h, tw, b0w = _plan_block_grid(h, w, ap, block=block)
    canvas = x.new_zeros((n, 1, th * b0h + 2 * ap, tw * b0w + 2 * ap))
    rows = torch.arange(-ap, h + ap, device=x.device) % h
    cols = torch.arange(-ap, w + ap, device=x.device) % w
    canvas[:, 0, :h + 2 * ap, :w + 2 * ap] = x[:, rows][:, :, cols]
    view = TileView(canvas, n, 0, th * tw * n, tw, (b0h, b0w),
                    (b0h + 2 * ap, b0w + 2 * ap))
    return view, (th, b0h, tw, b0w, ap)


def _blocked_polynomial(x: torch.Tensor, a, b, c, horner, half: int,
                        block: int | None = None) -> torch.Tensor:
    """p(K) on an (N, H, W) canvas batch of any size via a 2D block grid
    of the fused kernel — exact overlap-save.

    The whole-canvas operator is circular convolution with a kernel of
    one-sided reach 3 half, so a block whose apron of 3 half (+4) pixels
    comes from the wrap-extended canvas reproduces the whole-canvas result
    on its core. The blocks are cut from the wrap-extended canvas by a
    :class:`TileView` (:func:`_block_view`); the wrap-pad and the
    reassembly of the cores are plain torch.

    :param a, b, c: (N,) per-sample quadratic-form scalars
    :param horner: (a3, a2, a1, beta) scalars
    """
    from .cuda.sep_poly_fused import fused_polynomial

    n, h, w = x.shape
    view, (th, b0h, tw, b0w, ap) = _block_view(x, half, block)
    bh, bw = view.patch
    params = torch.stack([a, b, c], -1).float().repeat(th * tw, 1)
    out = fused_polynomial(view, params, f32_vector(horner, x.device),
                           half=half)
    # (th tw n, 1, bh, bw), tile-major -> cores -> (n, th b0h, tw b0w)
    out = out.reshape(th, tw, n, bh, bw)[..., ap:ap + b0h, ap:ap + b0w]
    out = out.permute(2, 0, 3, 1, 4).reshape(n, th * b0h, tw * b0w)
    return out[:, :h, :w]
