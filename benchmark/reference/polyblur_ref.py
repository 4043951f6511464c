"""Plain reference of the patch path and of whole photos, in float64
PyTorch.

What a call of the program computes, worked out again from the photo
alone, with the FFT where the program multiplies by DFT tables, in
float64 except where a storage precision rounds: the canvas and the
state after each iteration are stored in it, and each convolution reads
its operand in it. That precision is float32, above the bf16
configurations' work dtype, so that the program's own rounding is part
of what the check measures, not copied into the reference (at a bf16 path's rounding, with
every flag on, the rounding's share of a photo's change is close to the
restoration's own). Called with a lower precision it is the control:
a dtype of PyTorch's, or ``"tfloat32"``, float32 with its mantissa
rounded to TF32's 10 bits, the precision of a tensor-core product whose
operands are not split. Nothing here imports the program or takes a
table, weight or intermediate from it.

Per tile (teboli/polyblur ``deblurring.py``, ``blur_estimation.py``,
``filters.py``, ``domain_transform.py``, as the tiled path runs them):

1. the estimate: the channel mean, stretched to [0, 1]; its spectral
   gradients (``2 pi i f`` on the FFT, f as ``fftfreq``); the maxima of
   ``|cos t gx - sin t gy|`` at 7 angles ``k pi / 6``; Keys-cubic
   interpolation to 30 angles; the blur direction at the first minimum,
   the orthogonal one 90 degrees on; ``sigma^2 = clip(c^2 / (f^2 + 1e-8) -
   b^2, 0.09, 16)`` for both;
2. the kernel: 25 x 25 taps of the Gaussian of that quadratic form,
   normalized; its OTF on the tile replicate-padded by 12;
3. with the domain-transform prefilter: one iteration of the recursive
   filter (``sigma_s``, ``sigma_r``) along rows, then columns; ``noise``
   is the tile less the smooth part, and the smooth part is restored;
4. with the edgetaper: three blends ``a u + (1 - a) K u`` on the padded
   canvas, ``a`` the outer product of the kernel's normalized projection
   autocorrelations;
5. ``p(K) u`` with ``p(z) = ((a3 z + a2) z + a1) z + beta``, circular on
   the (padded) canvas, cropped back to the tile, clipped to [0, 1];
   with halo removal first the gradient-inversion mask against the
   input tile's gradients; then ``+ noise``, clipped again;

and the tiles blended by the periodic Kaiser window (beta 5), divided by
the window sum, clipped and cropped to the photo.

A configuration whose ``layout`` is ``"whole"`` (the functional API's
route, teboli/polyblur ``deblurring.py`` ``polyblur_deblurring``) has no
grid: each photo of the batch is one tile of the steps above, at its own
size, padded by 12, convolved circularly on that canvas and cropped back;
no window, no even crop.
"""

from __future__ import annotations

import math

import torch

from ..grid import plan, whole

F64 = torch.float64
HALF = 12                          # kernel half-support: 25 taps
N_ANGLES = 6                       # maxima at N_ANGLES + 1 angles
N_INTERP = 30                      # interpolated angles, 6 degrees apart
N_TAPERS = 3                       # edgetaper blends per iteration

#: float32 with a 10-bit mantissa: no dtype of PyTorch's
TF32 = "tfloat32"
#: the precisions a configuration names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn, TF32: TF32}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    x = x.to(torch.float32)
    if dtype == TF32:
        # the 13 low mantissa bits rounded off, on the magnitude's bits
        b = x.view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32).to(F64)
    return x.to(dtype).to(F64)


class _Rounded(torch.autograd.Function):
    """The rounding with the identity for its gradient: a cast's own
    backward would round the float64 cotangent to the storage precision
    too (float8 flushes a loss's small cotangents to zero)."""

    @staticmethod
    def forward(ctx, x, dtype):
        return _round(x, dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (to nearest, ties to even) and back; in
    a graph, its gradient passes as it is."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rounded.apply(x, dtype)
    return _round(x, dtype)


def replicate_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., h, w) padded by ``p`` on each side with its edge values."""
    shape = x.shape
    y = torch.nn.functional.pad(x.reshape(-1, 1, *shape[-2:]), (p,) * 4,
                                mode="replicate")
    return y.reshape(*shape[:-2], *y.shape[-2:])


# ------------------------------------------------------------- estimate

def gradients(x: torch.Tensor):
    """Spectral gradients (gx along the columns, gy along the rows) of
    the circular (..., h, w) planes."""
    h, w = x.shape[-2:]
    fx = torch.fft.fftfreq(w, dtype=F64, device=x.device)
    fy = torch.fft.fftfreq(h, dtype=F64, device=x.device)[:, None]
    gx = torch.fft.ifft(torch.fft.fft(x, dim=-1) * (2j * math.pi * fx),
                        dim=-1).real
    gy = torch.fft.ifft(torch.fft.fft(x, dim=-2) * (2j * math.pi * fy),
                        dim=-2).real
    return gx, gy


def keys_weights(device) -> torch.Tensor:
    """(30, 7) Keys-cubic weights from the 7 measured angles to the 30
    interpolated ones (degrees truncated to integers, divided by 30), each
    row divided by its sum + 1e-5."""
    x = torch.floor(torch.linspace(0, 180, N_ANGLES + 1, dtype=F64)) / N_INTERP
    xn = torch.floor(torch.arange(0, 180, 180 / N_INTERP, dtype=F64)) / N_INTERP
    d = (xn[:, None] - x[None, :]).abs()
    w = torch.where(d < 1, (1.5 * d - 2.5) * d * d + 1,
                    torch.where(d < 2, ((-0.5 * d + 2.5) * d - 4) * d + 2,
                                torch.zeros_like(d)))
    return (w / (w.sum(1, keepdim=True) + 1e-5)).to(device)


def estimate(x: torch.Tensor, c: float, b: float):
    """The blur of each (n, C, ph, pw) tile: (qa, qb, qc), each (n,), the
    quadratic form of its Gaussian (qa on the column offset squared, qc on
    the row offset squared)."""
    g = x.mean(1)
    lo = g.amin((-2, -1), keepdim=True)
    hi = g.amax((-2, -1), keepdim=True)
    g = ((g - lo) / (hi - lo).clamp(min=1e-8)).clamp(0.0, 1.0)
    gx, gy = gradients(g)
    angles = [k * math.pi / N_ANGLES for k in range(N_ANGLES + 1)]
    maxima = torch.stack([(math.cos(t) * gx - math.sin(t) * gy).abs()
                          .amax((-2, -1)) for t in angles], -1)
    vals = maxima @ keys_weights(x.device).T                   # (n, 30)
    idx = vals.argmin(-1)
    mn = vals.gather(-1, idx[:, None])[:, 0]
    mo = vals.gather(-1, ((idx + N_INTERP // 2) % N_INTERP)[:, None])[:, 0]
    sigma2 = (c * c / (mn * mn + 1e-8) - b * b).clamp(0.09, 16.0)
    rho2 = (c * c / (mo * mo + 1e-8) - b * b).clamp(0.09, 16.0)
    t = -idx.to(F64) * (180.0 / N_INTERP) * math.pi / 180.0
    ct, st = torch.cos(t), torch.sin(t)
    qa = ct * ct / sigma2 + st * st / rho2
    qb = st * ct * (1.0 / sigma2 - 1.0 / rho2)
    qc = ct * ct / rho2 + st * st / sigma2
    return qa, qb, qc


def taps(qa, qb, qc) -> torch.Tensor:
    """(n, 25, 25) normalized kernels: row offset j, column offset t."""
    t = torch.arange(-HALF, HALF + 1, dtype=F64, device=qa.device)
    tx, ty = t[None, None, :], t[None, :, None]
    q = (qa[:, None, None] * tx * tx + 2.0 * qb[:, None, None] * tx * ty
         + qc[:, None, None] * ty * ty)
    k = torch.exp(-0.5 * q)
    return k / k.sum((-2, -1), keepdim=True)


def otf(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n, h, w // 2 + 1) real half-spectrum of the centred (n, 25, 25)
    kernels on the circular (h, w) canvas."""
    z = torch.zeros((k.shape[0], h, w), dtype=F64, device=k.device)
    z[:, :2 * HALF + 1, :2 * HALF + 1] = k
    z = torch.roll(z, (-HALF, -HALF), (-2, -1))
    return torch.fft.rfft2(z).real


def convolve(u: torch.Tensor, spectrum: torch.Tensor,
             work: torch.dtype) -> torch.Tensor:
    """Circular convolution of the (n, C, h, w) canvases, read in the work
    dtype as the products' operands are, with the (n, h, w // 2 + 1) real
    spectra."""
    h, w = u.shape[-2:]
    return torch.fft.irfft2(torch.fft.rfft2(rounded(u, work))
                            * spectrum[:, None], s=(h, w))


# ------------------------------------------------------------- features

def taper_weights(qa, qb, qc, h: int, w: int):
    """(av (n, h), ah (n, w)): 1 less the kernel projection's
    autocorrelation at lags 0..24, over its value at lag 0, at both ends
    of the canvas axis, and 1 between."""
    k = taps(qa, qb, qc)
    px = k.sum(-2)                         # over rows: a function of t
    py = k.sum(-1)                         # over columns: of j

    def vector(p, length):
        n = 2 * HALF + 1
        ac = torch.stack([(p[:, :n - d] * p[:, d:]).sum(-1)
                          for d in range(n)], -1)
        v = torch.ones((p.shape[0], length), dtype=F64, device=p.device)
        v[:, :n] = 1.0 - ac / ac[:, :1]
        v[:, length - n:] = torch.flip(1.0 - ac / ac[:, :1], (-1,))
        return v

    return vector(py, h), vector(px, w)


def recursive_filter(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The domain transform's bidirectional first-order filter along the
    last axis: ``y[i] = (1 - v[i]) x[i] + v[i] y[i - 1]`` with v[0] = 0,
    then ``z[i] = (1 - v[i + 1]) y[i] + v[i + 1] z[i + 1]`` with v[w] =
    0; ``v`` broadcasts to ``x``."""
    v = v.expand(x.shape)
    w = x.shape[-1]
    y = torch.empty_like(x)
    y[..., 0] = x[..., 0]
    for i in range(1, w):
        y[..., i] = (1.0 - v[..., i]) * x[..., i] + v[..., i] * y[..., i - 1]
    z = torch.empty_like(x)
    z[..., w - 1] = y[..., w - 1]
    for i in range(w - 2, -1, -1):
        z[..., i] = ((1.0 - v[..., i + 1]) * y[..., i]
                     + v[..., i + 1] * z[..., i + 1])
    return z


def domain_transform(x: torch.Tensor, sigma_s: float, sigma_r: float):
    """One iteration (sigma_H = sigma_s) of the recursive filter on the
    (n, C, ph, pw) tiles, its feedback ``exp(-sqrt 2 / sigma_s * (1 +
    sigma_s / sigma_r * sum_C |d x|))`` shared by a tile's channels:
    (smooth, noise = x - smooth)."""
    n, c, h, w = x.shape
    ratio = sigma_s / sigma_r
    log_a = -math.sqrt(2.0) / sigma_s
    dx = (x[..., :, 1:] - x[..., :, :-1]).abs().sum(1)
    dy = (x[..., 1:, :] - x[..., :-1, :]).abs().sum(1)
    dh = torch.nn.functional.pad(ratio * dx, (1, 0)) + 1.0
    dv = torch.nn.functional.pad(ratio * dy, (0, 0, 1, 0)) + 1.0
    rows = recursive_filter(x, torch.exp(dh * log_a)[:, None])
    smooth = recursive_filter(rows.transpose(-1, -2),
                              torch.exp(dv * log_a)[:, None].transpose(-1, -2)
                              ).transpose(-1, -2)
    return smooth, x - smooth


# --------------------------------------------------------------- tiles

def horner(call: dict):
    """(a3, a2, a1, beta) of the restoration polynomial."""
    alpha, beta = call["alpha"], call["beta"]
    return (alpha / 2 - beta + 2, 3 * beta - alpha - 6,
            5 - 3 * beta + alpha / 2, beta)


def restore_tiles(x: torch.Tensor, call: dict, work: torch.dtype):
    """``call["n_iter"]`` iterations on the (n, C, ph, pw) tiles, already
    in the work dtype's values; returns them in the same form."""
    n, c, ph, pw = x.shape
    h, w = ph + 2 * HALF, pw + 2 * HALF
    a3, a2, a1, beta = horner(call)
    halo = call.get("remove_halo", False)
    taper = call.get("edgetaping", False)
    prefilter = call.get("prefiltering", False)
    if prefilter and call.get("smoother") != "domain_transform":
        raise ValueError("the reference prefilters with the domain "
                         "transform only")
    if halo:
        g0x, g0y = gradients(x)
        nm = (g0x * g0x + g0y * g0y).sum((-2, -1), keepdim=True)
    for _ in range(call["n_iter"]):
        qa, qb, qc = estimate(x, call["c"], call["b"])
        khat = otf(taps(qa, qb, qc), h, w)
        base, noise = x, None
        if prefilter:
            base, noise = domain_transform(x, call["sigma_s"], call["sigma_r"])
        u = replicate_pad(base, HALF)
        if taper:
            av, ah = taper_weights(qa, qb, qc, h, w)
            a = (av[:, :, None] * ah[:, None, :])[:, None]
            for _ in range(N_TAPERS):
                u = a * u + (1.0 - a) * convolve(u, khat, work)
        o = convolve(u, ((a3 * khat + a2) * khat + a1) * khat + beta, work)
        o = o[..., HALF:HALF + ph, HALF:HALF + pw]
        if halo:
            gox, goy = gradients(o)
            m = -(g0x * gox) - (g0y * goy)
            z = (m / (nm + m + 1e-12)).clamp(min=0.0)
            o = o + z * (u[..., HALF:HALF + ph, HALF:HALF + pw] - o)
        o = o.clamp(0.0, 1.0)
        if noise is not None:
            o = (o + noise).clamp(0.0, 1.0)
        x = rounded(o, work)
    return x


def kaiser(n: int, beta: float = 5.0) -> torch.Tensor:
    """The periodic Kaiser window of length ``n``."""
    k = torch.arange(n + 1, dtype=F64)
    r = 2.0 * k / n - 1.0
    return (torch.special.i0(beta * torch.sqrt(1.0 - r * r))
            / torch.special.i0(torch.tensor(beta, dtype=F64)))[:n]


def _grid(photos: torch.Tensor, config: dict, work):
    """(grid, canvas, window) of the tiled layout: the photos' even crop
    replicate-padded to the grid's canvas and stored in ``work``, and the
    2-D Kaiser window of one tile."""
    call = config["call"]
    _, _, hh, ww = photos.shape
    g = plan(hh, ww, call["patch_size"], call["overlap"])
    (h, w), (hc, wc), p = g.crop, g.canvas, g.patch
    top, _, left, _ = g.pad
    canvas = torch.nn.functional.pad(
        photos[..., :h, :w].to(F64),
        (left, wc - w - left, top, hc - h - top), mode="replicate")
    canvas = rounded(canvas, work)
    win = kaiser(p).to(photos.device)
    return g, canvas, win[:, None] * win[None, :]


def _tiles(canvas: torch.Tensor, part, p: int) -> torch.Tensor:
    """The (len(part) * B, C, p, p) tiles of the canvas at the origins
    ``part``, tile-major."""
    return torch.cat([canvas[..., i:i + p, j:j + p] for i, j in part])


def _blend(photos: torch.Tensor, config: dict, work, block: int):
    """(blend, window sum, grid, canvas, window): the tiles restored in
    blocks of ``block`` and blended over the canvas, divided by the window
    sum, unclipped."""
    call = config["call"]
    bsz, c = photos.shape[:2]
    g, canvas, win = _grid(photos, config, work)
    (hc, wc), p = g.canvas, g.patch
    acc = torch.zeros((bsz, c, hc, wc), dtype=F64, device=photos.device)
    wsum = torch.zeros((hc, wc), dtype=F64, device=photos.device)
    origins = g.origins()
    for t0 in range(0, len(origins), block):
        part = origins[t0:t0 + block]
        out = restore_tiles(_tiles(canvas, part, p), call, work).reshape(
            len(part), bsz, c, p, p)
        for k, (i, j) in enumerate(part):
            acc[..., i:i + p, j:j + p] += out[k] * win
            wsum[i:i + p, j:j + p] += win
    return acc / (wsum + 1e-8), wsum, g, canvas, win


def _crop(x: torch.Tensor, g) -> torch.Tensor:
    """The photo's even crop of a canvas-sized ``x``."""
    (h, w), (top, _, left, _) = g.crop, g.pad
    return x[..., top:top + h, left:left + w]


def restore(photos: torch.Tensor, config: dict, work=torch.float32,
            block: int = 24) -> torch.Tensor:
    """The reference's restoration of the (B, C, H, W) photos under the
    configuration's call, with ``work`` as the stored precision; (B, C,
    h, w) float64, (h, w) the photo's even crop, or the whole photo where
    the layout is ``"whole"``. Tiles, or whole photos, go through in
    blocks of ``block``."""
    if whole(config):
        x = rounded(photos, work)
        return torch.cat([restore_tiles(x[i:i + block], config["call"], work)
                          for i in range(0, x.shape[0], block)])
    blend, _, g, _, _ = _blend(photos, config, work, block)
    return _crop(blend.clamp(0.0, 1.0), g)


# ------------------------------------------------------------ training

#: the learnable scalars of a training step, in the call's names, each
#: with the shape a block's tiles take it in, one value a tile: the
#: estimate's against its (n,) maxima, the polynomial's against the (n, h,
#: w) spectra
SCALARS = ("c", "b", "alpha", "beta")
_PER_TILE = {"c": (-1,), "b": (-1,), "alpha": (-1, 1, 1), "beta": (-1, 1, 1)}


def loss_and_grads(blurry: torch.Tensor, sharp: torch.Tensor, config: dict,
                   scalars: dict, work=torch.float32, block: int = 24):
    """(loss, {name: gradient}, restored, {name: mass}) of one training
    step on the tiled layout: the mean squared error of :func:`restore` of
    ``blurry`` at the scalars ``scalars`` (``{name: float}``, the rest of
    the call as the configuration states it) against ``sharp`` (cropped as
    the restoration is), its gradient in each scalar by float64 autograd,
    the restoration, (B, C, h, w) float64, and each gradient's mass: the
    sum over the tiles of the magnitude of each tile's share of it (a
    gradient far below its mass is what is left of shares that cancel).

    In blocks, so that the graph of one block of tiles at a time is held:
    the forward runs once without a graph for the blend and its clip; the
    loss's cotangent on each tile is then ``window * clip mask * 2 (out -
    sharp) / N / window sum`` over the tile's place on the canvas (zero
    outside the photo's crop), and each block's vector-Jacobian product
    through :func:`restore_tiles` at the same scalars is summed. Where the
    program's backward may depart: the clips pass the gradient at their
    bounds (``torch.clamp``'s rule), the blur direction's argmin and the
    storage roundings pass the float64 cotangent as it is (the rounding
    taken as the identity), and the loss is float64 where the program's is
    float32. Each tile takes the scalars as leaves of its own, so that one
    product gives every tile's share."""
    if whole(config):
        raise ValueError("loss_and_grads takes the tiled layout only")
    call = dict(config["call"], **scalars)
    with torch.no_grad():
        blend, wsum, g, canvas, win = _blend(blurry, dict(config, call=call),
                                             work, block)
        out = _crop(blend, g)
        clip = (out >= 0.0) & (out <= 1.0)
        out = out.clamp(0.0, 1.0)
        diff = out - sharp[..., :out.shape[-2], :out.shape[-1]].to(F64)
        loss = float((diff * diff).mean())
        cot = torch.zeros_like(blend)
        _crop(cot, g).copy_(clip * 2.0 * diff / diff.numel())
        cot /= wsum + 1e-8
    grads, mass = dict.fromkeys(scalars, 0.0), dict.fromkeys(scalars, 0.0)
    origins, p = g.origins(), g.patch
    for t0 in range(0, len(origins), block):
        part = origins[t0:t0 + block]
        x = _tiles(canvas, part, p)
        leaves = {k: torch.full((x.shape[0],), float(v), dtype=F64,
                                device=x.device, requires_grad=True)
                  for k, v in scalars.items()}
        with torch.enable_grad():
            tiles = restore_tiles(x, dict(call, **{
                k: v.view(_PER_TILE[k]) for k, v in leaves.items()}), work)
        vjp = torch.autograd.grad(tiles, list(leaves.values()),
                                  _tiles(cot, part, p) * win,
                                  allow_unused=True)
        for k, v in zip(leaves, vjp):
            if v is not None:
                grads[k] += float(v.sum())
                mass[k] += float(v.abs().sum())
    return loss, grads, out, mass
