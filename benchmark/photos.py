"""The photos a cell's calls restore, made on the device from the seed.

Each photo is synthetic and blurred the way the upstream calibrates its
blur model (teboli/polyblur ``calibrate_blur_parameters.py``): a Gaussian
random field with a 1/f^a amplitude spectrum (natural images lie near
a = 1.1) mixed with a piecewise-constant Voronoi layer for edges at every
orientation, then blurred by an anisotropic Gaussian of its own (sigma and
rho drawn from the traffic's ranges, theta uniform), then 1% Gaussian noise
as upstream ``main.py --synthetic_degradation`` adds, clipped to [0, 1].
Every tile then carries content, and a blur, of its own.

The traffic file gives the batch of one call, the least size of the pool
the calls cycle through (several times the 50 MB L2 cache, so that no call
finds its photo in cache) and the content's parameters. The sizes never
depend on the seed; only the content does. A training traffic (``"job":
"train"``) pairs each batch with its sharp photos: the field and Voronoi
mix before the blur and the noise, already in [0, 1]. Keeping them draws
nothing more, so its blurry photos are those of any other traffic with the
same seed and content.
"""

from __future__ import annotations

import math

import torch

#: rows of the Voronoi layer labelled at once (bounds its temporary)
_LABEL_ROWS = 256


def pool_calls(config: dict, traffic: dict) -> int:
    """How many calls' worth of photos the pool holds."""
    p = config["photo"]
    call_bytes = traffic["batch"] * p["channels"] * p["height"] * p["width"] * 4
    return max(int(traffic["pool_calls_min"]),
               math.ceil(traffic["pool_bytes_min"] / call_bytes))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 64) - 1))
    return gen


def _uniform(gen, lo: float, hi: float, device) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=gen, device=device))


def _field(gen, c: int, h: int, w: int, exponent: float, device):
    """(c, h, w) Gaussian random field with a 1/f^exponent amplitude
    spectrum, each channel stretched to [0, 1]."""
    white = torch.randn((c, h, w), generator=gen, device=device)
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    x = torch.fft.irfft2(torch.fft.rfft2(white) * f.pow(-exponent), s=(h, w))
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo + 1e-12)


def _voronoi(gen, c: int, h: int, w: int, cells: int, device):
    """(c, h, w) flat colours in [0.05, 0.95], each pixel the colour of its
    nearest of ``cells`` random sites."""
    sy = torch.rand(cells, generator=gen, device=device) * h
    sx = torch.rand(cells, generator=gen, device=device) * w
    cols = 0.05 + 0.9 * torch.rand((cells, c), generator=gen, device=device)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    dx2 = (xx[:, None] - sx[None, :]) ** 2                    # (w, cells)
    out = torch.empty((c, h, w), device=device)
    for r0 in range(0, h, _LABEL_ROWS):
        yy = torch.arange(r0, min(h, r0 + _LABEL_ROWS), device=device,
                          dtype=torch.float32)
        d = (yy[:, None, None] - sy) ** 2 + dx2[None]         # (r, w, cells)
        out[:, r0:r0 + len(yy)] = cols[d.argmin(-1)].permute(2, 0, 1)
    return out


def _blur(x, sigma: float, rho: float, theta: float, radius: int):
    """``x`` (c, h, w) convolved with the normalized anisotropic Gaussian
    of std ``sigma`` along ``theta`` and ``rho * sigma`` across it, on the
    photo reflected by ``radius`` at its borders, through the FFT."""
    c, h, w = x.shape
    t = torch.arange(-radius, radius + 1, device=x.device, dtype=torch.float64)
    ty, tx = t[:, None], t[None, :]
    u = math.cos(theta) * tx + math.sin(theta) * ty
    v = -math.sin(theta) * tx + math.cos(theta) * ty
    k = torch.exp(-0.5 * ((u / sigma) ** 2 + (v / (rho * sigma)) ** 2))
    k = (k / k.sum()).float()
    xp = torch.nn.functional.pad(x[None], (radius,) * 4, mode="reflect")[0]
    hp, wp = xp.shape[-2:]
    kp = torch.zeros((hp, wp), device=x.device)
    kp[:2 * radius + 1, :2 * radius + 1] = k
    kp = torch.roll(kp, (-radius, -radius), (0, 1))
    y = torch.fft.irfft2(torch.fft.rfft2(xp) * torch.fft.rfft2(kp), s=(hp, wp))
    return y[:, radius:radius + h, radius:radius + w]


def make_photo(gen, config: dict, content: dict, device,
               sharp: bool = False):
    """One (C, H, W) f32 photo in [0, 1]; with ``sharp``, the pair (photo,
    the photo before its blur and noise)."""
    p = config["photo"]
    c, h, w = p["channels"], p["height"], p["width"]
    mix = content["field_weight"]
    x = (mix * _field(gen, c, h, w, content["field_exponent"], device)
         + (1.0 - mix) * _voronoi(gen, c, h, w, content["voronoi_cells"],
                                  device))
    sigma = _uniform(gen, *content["sigma"], device)
    rho = _uniform(gen, *content["rho"], device)
    theta = _uniform(gen, 0.0, math.pi, device)
    radius = math.ceil(3.0 * content["sigma"][1])
    y = _blur(x, sigma, rho, theta, radius)
    y = y + content["noise_std"] * torch.randn(y.shape, generator=gen,
                                               device=device)
    y = y.clamp(0.0, 1.0).contiguous()
    return (y, x) if sharp else y


def training(traffic: dict) -> bool:
    """Whether the traffic's calls are training steps on (blurry, sharp)
    pairs."""
    return traffic.get("job") == "train"


def make_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """The pool of one cell: :func:`pool_calls` batches, each (B, C, H, W)
    f32 on ``device``, made from ``seed``; for a training traffic each a
    (blurry, sharp) pair of such batches."""
    gen = generator(seed, device)
    b, pairs = traffic["batch"], training(traffic)
    pool = []
    for _ in range(pool_calls(config, traffic)):
        made = [make_photo(gen, config, traffic["content"], device, pairs)
                for _ in range(b)]
        pool.append(tuple(torch.stack(t) for t in zip(*made)) if pairs
                    else torch.stack(made))
    return pool
