"""The pair schedule of the bilateral kernel (``csrc/bilateral.cu``) on the
CPU.

The kernel spends one exponential per neighbour pair: for each of the 12
offsets d of a half-neighbourhood it builds the weight map
``F_d(r) = exp(-(P(r + d) - P(r))^2 k) gw[d]`` over the replicate-padded
plane P, and pixel p takes ``F_d(p)`` for its tap +d and ``F_d(p - d)`` for
its tap -d, summing the 25 taps in the 25-tap form's order (dy outer, dx
inner) with the same rounded operations. Emulated here in torch f32:

* with the same f32 exponential as the 25-tap form (``exp`` in float64,
  rounded to f32: the plain version's), the pair schedule is bit-equal to
  the direct 25-tap form, on odd sizes and on planes of height or width 1,
  2 and 3, where the clamp makes several taps one pixel;
* with the kernel's base-2 exponential of an argument prescaled by
  log2(e) (its ex2 is the MUFU's approximation, not emulated), within
  ``TOL`` of ``_bilateral_plain``;
* the direct form is within ``TOL`` of ``_bilateral_plain`` and of the JAX
  package's ``bilateral_pallas(..., interpret=True)``;
* the path the kernel serves, at a small size: ``deblur_patches`` with
  ``prefiltering=True`` and the default smoother (the staged route's
  bilateral stage) against the JAX package's ``deblur_patches`` with its
  mega kernel in interpret mode, atol 3e-4 in f32 (as
  tests/test_torch_features.py holds the staged route), >= 40 dB with the
  bf16 work dtype.

Inputs are seeded numpy draws. ``TOL`` is chip_smoke's ``TOL_BILATERAL``:
the kernel against its plain version on the card.
"""

import math

import numpy as np
import pytest
import torch

from polyblur_torch.ops.bilateral import _bilateral_plain, spatial_weights

TOL = 1e-5
K, R = 5, 2
SIGMA_S, SIGMA_C = 5.0, 0.1
# the half-neighbourhood, in the kernel's order
PAIRS = [(0, 1), (0, 2)] + [(dy, dx) for dy in (1, 2) for dx in range(-2, 3)]
SIZES = [(1, 1), (1, 2), (2, 1), (1, 7), (6, 1), (2, 3), (3, 2), (3, 3),
         (5, 5), (7, 33), (13, 130), (4, 9)]


def _exp_f32(a: torch.Tensor) -> torch.Tensor:
    """The plain version's f32 exponential: exp in float64, rounded."""
    return torch.exp(a.double()).float()


def _exp2_f32(a: torch.Tensor) -> torch.Tensor:
    return torch.exp2(a.double()).float()


def _padded(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H + 4, W + 4), replicate-clamped."""
    h, w = x.shape[-2:]
    rows = torch.arange(-R, h + R).clamp(0, h - 1)
    cols = torch.arange(-R, w + R).clamp(0, w - 1)
    return x[..., rows, :][..., cols]


def _direct(x: torch.Tensor, exp=_exp_f32, k: float | None = None):
    """The 25-tap form in f32, each tap's weight and sums rounded as the
    kernel rounds them."""
    h, w = x.shape[-2:]
    gw = spatial_weights(K, SIGMA_S)
    k = torch.tensor(k if k is not None else 1.0 / (2.0 * SIGMA_C ** 2),
                     dtype=torch.float32)
    p = _padded(x)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(K):
        for dx in range(K):
            s = p[..., dy:dy + h, dx:dx + w]
            d = s - x
            f = exp((-d * d) * k) * float(gw[dy, dx])
            num = num + f * s
            den = den + f
    return num / (den + 1e-5)


def _pairs(x: torch.Tensor, exp=_exp_f32, k: float | None = None):
    """The kernel's schedule: 12 weight maps over the padded plane, the
    weight of tap -d read at p - d, the centre's weight gw."""
    h, w = x.shape[-2:]
    gw = spatial_weights(K, SIGMA_S)
    k = torch.tensor(k if k is not None else 1.0 / (2.0 * SIGMA_C ** 2),
                     dtype=torch.float32)
    p = _padded(x)
    hp, wp = p.shape[-2:]
    maps = {}
    for dy, dx in PAIRS:
        # F_d[r] for every padded r whose r + d lies in the padded plane
        lo, hi = max(0, -dx), wp - max(0, dx)
        d = p[..., dy:hp, lo + dx:hi + dx] - p[..., :hp - dy, lo:hi]
        f = torch.full_like(p, math.nan)
        f[..., :hp - dy, lo:hi] = exp((-d * d) * k) * float(gw[R + dy,
                                                              R + dx])
        maps[(dy, dx)] = f
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for ty in range(-R, R + 1):
        for tx in range(-R, R + 1):
            s = p[..., R + ty:R + ty + h, R + tx:R + tx + w]
            if (ty, tx) == (0, 0):
                f = torch.full_like(x, float(gw[R, R]))
            elif (ty, tx) in maps:   # tap +d: F_d at p
                f = maps[(ty, tx)][..., R:R + h, R:R + w]
            else:                    # tap -d: F_d at p - d = p + (ty, tx)
                f = maps[(-ty, -tx)][..., R + ty:R + ty + h,
                                     R + tx:R + tx + w]
            num = num + f * s
            den = den + f
    return num / (den + 1e-5)


def _image(h: int, w: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (2, 3, h, w))
                            .astype(np.float32))


@pytest.mark.parametrize("h, w", SIZES)
def test_pair_schedule_bit_equal_to_direct(h, w):
    """One exponential per pair gives the 25-tap form's bits: the pair's
    two taps round (s - x)^2 alike, and gw is symmetric."""
    x = _image(h, w, 100 + h * 131 + w)
    got, want = _pairs(x), _direct(x)
    assert not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_spatial_weights_centrally_symmetric():
    """The kernel refuses weights that are not (one weight per pair)."""
    gw = spatial_weights(K, SIGMA_S)
    assert np.array_equal(gw, gw[::-1, ::-1])


@pytest.mark.parametrize("h, w", [(1, 1), (2, 3), (7, 33), (13, 130)])
def test_pair_schedule_base2_within_tol_of_plain(h, w):
    """The kernel's weights: 2^(-(s - x)^2 k log2(e)), the argument rounded
    in f32 from the host's prescaled k (its MUFU ex2 not emulated)."""
    x = _image(h, w, 200 + h + w)
    k2 = float(np.float32(np.float32(1.0 / (2.0 * SIGMA_C ** 2))
                          * np.float64(math.log2(math.e))))
    got = _pairs(x, exp=_exp2_f32, k=k2)
    want = _bilateral_plain(x, K, SIGMA_S, SIGMA_C)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("h, w", [(1, 1), (3, 2), (5, 5), (7, 33),
                                  (21, 40)])
def test_direct_within_tol_of_plain_and_pallas(h, w):
    import jax.numpy as jnp

    from polyblur_tpu.ops.pallas.bilateral import bilateral_pallas

    x = _image(h, w, 300 + h + w)
    got = _direct(x)
    plain = _bilateral_plain(x, K, SIGMA_S, SIGMA_C)
    pallas = np.asarray(bilateral_pallas(jnp.asarray(x.numpy()), K, SIGMA_S,
                                         SIGMA_C, interpret=True))
    assert float((got - plain).abs().max()) <= TOL
    assert float(np.abs(got.numpy() - pallas).max()) <= TOL


@pytest.mark.parametrize("work", ["f32", "bf16"])
def test_staged_patches_bilateral_prefilter_match_mega_interpret(work):
    import jax.numpy as jnp
    import polyblur_tpu.patches as jpatch
    from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope

    from polyblur_torch import deblur_patches
    from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

    x = np.random.default_rng(40).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
              method="direct_separable", prefiltering=True, patch_size=160,
              overlap=0.2)
    wd = (torch.float32, jnp.float32) if work == "f32" else (
        torch.bfloat16, jnp.bfloat16)
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(x), device="cpu", work_dtype=wd[0],
                         out_dtype=torch.float32, **kw).numpy()
    assert dispatch_log() == {("deblur_patches", "staged_tiles"): 1}
    with f32_dot_mode_scope("highest"):
        want = np.asarray(jpatch.deblur_patches(
            jnp.asarray(x), _mega_interpret=True, work_dtype=wd[1],
            out_dtype=jnp.float32, **kw))
    assert got.shape == want.shape == x.shape
    if work == "f32":
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    else:
        mse = np.mean((got.astype(np.float64) - want) ** 2)
        assert 10.0 * math.log10(1.0 / max(mse, 1e-20)) >= 40.0
