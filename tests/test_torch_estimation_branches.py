"""The rest of the blur estimate (ROADMAP A.3) and the kernels opened in
n_angles and in the half-support, polyblur_torch against the JAX package
on the CPU.

* ``q > 0`` (quantile normalization, ``jnp.quantile``'s linear rule in the
  image dtype) and ``discard_saturation`` against JAX and against the
  reference's ``est_kernel_q`` / ``est_kernel_sat`` with the tolerances of
  tests/test_estimation.py;
* ``n_angles`` 4, 8 and 12 (the fused maxima up to 640 px, the plain chain
  past it), ``ker_size`` 21 and 31 (33 raising ``ValueError``), and a
  C = 4 ``multichannel`` image (each channel on its own): the theta index
  identical, sigma and rho within 1e-5;
* the kernel wrappers' plain versions at those parameters against the JAX
  kernels in interpret mode: ``directional_maxima`` against
  ``directional_maxima_pallas`` (whose output block holds 8 angles, so
  n_angles 8 and 12 are held to JAX's XLA chain) and ``fused_polynomial``
  at half-supports 10 and 15 against ``fused_polynomial_pallas``;
* the whole pipeline at those parameters (>= 60 dB in f32).
"""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
import polyblur_tpu.estimation as jest
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.ops.pallas.est_fused import directional_maxima_pallas
from polyblur_tpu.ops.pallas.sep_poly_fused import (f32_dot_mode_scope,
                                                    fused_polynomial_pallas)
from polyblur_tpu.ops.sep_poly import \
    compute_polynomial_separable as jax_separable

import polyblur_torch.estimation as pest
from polyblur_torch.ops.cuda.est_fused import directional_maxima_plain
from polyblur_torch.ops.cuda.sep_poly_fused import fused_polynomial_plain
from polyblur_torch.ops.sep_poly import compute_polynomial_separable
from polyblur_torch.pipeline import polyblur_core
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

DATA = os.path.join(os.path.dirname(__file__), "data")
KW = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _peacock():
    img = np.asarray(Image.open(os.path.join(DATA, "peacock_defocus.png")))
    return np.ascontiguousarray((img[..., :3] / 255.0).astype(np.float32)
                                .transpose(2, 0, 1)[None])


def _images():
    """name -> (1, C, H, W) f32: the 700 x 500 peacock (plain maxima
    chain), a 320 x 400 crop of it and the four corpus fixtures (fused
    maxima, under 640 px)."""
    fx = np.load(os.path.join(DATA, "corpus_fixtures.npz"))
    out = {"peacock": _peacock(),
           "peacock_crop": _peacock()[..., 100:420, 150:550].copy()}
    for n in ("edges", "texture", "saturation", "lowcontrast"):
        out[n] = fx[f"{n}_in"][None, None].astype(np.float32)
    return out


IMAGES = _images()


def _assert_params_match(got, want):
    ts, tr, tt = (v.float().numpy() for v in got)
    js, jr, jt = (np.asarray(v, np.float32) for v in want)
    np.testing.assert_array_equal(np.rint(tt * 30.0 / math.pi),
                                  np.rint(jt * 30.0 / math.pi))
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)


def _estimates(x, **kw):
    got = pest.gaussian_blur_estimation(torch.as_tensor(x),
                                         return_2d_filters=False, **kw)
    want = jest.gaussian_blur_estimation(jnp.asarray(x),
                                         return_2d_filters=False, **kw)
    return got, want


# -------------------------------------------------- quantiles, saturation

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("q", [1e-4, 0.01, 0.25])
def test_quantile_linear_matches_jnp_quantile(q, dtype):
    x = np.random.default_rng(3).normal(size=(2, 3, 5001)).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = pest.quantile_linear(torch.as_tensor(x).to(tdt), q)
    want = jnp.quantile(jnp.asarray(x).astype(jdt), q, axis=-1,
                        keepdims=True)
    assert got.dtype == tdt and got.shape == (2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quantile_normalization_matches_reference_and_jax():
    x = _peacock()
    got = pest.gaussian_blur_estimation(torch.as_tensor(x), c=0.362,
                                         b=0.468, q=1e-4, ker_size=25)
    ref = np.load(os.path.join(DATA, "reference_fixtures.npz"))
    np.testing.assert_allclose(got.numpy(), ref["est_kernel_q"], atol=1e-4,
                               rtol=0)
    _assert_params_match(*_estimates(x, c=0.362, b=0.468, q=1e-4))


def test_saturation_mask_matches_reference_and_jax():
    ref = np.load(os.path.join(DATA, "reference_fixtures.npz"))
    x = ref["est_in_sat"].astype(np.float32)
    reset_dispatch_log()
    got = pest.gaussian_blur_estimation(torch.as_tensor(x), c=0.362,
                                         b=0.468, ker_size=25,
                                         discard_saturation=True)
    assert ("directional_maxima", "plain") in dispatch_log()
    np.testing.assert_allclose(got.numpy(), ref["est_kernel_sat"],
                               atol=1e-4, rtol=0)
    _assert_params_match(*_estimates(x, c=0.362, b=0.468,
                                     discard_saturation=True))


@pytest.mark.parametrize("name", ["peacock_crop", "saturation"])
def test_quantile_and_saturation_together_match_jax(name):
    _assert_params_match(*_estimates(IMAGES[name], q=1e-4,
                                     discard_saturation=True))


def test_bf16_quantile_estimate_matches_jax():
    x = IMAGES["peacock_crop"]
    got = pest.gaussian_blur_estimation(torch.as_tensor(x).bfloat16(),
                                         q=0.01, return_2d_filters=False)
    want = jest.gaussian_blur_estimation(jnp.asarray(x).astype(jnp.bfloat16),
                                         q=0.01, return_2d_filters=False)
    assert all(v.dtype == torch.bfloat16 for v in got)
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  np.asarray(want[2], np.float32))
    for u, v in zip(got[:2], want[:2]):
        np.testing.assert_allclose(u.float().numpy(),
                                   np.asarray(v, np.float32), rtol=2 ** -7)


# ------------------------------------------------- n_angles, multichannel

@pytest.mark.parametrize("n_angles", [4, 8, 12])
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_n_angles_estimate_matches_jax(name, n_angles):
    x = IMAGES[name]
    reset_dispatch_log()
    got, want = _estimates(x, n_angles=n_angles)
    fused = max(x.shape[-2:]) <= 640
    assert ("directional_maxima", "fused" if fused else "plain") \
        in dispatch_log()
    _assert_params_match(got, want)


def test_multichannel_four_channels_matches_jax():
    x = np.concatenate([IMAGES["peacock_crop"],
                        IMAGES["peacock_crop"].mean(1, keepdims=True)[
                            ..., ::-1, :].copy()], 1)
    for kernels in (False, True):
        got = pest.gaussian_blur_estimation(torch.as_tensor(x),
                                             multichannel=True,
                                             return_2d_filters=kernels)
        want = jest.gaussian_blur_estimation(jnp.asarray(x),
                                             multichannel=True,
                                             return_2d_filters=kernels)
        if kernels:
            assert got.shape == (1, 4, 25, 25)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
        else:
            assert all(v.shape == (1, 4) for v in got)
            _assert_params_match(got, want)


@pytest.mark.parametrize("n_angles", [4, 8, 12])
def test_directional_maxima_plain_matches_the_jax_kernel(n_angles):
    x = np.random.default_rng(4).uniform(size=(2, 3, 64, 96)).astype(
        np.float32)
    got = directional_maxima_plain(torch.as_tensor(x), n_angles).numpy()
    assert got.shape == (2, n_angles + 1)
    if n_angles + 1 <= 8:
        want = directional_maxima_pallas(jnp.asarray(x), n_angles=n_angles,
                                         interpret=True)
    else:
        want = jest._mags_xla(jnp.mean(jnp.asarray(x), 1, keepdims=True),
                              n_angles)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-6)


# ------------------------------------------------------------ ker_size

@pytest.mark.parametrize("ker_size", [21, 31])
def test_ker_size_kernels_match_jax(ker_size):
    x = IMAGES["peacock_crop"]
    got = pest.gaussian_blur_estimation(torch.as_tensor(x),
                                         ker_size=ker_size)
    want = jest.gaussian_blur_estimation(jnp.asarray(x), ker_size=ker_size)
    assert got.shape == (1, 1, ker_size, ker_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("half, replicate_pad", [(10, True), (15, False)])
def test_fused_polynomial_plain_matches_the_jax_kernel(half, replicate_pad):
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(3, 56, 72)).astype(np.float32)
    sig = rng.uniform(0.5, 3.0, size=(2, 3)).astype(np.float32)
    a, b, c = (torch.as_tensor(v) for v in _quad(sig))
    params = torch.stack([a, b, c], -1)
    coeffs = torch.tensor([1.0, -7.0, 5.0, 1.0])
    got = fused_polynomial_plain(torch.as_tensor(x), params, coeffs,
                                 replicate_pad, replicate_pad, half).numpy()
    with f32_dot_mode_scope("highest"):
        want = np.asarray(fused_polynomial_pallas(
            jnp.asarray(x), jnp.asarray(params.numpy()),
            jnp.asarray(coeffs.numpy()), replicate_pad, replicate_pad, True,
            half))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def _quad(sig):
    """(a, b, c) quadratic forms of three (sigma, rho, theta) rows."""
    from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs

    s, r = torch.as_tensor(sig[0]), torch.as_tensor(sig[1])
    t = torch.tensor([0.0, 0.7, 2.1])
    return (v.numpy() for v in gaussian_quadratic_coeffs(s, r, t))


@pytest.mark.parametrize("ker_size", [21, 31, 33])
@pytest.mark.parametrize("shape", [(1, 3, 96, 128), (1, 1, 720, 700)])
def test_ker_size_polynomial_matches_jax(shape, ker_size):
    """The fused route (prepadded canvas within 664 px) and the blocked
    one (past it); 33 taps exceed the 32-column tap tables in both."""
    x = np.random.default_rng(6).uniform(size=shape).astype(np.float32)
    sigma, rho, theta = (torch.tensor([[v]]) for v in (1.7, 0.8, 0.6))
    args = (6.0, 1.0)
    if ker_size == 33:
        with pytest.raises(ValueError, match="31"):
            compute_polynomial_separable(torch.as_tensor(x), sigma, rho,
                                         theta, *args, prepad=True,
                                         ker_size=ker_size)
        with pytest.raises(ValueError, match="31"):
            jax_separable(jnp.asarray(x), *(jnp.asarray(v.numpy())
                                            for v in (sigma, rho, theta)),
                          *args, prepad=True, ker_size=ker_size)
        return
    reset_dispatch_log()
    got = compute_polynomial_separable(torch.as_tensor(x), sigma, rho, theta,
                                       *args, prepad=True, clip=True,
                                       ker_size=ker_size).numpy()
    route = "fused" if max(shape[-2:]) + ker_size - 1 <= 664 else "blocked"
    assert ("compute_polynomial_separable", route) in dispatch_log()
    want = np.asarray(jax_separable(
        jnp.asarray(x), *(jnp.asarray(v.numpy()) for v in (sigma, rho,
                                                           theta)),
        *args, prepad=True, clip=True, ker_size=ker_size))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


# ------------------------------------------------------------ pipelines

@pytest.mark.parametrize("extra", [
    dict(method="direct_separable", n_angles=8),
    dict(method="direct_separable", ker_size=21, n_angles=12),
    dict(method="direct_separable", ker_size=31, n_angles=4,
         edgetaping=True),
    dict(method="fft", q=1e-4, discard_saturation=True),
    dict(method="direct", multichannel_kernel=True),
], ids=["n8", "k21_n12", "k31_n4_taper", "fft_q_sat", "direct_mc4"])
def test_pipeline_branches_match_jax(extra):
    x = IMAGES["peacock_crop"]
    if extra.get("multichannel_kernel"):
        x = np.concatenate([x, x.mean(1, keepdims=True)], 1)
    reset_dispatch_log()
    got = polyblur_core(torch.as_tensor(x), device="cpu", **KW, **extra)
    assert ("polyblur_core", f"scan/{extra['method']}") in dispatch_log()
    want = np.asarray(jpipe.polyblur_core(jnp.asarray(x), **KW, **extra))
    assert _psnr(got.numpy(), want) >= 60.0
