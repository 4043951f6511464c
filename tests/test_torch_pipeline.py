"""polyblur_torch whole-image route vs the JAX package on CPU.

The port's ``polyblur_deblurring`` / ``polyblur_core`` / module with
``device="cpu"`` run the plain version of every kernel along the route the
card takes (tiles route up to 640 px, blocked fused polynomial above it,
fused directional maxima up to 640 px); the JAX package runs its CPU
routes, or its tiles-mode mega kernel in Pallas interpret mode with
full-f32 dots. Inputs are made with numpy from a seed or read from
tests/data.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu.api as japi
import polyblur_tpu.ops.sep_poly as jsep
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.estimation import gaussian_blur_estimation as jax_est
from polyblur_tpu.ops.pallas.polyblur_fused import polyblur_tiles_fused
from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope

import polyblur_torch.api as tapi
import polyblur_torch.ops.sep_poly as tsep
import polyblur_torch.pipeline as tpipe
from polyblur_torch import PolyblurDeblurring, polyblur_deblurring
from polyblur_torch.estimation import gaussian_blur_estimation as port_est
from polyblur_torch.restoration import polynomial_coefficients
from polyblur_torch.utils.imaging import pad_with_kernel
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

DATA = os.path.join(os.path.dirname(__file__), "data")
DEMO = dict(n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0)
SIZES = [(97, 141), (480, 640), (481, 637), (640, 641), (500, 700),
         (1200, 1600), (100, 3000), (3000, 4000), (2000, 2000),
         (2048, 1953), (4000, 1000), (700, 6000)]


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


@pytest.mark.parametrize("method, route", [
    ("direct_separable", ("compute_polynomial_separable", "blocked")),
    ("fft", ("inverse_filtering_rank3", "generic/fft")),
])
def test_demo_matches_jax(peacock, method, route):
    """The reference demo (700 x 500 peacock, 3 iterations, alpha 6,
    beta 1): the port's blocked route / FFT route against the JAX
    package's CPU routes."""
    reset_dispatch_log()
    got = polyblur_deblurring(peacock, method=method, device="cpu", **DEMO)
    log = dispatch_log()
    assert log[("polyblur_core", f"scan/{method}")] == 1
    assert log[route] == 3
    assert log[("directional_maxima", "plain")] == 3  # 700 px > 640
    want = japi.polyblur_deblurring(peacock, method=method, **DEMO)
    assert isinstance(got, np.ndarray) and got.shape == peacock.shape
    assert _psnr(got, want) >= 60.0


def test_tiles_route_matches_mega_interpret_and_composed():
    x = np.random.default_rng(50).uniform(
        size=(1, 3, 97, 141)).astype(np.float32)
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
              method="direct_separable")
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu", **kw).numpy()
    assert dispatch_log() == {("polyblur_core", "tiles"): 1}
    coeffs = jpipe._mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    with f32_dot_mode_scope("highest"):
        mega = np.asarray(polyblur_tiles_fused(jnp.asarray(x), coeffs, 2,
                                               interpret=True))
    assert _psnr(got, mega) >= 60.0
    np.testing.assert_allclose(got, mega, atol=1e-4, rtol=0)
    composed = np.asarray(jpipe.polyblur_core(jnp.asarray(x),
                                              _disable_mega=True, **kw))
    np.testing.assert_allclose(got, composed, atol=3e-4, rtol=0)
    # bf16 input: the stages run in bf16 as the TPU kernel does
    got16 = tpipe.polyblur_core(torch.as_tensor(x).bfloat16(), device="cpu",
                                **kw)
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(polyblur_tiles_fused(
        jnp.asarray(x).astype(jnp.bfloat16), coeffs, 2, interpret=True),
        np.float32)
    assert _psnr(got16.float().numpy(), want16) >= 40.0


def test_scan_route_fused_polynomial_matches_composed():
    """``_disable_mega`` sends a small image down the scan route: the fused
    directional maxima and the prepadded fused polynomial."""
    x = np.random.default_rng(51).uniform(
        size=(2, 3, 64, 90)).astype(np.float32)
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
              method="direct_separable", _disable_mega=True)
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu", **kw).numpy()
    assert dispatch_log()[("compute_polynomial_separable", "fused")] == 2
    assert dispatch_log()[("directional_maxima", "fused")] == 2
    want = np.asarray(jpipe.polyblur_core(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the fused prepadded route is the whole-canvas rfft2 operator on the
    # replicate-padded image, cropped and clipped
    xt = torch.as_tensor(x)
    sig, rho, theta = (torch.tensor([[1.5], [0.7]]) * f for f in (1, .6, .4))
    fused = tsep.compute_polynomial_separable(xt, sig, rho, theta, 6.0, 1.0,
                                              prepad=True, clip=True)
    a, b, c = tsep.gaussian_quadratic_coeffs(
        *(v.expand(2, 3).reshape(-1) for v in (sig, rho, theta)))
    horner = (*polynomial_coefficients(6.0, 1.0), 1.0)
    padded = pad_with_kernel(xt, ksize=25).reshape(6, 64 + 24, 90 + 24)
    ref = tsep._spectral2d(padded, a, b, c, horner, 12)[:, 12:-12, 12:-12]
    np.testing.assert_allclose(fused.numpy().reshape(6, 64, 90),
                               ref.clamp(0.0, 1.0).numpy(), atol=1e-5)


def test_module_whole_image_matches_jax(peacock):
    crop = peacock[100:260, 200:420]
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0)
    port = PolyblurDeblurring(device="cpu")
    reset_dispatch_log()
    got = port(crop, **kw)
    assert dispatch_log()[("polyblur_core", "tiles")] == 1
    want = japi.PolyblurDeblurring()(crop, **kw)
    assert isinstance(got, np.ndarray) and got.shape == crop.shape
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    assert _psnr(got, want) >= 60.0


def test_first_estimate_on_corpus_photo_matches_jax():
    """1600 x 1200: the FFT gradients (past 1024 px) and the plain
    directional maxima (past 640 px)."""
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(DATA, "corpus_hr",
                                             "peacock_tiled.png")))
    x = (img[..., :3] / 255.0).astype(np.float32).transpose(2, 0, 1)[None]
    assert x.shape == (1, 3, 1200, 1600)
    reset_dispatch_log()
    ts, tr, tt = (v.numpy() for v in port_est(
        torch.as_tensor(x), c=0.362, b=0.468, return_2d_filters=False))
    assert dispatch_log() == {("directional_maxima", "plain"): 1}
    js, jr, jt = (np.asarray(v) for v in jax_est(
        jnp.asarray(x), c=0.362, b=0.468, return_2d_filters=False))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    np.testing.assert_allclose(tr, jr, rtol=1e-5)
    # the 2D kernels the 'fft' method uses
    k = port_est(torch.as_tensor(x[..., :300, :400]), c=0.362, b=0.468)
    jk = jax_est(jnp.asarray(x[..., :300, :400]), c=0.362, b=0.468)
    assert k.shape == (1, 1, 25, 25)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-6, rtol=0)


@pytest.mark.parametrize("h, w", SIZES)
def test_routing_predicates_match_jax(h, w):
    """Route parity: the same image takes the same route in both packages
    (the JAX predicates with the backend test replaced by the card)."""
    for prepad in (False, True):
        assert tsep._fused_path_eligible(h, w, prepad) == \
            jsep._fused_path_eligible(h, w, prepad, backend="tpu")
    assert tsep._plan_block_grid(h, w, 40) == jsep._plan_block_grid(h, w, 40)
    for pre, smoother in ((False, "bilateral"), (True, "domain_transform")):
        cap = tpipe.mega_tile_cap(pre, smoother)
        assert cap == jpipe.mega_tile_cap(pre, smoother)
        assert tapi._auto_tile_wanted(h, w, cap) == \
            japi._auto_tile_wanted(h, w, cap)
        assert tapi._auto_tile_plan(h, w, cap) == \
            japi._auto_tile_plan(h, w, cap)
    for method in ("direct_separable", "fft"):
        for remat in (False, True):
            args = (method, remat, False, False, False, "bilateral", 0.0,
                    25, 6, 30, h, w)
            assert tpipe._mega_static_ok(*args) == \
                jpipe._mega_static_ok(*args, interpret=True)
    assert tapi._tile_macs(h, w) == japi._tile_macs(h, w)


def test_auto_tiles_exactly_as_the_jax_package_on_its_tpu():
    """12 MP takes the 448/384 patch engine; 2 MP stays whole-image."""
    assert tapi._auto_tile_wanted(3000, 4000, 640)
    assert tapi._auto_tile_plan(3000, 4000, 640) == (448, 64.0 / 448.0)
    assert not tapi._auto_tile_wanted(1200, 1600, 640)
    # verbose (A.11) no longer raises: the whole-image stage loop prints
    # its lines and returns the pixels of verbose=False
    x = torch.rand(1, 3, 40, 56, generator=torch.Generator().manual_seed(5))
    kw = dict(n_iter=2, alpha=6.0, beta=1.0, device="cpu", method="fft")
    assert torch.equal(polyblur_deblurring(x, verbose=True, **kw),
                       polyblur_deblurring(x, **kw))


def test_deblur_patches_fft_composed_route_matches_jax():
    """``method='fft'`` on the patch engine: extract -> polyblur_core ->
    blend (patches.py:479-500), against the JAX package's same route."""
    from polyblur_tpu.patches import deblur_patches as jax_deblur

    from polyblur_torch import deblur_patches

    x = np.random.default_rng(52).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2, c=0.362,
              b=0.468, alpha=6.0, beta=1.0, method="fft")
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(x), device="cpu", batch_size=2,
                         **kw).numpy()
    log = dispatch_log()
    assert log[("deblur_patches", "composed")] == 1
    assert log[("polyblur_core", "scan/fft")] == 3  # 6 tiles, chunks of 2
    want = np.asarray(jax_deblur(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fourier_primitives_match_jax():
    from polyblur_tpu.ops import fourier as jf
    from polyblur_tpu.ops import spectral_matmul as jsm

    from polyblur_torch.ops import fourier as tf
    from polyblur_torch.ops import spectral_matmul as tsm

    rng = np.random.default_rng(53)
    x = rng.uniform(size=(2, 3, 40, 54)).astype(np.float32)
    for t, j in zip(tf.fourier_gradients(torch.as_tensor(x)),
                    jf.fourier_gradients(jnp.asarray(x))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    for t, j in zip(tsm.fourier_gradients_matmul(torch.as_tensor(x)),
                    jsm.fourier_gradients_matmul(jnp.asarray(x))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    np.testing.assert_array_equal(tsm.derivative_matrix(54).numpy(),
                                  np.asarray(jsm.derivative_matrix(54)))
    k = rng.uniform(size=(2, 1, 7, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tf.p2o(torch.as_tensor(k), (40, 54)).numpy(),
        np.asarray(jf.p2o(jnp.asarray(k), (40, 54))), atol=1e-5)
    np.testing.assert_allclose(
        tf.fft_convolve2d(torch.as_tensor(x), torch.as_tensor(k)).numpy(),
        np.asarray(jf.fft_convolve2d(jnp.asarray(x), jnp.asarray(k))),
        atol=1e-5)


def test_gaussian_and_imaging_helpers_match_jax():
    from polyblur_tpu.ops import gaussian as jg
    from polyblur_tpu.utils import imaging as ji

    from polyblur_torch.ops import gaussian as tg
    from polyblur_torch.utils import imaging as ti

    th = np.asarray([[0.3], [1.2]], np.float32)
    sg = np.asarray([[1.5], [0.4]], np.float32)
    rh = np.asarray([[0.6], [2.5]], np.float32)
    got = tg.batch_gaussian_kernels(*(torch.as_tensor(v)
                                      for v in (th, sg, rh)), 25)
    want = jg.batch_gaussian_kernels(*(jnp.asarray(v)
                                       for v in (th, sg, rh)), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    for sigma, theta, size in (((1.2, 0.5), 0.3, (15, 15)),
                               ((0.01, 0.01), 0.0, (9, 9))):  # dirac
        np.testing.assert_array_equal(
            tg.gaussian_filter_np(sigma, theta, k_size=size),
            jg.gaussian_filter_np(sigma, theta, k_size=size))
    np.testing.assert_array_equal(tg.dirac((5, 7)), jg.dirac((5, 7)))
    x = np.random.default_rng(54).uniform(size=(1, 2, 9, 11)).astype(
        np.float32)
    padded = ti.pad_with_kernel(torch.as_tensor(x), ksize=7)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(ji.pad_with_kernel(jnp.asarray(x),
                                                      ksize=7)))
    np.testing.assert_array_equal(ti.crop_with_kernel(padded, ksize=7).numpy(),
                                  x)
    np.testing.assert_array_equal(
        ti.crop(torch.as_tensor(x), (5, 20)).numpy(),
        np.asarray(ji.crop(jnp.asarray(x), (5, 20))))
