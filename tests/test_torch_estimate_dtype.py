"""The whole-image blur estimate's dtype and the patch engine's default
route, polyblur_torch vs the JAX package on CPU.

* ``gaussian_blur_estimation`` keeps the image dtype where the JAX package
  does (gray mean, the plain maxima chain, angle grids, Keys weights, the
  blur model): in bf16 the theta index equals JAX's on the peacock and the
  twelve ``tests/data/corpus_hr`` photos, sigma and rho within one bf16
  ulp; the bf16 scan route end to end stays within 40 dB of JAX's.
* ``deblur_patches`` without ``method`` takes the JAX package's default,
  ``'fft'``: the composed route.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.estimation import gaussian_blur_estimation as jax_est
from polyblur_tpu.patches import deblur_patches as jax_deblur
from polyblur_tpu.utils import profiling as jprof

import polyblur_torch.pipeline as tpipe
from polyblur_torch import deblur_patches
from polyblur_torch.estimation import gaussian_blur_estimation as port_est
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

DATA = os.path.join(os.path.dirname(__file__), "data")
PHOTOS = ["peacock_defocus.png"] + sorted(
    os.path.join("corpus_hr", f)
    for f in os.listdir(os.path.join(DATA, "corpus_hr"))
    if f.endswith(".png"))
DEMO = dict(n_iter=3, c=0.362, b=0.468, alpha=6.0, beta=1.0)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}


def _load(name):
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(DATA, name)))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return (img[..., :3] / 255.0).astype(np.float32).transpose(2, 0, 1)[None]


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _bf16_ulp(v):
    """One bf16 ulp (8 significant bits) at the magnitude of ``v``."""
    return np.exp2(np.floor(np.log2(np.abs(v))) - 7)


def test_photo_list_is_the_corpus():
    assert len(PHOTOS) == 13


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", PHOTOS)
def test_estimate_matches_jax_in_the_image_dtype(name, dtype):
    """(sigma, rho, theta) of the first estimate: the peacock (700 x 500:
    matmul gradients) and the 1600 x 1200 corpus photos (FFT gradients),
    each past 640 px, so both packages take the plain maxima chain."""
    tdt, jdt = DTYPES[dtype]
    x = _load(name)
    got = port_est(torch.as_tensor(x).to(tdt), c=0.362, b=0.468,
                   return_2d_filters=False)
    want = jax_est(jnp.asarray(x).astype(jdt), c=0.362, b=0.468,
                   return_2d_filters=False)
    assert all(v.dtype == tdt and v.shape == (1, 1) for v in got)
    ts, tr, tt = (v.float().numpy() for v in got)
    js, jr, jt = (np.asarray(v, np.float32) for v in want)
    # theta is a multiple of 6 degrees: the same interpolated angle index
    np.testing.assert_array_equal(np.rint(tt * 30.0 / math.pi),
                                  np.rint(jt * 30.0 / math.pi))
    if dtype == "bf16":
        for t, j in ((ts, js), (tr, jr)):
            assert np.all(np.abs(t - j) <= _bf16_ulp(j)), (t, j)
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        np.testing.assert_allclose(tr, jr, rtol=1e-5)


def test_bf16_kernels_match_jax(peacock):
    """The 2D filters the ``'fft'`` method uses, built from the bf16
    parameters in bf16 as the JAX package builds them."""
    x = peacock.transpose(2, 0, 1)[None]
    got = port_est(torch.as_tensor(x).bfloat16(), c=0.362, b=0.468)
    want = jax_est(jnp.asarray(x).astype(jnp.bfloat16), c=0.362, b=0.468)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1, 25, 25)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-30,
                               rtol=0)


def test_bf16_scan_route_matches_jax(peacock):
    """The reference demo in bf16 through ``polyblur_core(method=
    'direct_separable')``: the scan route with the plain maxima chain and
    the blocked polynomial, against the JAX package's CPU scan route."""
    x = peacock.transpose(2, 0, 1)[None]
    kw = dict(method="direct_separable", **DEMO)
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x).bfloat16(), device="cpu",
                              **kw)
    log = dispatch_log()
    assert log[("polyblur_core", "scan/direct_separable")] == 1
    assert log[("directional_maxima", "plain")] == 3
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = jpipe.polyblur_core(jnp.asarray(x).astype(jnp.bfloat16), **kw)
    assert _psnr(got.float().numpy(), np.asarray(want, np.float32)) >= 40.0


def test_deblur_patches_default_route_is_jax_composed():
    """Without ``method`` both packages run ``'fft'``: extract ->
    ``polyblur_core`` scan -> blend, with no mega-kernel or staged
    route."""
    x = np.random.default_rng(60).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2, c=0.362,
              b=0.468, alpha=6.0, beta=1.0)
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(x), device="cpu", **kw).numpy()
    log = dispatch_log()
    assert log[("deblur_patches", "composed")] == 1
    assert ("deblur_patches", "staged_tiles") not in log
    assert log[("polyblur_core", "scan/fft")] == 1
    jprof.reset_dispatch_log()
    want = np.asarray(jax_deblur(jnp.asarray(x), **kw))
    jlog = jprof.dispatch_log()
    assert not any(k[0] == "deblur_patches" for k in jlog), jlog
    assert ("polyblur_core", "mega_pallas") not in jlog
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
