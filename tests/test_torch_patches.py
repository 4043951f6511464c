"""polyblur_torch patch engine, the whole slice, vs the JAX package on CPU.

The port's ``deblur_patches(device="cpu")`` runs the plain version of every
kernel; the JAX reference runs its mega kernel in Pallas interpret mode
(``_mega_interpret=True``) with full-f32 dots, or its composed XLA path.
"""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu.api as japi
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.api import PolyblurDeblurring as JaxModule
from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope
from polyblur_tpu.patches import deblur_patches as jax_deblur

import polyblur_torch
from polyblur_torch import PolyblurDeblurring, deblur_patches
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

BASE = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
            method="direct_separable")
GRID = dict(patch_size=160, overlap=32.0 / 160.0)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _port(img, **kw):
    return deblur_patches(torch.as_tensor(img), device="cpu", **kw).numpy()


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(30).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)


def test_f32_matches_mega_interpret_and_composed(img):
    reset_dispatch_log()
    got = _port(img, out_dtype=torch.float32, **GRID, **BASE)
    assert ("deblur_patches", "staged_tiles") in dispatch_log()
    with f32_dot_mode_scope("highest"):
        mega = np.asarray(jax_deblur(jnp.asarray(img), _mega_interpret=True,
                                     out_dtype=jnp.float32, **GRID, **BASE))
    assert got.shape == mega.shape == img.shape
    assert _psnr(got, mega) >= 60.0
    np.testing.assert_allclose(got, mega, atol=1e-4, rtol=0)
    composed = np.asarray(jax_deblur(jnp.asarray(img), _disable_blended=True,
                                     out_dtype=jnp.float32, **GRID, **BASE))
    np.testing.assert_allclose(got, composed, atol=3e-4, rtol=0)


def test_bf16_work_dtype_matches_mega_interpret(img):
    got = _port(img, work_dtype=torch.bfloat16, out_dtype=torch.float32,
                **GRID, **BASE)
    want = np.asarray(jax_deblur(jnp.asarray(img), _mega_interpret=True,
                                 work_dtype=jnp.bfloat16,
                                 out_dtype=jnp.float32, **GRID, **BASE))
    assert got.dtype == np.float32
    assert _psnr(got, want) >= 40.0


def test_unaligned_grid_matches_mega_dma_interpret():
    """The truncating 400/0.25 grid (step 300), which the TPU serves with
    its DMA-mode kernel; the port has one route for every regular grid."""
    x = np.random.default_rng(31).uniform(
        size=(1, 1, 500, 520)).astype(np.float32)
    kw = dict(patch_size=400, overlap=0.25, n_iter=1, alpha=6.0, beta=1.0,
              method="direct_separable")
    got = _port(x, **kw)
    with f32_dot_mode_scope("highest"):
        want = np.asarray(jax_deblur(jnp.asarray(x), _mega_interpret=True,
                                     **kw))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_batch2_chunked_matches_mega_dma_interpret():
    """Batch 2 with 2-coordinate chunks (the TPU's DMA mode + fused
    overlap-add route) against one all-tiles pass and the JAX kernel."""
    x = np.random.default_rng(32).uniform(
        size=(2, 3, 200, 300)).astype(np.float32)
    got = _port(x, batch_size=2, **GRID, **BASE)
    assert np.array_equal(got, _port(x, **GRID, **BASE))
    with f32_dot_mode_scope("highest"):
        want = np.asarray(jax_deblur(jnp.asarray(x), _mega_interpret=True,
                                     **GRID, **BASE))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_module_numpy_adapter_matches_jax(peacock):
    crop = peacock[:240, :320]
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
              method="direct_separable")
    port = PolyblurDeblurring(patch_decomposition=True, patch_size=160,
                              patch_overlap=0.2, device="cpu")
    assert isinstance(port, torch.nn.Module)
    assert not list(port.parameters())
    got = port(crop, **kw)
    want = JaxModule(patch_decomposition=True, patch_size=160,
                     patch_overlap=0.2)(crop, **kw)
    assert isinstance(got, np.ndarray) and got.shape == crop.shape
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    # method='auto' is the direct_separable route
    np.testing.assert_array_equal(port(crop, **dict(kw, method="auto")), got)


def test_extract_patches_matches_jax():
    from polyblur_tpu.patches import extract_patches as jax_extract
    from polyblur_tpu.patches import plan_patch_grid as jax_plan

    from polyblur_torch.patches import extract_patches, plan_patch_grid

    x = np.random.default_rng(33).uniform(
        size=(2, 3, 201, 299)).astype(np.float32)
    grid = plan_patch_grid(201, 299, 160, 32.0 / 160.0)
    got = extract_patches(torch.as_tensor(x), grid)
    want = np.asarray(jax_extract(jnp.asarray(x),
                                  jax_plan(201, 299, 160, 32.0 / 160.0)))
    assert got.shape == want.shape == (2 * len(grid.coords), 3, 160, 160)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_by_default_and_raises_without_it(img):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deblur_patches(torch.as_tensor(img), **GRID, **BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolyblurDeblurring(patch_decomposition=True)(img[0].transpose(1, 2, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polyblur_torch.polyblur_deblurring(img[0].transpose(1, 2, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        polyblur_torch.polyblur_deblurring(torch.as_tensor(img))


@pytest.mark.parametrize("call", [
    lambda x: (polyblur_torch.pipeline.polyblur_core(
        x, device="cpu", prefiltering=True, smoother="nc"),
        jpipe.polyblur_core(jnp.asarray(x.numpy()), prefiltering=True,
                            smoother="nc")),
    lambda x: (polyblur_torch.polyblur_deblurring(x, device="cpu",
                                                  discard_saturation=True),
               japi.polyblur_deblurring(jnp.asarray(x.numpy()),
                                        method="direct_separable",
                                        discard_saturation=True)),
    lambda x: (polyblur_torch.polyblur_deblurring(x, device="cpu",
                                                  method="direct"),
               japi.polyblur_deblurring(jnp.asarray(x.numpy()),
                                        method="direct")),
    lambda x: (deblur_patches(x, device="cpu", method="direct_separable",
                              multichannel_kernel=True),
               jax_deblur(jnp.asarray(x.numpy()), method="direct_separable",
                          multichannel_kernel=True)),
    lambda x: (deblur_patches(x, device="cpu", method="direct_separable",
                              q=0.01),
               jax_deblur(jnp.asarray(x.numpy()), method="direct_separable",
                          q=0.01)),
    lambda x: (deblur_patches(x, device="cpu", patch_size=160, overlap=0.6),
               jax_deblur(jnp.asarray(x.numpy()), patch_size=160,
                          overlap=0.6)),
])
def test_unported_routes_raise_naming_the_roadmap(call):
    """The routes that raised naming their ROADMAP item until A.3, A.8
    and A.6 were ported (the 'nc' smoother, the saturation mask,
    method='direct', the multichannel kernel and q > 0 through the patch
    engine, which composes them as the JAX package does, and an irregular
    grid, overlap 0.6) run on the CPU and hold the JAX package's output
    at >= 60 dB."""
    x = torch.rand(1, 3, 200, 300, generator=torch.Generator().manual_seed(7))
    got, want = call(x)
    assert _psnr(got.numpy(), np.asarray(want)) >= 60.0


@pytest.mark.parametrize("method", ["direct_separable", "fft"])
def test_misspelt_keyword_raises_on_both_routes(method):
    """A keyword polyblur_core does not take raises TypeError, on the
    staged route ('direct_separable') as on the composed one ('fft')."""
    x = torch.rand(1, 3, 96, 128, generator=torch.Generator().manual_seed(3))
    with pytest.raises(TypeError, match="edgetapping"):
        deblur_patches(x, device="cpu", patch_size=64, overlap=0.25,
                       method=method, edgetapping=True)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import polyblur_torch\n"
        "for m in pkgutil.walk_packages(polyblur_torch.__path__,\n"
        "                               'polyblur_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(\n"
        "       ('jax.', 'jaxlib', 'polyblur_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('polyblur_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
