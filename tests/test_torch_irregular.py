"""polyblur_torch's irregular tile grids vs the JAX package on CPU.

A grid whose overlap passes 50% (or whose coordinates are off one step)
takes the composed route in both packages: extract the tiles, run
``polyblur_core`` on them (the port's tiles route, the JAX package's scan
route on the CPU), blend by slice-adds in coordinate order
(polyblur_tpu/patches.py:268-300) in the wider of the tile and output
dtypes. 64 px tiles at overlap 0.6 step by 25 px.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu.patches as jpatches
from polyblur_tpu.api import PolyblurDeblurring as JaxModule
from polyblur_tpu.estimation import gaussian_blur_estimation as jax_est
from polyblur_tpu.pipeline import polyblur_core as jax_core

from polyblur_torch import PolyblurDeblurring, PolyblurLayer
from polyblur_torch.estimation import gaussian_blur_estimation as port_est
from polyblur_torch.patches import (PatchGrid, _grid_steps, deblur_patches,
                                    extract_patches, overlap_add,
                                    plan_patch_grid)
from polyblur_torch.pipeline import polyblur_core
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

from test_torch_training import _grad_db, _jax_grads, _pair, _torch_grads

BASE = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
            method="direct_separable")
GRID = dict(patch_size=64, overlap=0.6)
#: the gradient gates: image >= 80 dB, scalars within 1.4e-4 relative
GRAD_DB = 80.0
GRAD_RTOL = 1.4e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's PyTorch CPU work on one thread: the suite runs
    files in parallel workers, and the plain path's many small operations
    slow down by an order of magnitude when every worker's thread pool
    spans all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(40).uniform(
        size=(1, 3, 160, 224)).astype(np.float32)


def test_overlap_past_half_is_an_irregular_grid():
    grid = plan_patch_grid(160, 224, **GRID)
    assert _grid_steps(grid) is None
    assert len(grid.coords) == 40 and grid.padded_size == (164, 239)
    assert grid == jpatches.plan_patch_grid(160, 224, **GRID)
    # the 12 MP grid of chip_smoke's phase (m): 16 x 21 tiles at step 179
    grid = plan_patch_grid(3000, 4000, 448, 0.6)
    assert _grid_steps(grid) is None and len(grid.coords) == 336


def test_f32_matches_jax_and_theta_per_tile(img):
    """>= 60 dB against the JAX package's composed route, and the blur
    direction of every tile equal to JAX's at every iteration."""
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(img), device="cpu", **GRID,
                         **BASE).numpy()
    assert dispatch_log() == {("deblur_patches", "composed"): 1,
                              ("polyblur_core", "tiles"): 1}
    want = np.asarray(jpatches.deblur_patches(jnp.asarray(img), **GRID,
                                              **BASE))
    assert got.shape == want.shape == img.shape
    assert _psnr(got, want) >= 60.0
    tiles = extract_patches(torch.as_tensor(img),
                            plan_patch_grid(160, 224, **GRID))
    for n_iter in range(BASE["n_iter"]):
        kw = dict(BASE, n_iter=n_iter)
        t_in = polyblur_core(tiles, device="cpu", **kw)
        j_in = jax_core(jnp.asarray(tiles.numpy()), **kw)
        tt = port_est(t_in, c=0.362, b=0.468, return_2d_filters=False)[2]
        jt = jax_est(j_in, c=0.362, b=0.468, return_2d_filters=False)[2]
        np.testing.assert_array_equal(np.rint(tt.numpy() * 30.0 / math.pi),
                                      np.rint(np.asarray(jt) * 30.0
                                              / math.pi))


@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_bf16_matches_jax(img, out_dtype):
    """bf16 tiles blend in bf16 without ``out_dtype`` and in f32 with it,
    as the JAX package's blend (>= 40 dB)."""
    got = deblur_patches(torch.as_tensor(img), device="cpu",
                         work_dtype=torch.bfloat16,
                         out_dtype=out_dtype and torch.float32, **GRID,
                         **BASE)
    want = jpatches.deblur_patches(jnp.asarray(img), work_dtype=jnp.bfloat16,
                                   out_dtype=out_dtype and jnp.float32,
                                   **GRID, **BASE)
    assert got.dtype == (torch.float32 if out_dtype else torch.bfloat16)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    assert _psnr(_np(got), _np(want)) >= 40.0


def test_batch2_chunked_matches_jax():
    """Batch 2 in chunks of 3 tile coordinates (the last chunk short;
    the JAX package pads it with the last tile) equals the all-tiles
    pass and holds JAX's output."""
    x = np.random.default_rng(41).uniform(
        size=(2, 3, 160, 224)).astype(np.float32)
    got = deblur_patches(torch.as_tensor(x), device="cpu", batch_size=3,
                         **GRID, **BASE).numpy()
    np.testing.assert_array_equal(
        got, deblur_patches(torch.as_tensor(x), device="cpu", **GRID,
                            **BASE).numpy())
    want = np.asarray(jpatches.deblur_patches(jnp.asarray(x), batch_size=3,
                                              **GRID, **BASE))
    assert _psnr(got, want) >= 60.0


HAND_COORDS = ((0, 0), (0, 24), (10, 0), (10, 24), (24, 0), (24, 24))


@pytest.mark.parametrize("dtype, out_dtype", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "float32"),
    ("float32", "bfloat16")])
def test_overlap_add_hand_built_grid_matches_jax(dtype, out_dtype):
    """tests/test_patches.py:139-149's hand-built irregular coordinates
    (rows 0, 10, 24): the port's blend against the JAX package's (atol
    1e-6 in f32; the blend dtype is the wider of tile and output)."""
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(1, 2, 64, 64)).astype(np.float32)
    grid = PatchGrid((64, 64), (64, 64), (40, 40), HAND_COORDS, (0, 0, 0, 0))
    jgrid = jpatches.PatchGrid(*grid)
    assert _grid_steps(grid) is None
    tiles = extract_patches(torch.as_tensor(img), grid)
    jtiles = jpatches.extract_patches(jnp.asarray(img), jgrid)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))
    got = overlap_add(tiles.to(getattr(torch, dtype)), grid, 1,
                      out_dtype=out_dtype and getattr(torch, out_dtype))
    want = jpatches.overlap_add(jtiles.astype(dtype), jgrid, 1,
                                out_dtype=out_dtype)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    if dtype == out_dtype or out_dtype is None and dtype == "float32":
        # covered everywhere: the windowed mean is the image
        np.testing.assert_allclose(_np(got), img, atol=1e-5, rtol=0)


def test_module_numpy_adapter_irregular_matches_jax(peacock):
    crop = peacock[:128, :192]
    kw = dict(BASE, method="fft")
    port = PolyblurDeblurring(patch_decomposition=True, patch_size=64,
                              patch_overlap=0.6, batch_size=5, device="cpu")
    got = port(crop, **kw)
    want = JaxModule(patch_decomposition=True, patch_size=64,
                     patch_overlap=0.6, batch_size=5)(crop, **kw)
    assert isinstance(got, np.ndarray) and got.shape == crop.shape
    assert _psnr(got, want) >= 60.0


def test_gradients_through_irregular_grid_match_jax():
    """d loss / d (image, c, b, alpha, beta) through an irregular grid:
    the blend's slice-adds differentiate by slicing. Against ``jax.grad``
    of the JAX package's composed route (measured 126.4 dB, 5.4e-5)."""
    x, tgt = _pair(96, 128, 3, y=40, x=100)
    kw = dict(BASE, **GRID)
    kw.pop("c"), kw.pop("b"), kw.pop("alpha"), kw.pop("beta")
    got = _torch_grads(lambda v, c, b, a, be: deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **kw), x, tgt)
    want = _jax_grads(lambda v, c, b, a, be: jpatches.deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, **kw), x, tgt)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert _grad_db(got[1], want[1]) >= GRAD_DB
    np.testing.assert_allclose(got[2], want[2], rtol=GRAD_RTOL, atol=0)
    assert (want[2] != 0).all()


def test_layer_step_through_irregular_grid():
    """``PolyblurLayer`` with the patch engine at overlap 0.6: one Adam
    step moves every scalar, and its gradients equal the functional
    form's."""
    x, tgt = (torch.as_tensor(v) for v in _pair(96, 128, 3, y=40, x=100))
    layer = PolyblurLayer(n_iter=2, learnable=True, patch_size=64,
                          patch_overlap=0.6, method="direct_separable",
                          device="cpu")
    loss = ((layer(x) - tgt) ** 2).mean()
    loss.backward()
    grads = [float(getattr(layer, k).grad) for k in ("c", "b", "alpha",
                                                     "beta")]
    _, _, want = _torch_grads(lambda v, c, b, a, be: deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **GRID, n_iter=2,
        method="direct_separable"), x.numpy(), tgt.numpy(),
        (0.362, 0.468, 6.0, 1.0))
    np.testing.assert_allclose(grads, want, rtol=1e-6)
    before = [float(getattr(layer, k).detach()) for k in ("c", "b", "alpha",
                                                          "beta")]
    torch.optim.Adam(layer.parameters(), lr=1e-2).step()
    after = [float(getattr(layer, k).detach()) for k in ("c", "b", "alpha",
                                                         "beta")]
    assert all(a != b for a, b in zip(after, before))
