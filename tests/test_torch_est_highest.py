"""The 'highest' case of the estimate's derivative GEMM (``csrc/estimate.cu``
``mma_step_hi``): its product order, its split in registers, and on the
card its outputs.

CPU, in NumPy:

* the kernel's order, a table of (A piece, B piece) per 8-deep slice for
  each consumer warpgroup (``KERNEL_ORDER``, 0 hi, 1 mid, 2 lo), held bit
  for bit to the order of the three-piece design it replaces, as
  ``tools/dot_mode_emulation.py``'s ``6_order`` models it (a fresh
  truncating accumulator per 32-deep K step, the step promoted by a
  rounded f32 add): gx = g Dw^T as built, and gy = Dh g, which the kernel
  computes as gy^T = g^T Dh^T with the factors of each product swapped, on
  a band of 16 output rows of a 448 px corpus tile; both >= 110 dB from
  float64. The unswapped order on gy^T is not bit-equal: the check sees
  the order;
* the split the consumers make in registers (``split4<3>``: each piece
  the tf32 rounding, to nearest with ties away from zero, of what the
  larger pieces leave) bit-equal to the host's ``_split_tf32(.., 3)`` over
  random f32 values, 0, 1, subnormals and values on a tf32 rounding tie,
  with the rounding written from its definition.

CUDA (``test_cuda_*``, skipped without a card): ``tile_estimate`` and the
halo under ``'highest'`` against their plain versions (theta identical,
``TOL_REL_EST``; gradients ``TOL_REL_GRADS``, mask 1e-4), the launches
counted as ``name[highest]``. This file imports no JAX: ``python -m pytest
--noconftest tests/test_torch_est_highest.py -k cuda`` runs them on a
machine without it.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from polyblur_torch import f32_dot_mode_scope
from polyblur_torch.ops import cuda as pcuda
from polyblur_torch.ops.cuda.features import (halo_grads, halo_grads_plain,
                                              halo_mask, halo_mask_plain)
from polyblur_torch.ops.cuda.polyblur_fused import (
    TileView, _gray_norm_plain, _maxima_plain, _split_tf32, estimate_launches,
    estimate_tables, tile_estimate, tile_estimate_plain)
from polyblur_torch.pipeline import _mega_pack

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from dot_mode_emulation import SMALL_FIRST, _mm  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
TILE = 448
BAND = slice(208, 224)           # 16 output rows of the tile
PSNR_MIN_DB = 110.0
TOL_REL_EST = 1e-4               # chip_smoke.py's
TOL_REL_MAXIMA = 1e-4
TOL_REL_GRADS = 1e-5
TOL_MASK = 1e-4

# (A piece, B piece) of the five small products of an 8-deep slice, as
# mma_step_hi issues them; A is the data (g for gx, g^T for gy^T), B the
# table (Dw, Dh)
KERNEL_ORDER = {
    "gx": [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1)],
    "gyT": [(0, 2), (2, 0), (1, 1), (0, 1), (1, 0)],
}


def _db(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-30))


@pytest.fixture(scope="module")
def tile():
    """The normalized gray g of a 448 px crop of a corpus photo and the
    derivative tables (f32, as the kernel's operands)."""
    img = np.asarray(Image.open(os.path.join(
        DATA, "corpus_hr", "mosaic_mixed.png")).convert("RGB"))
    x = torch.tensor(img[:TILE, :TILE].astype(np.float32) / 255.0)
    x = x.permute(2, 0, 1)[None].contiguous()
    g = _gray_norm_plain(TileView.of_tiles(x))[0].numpy()
    t = estimate_tables(TILE, TILE, "cpu")
    return g, t.dw.numpy(), t.dh.numpy()


def test_gx_order_is_the_three_piece_order(tile):
    g, dw, _ = tile
    a, b = g[BAND], np.ascontiguousarray(dw.T)
    ref = _mm(a, b, "6_order")
    got = _mm(a, b, "6_order", small=KERNEL_ORDER["gx"])
    assert np.array_equal(got, ref)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _db(got.astype(np.float32), exact) >= PSNR_MIN_DB


def test_gy_transposed_order_is_the_three_piece_order(tile):
    g, _, dh = tile
    ref = _mm(dh[BAND], g, "6_order")                # A = Dh, B = g
    gt, dht = np.ascontiguousarray(g.T), np.ascontiguousarray(dh[BAND].T)
    got = _mm(gt, dht, "6_order", small=KERNEL_ORDER["gyT"]).T
    assert np.array_equal(got, ref)
    exact = dh[BAND].astype(np.float64) @ g.astype(np.float64)
    assert _db(got.astype(np.float32), exact) >= PSNR_MIN_DB
    # the three-piece table on the swapped factors is another order
    assert not np.array_equal(_mm(gt, dht, "6_order", small=SMALL_FIRST).T,
                              ref)


def _tf32_by_definition(x: np.ndarray) -> np.ndarray:
    """The tf32 value nearest to each f32 (the f32 values whose low 13
    significand bits are 0), ties away from zero."""
    bits = x.view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32)  # toward zero
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(
        np.float32)                                         # away from it
    xd, dd, ud = (v.astype(np.float64) for v in (x, down, up))
    take_up = np.abs(ud - xd) <= np.abs(xd - dd)
    return np.where(take_up & ((bits & np.uint32(0x1FFF)) != 0), up, down)


def _split3_in_registers(x: np.ndarray) -> np.ndarray:
    """split4<3> of the kernel: each piece the tf32 rounding of what the
    larger pieces leave, the remainder formed in f32."""
    out, r = [], x.astype(np.float32)
    for _ in range(3):
        p = _tf32_by_definition(r)
        out.append(p)
        r = (r - p).astype(np.float32)
    return np.stack(out)


def test_split_in_registers_matches_the_host_split():
    rng = np.random.default_rng(18)
    ties = ((rng.integers(0x00800000, 0x7F000000, 64, dtype=np.uint32)
             & np.uint32(0xFFFFE000)) | np.uint32(0x1000)).view(np.float32)
    sub = (rng.integers(1, 0x00800000, 64, dtype=np.uint32)).view(np.float32)
    vals = np.concatenate([
        rng.random(4096, dtype=np.float32),
        (rng.standard_normal(1024) * 10.0 ** rng.integers(-30, 30, 1024))
        .astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 0.5, np.float32(1) - np.float32(
            2 ** -24)], np.float32),
        ties, -ties, sub, -sub,
        np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23],
                 np.float32)])
    got = _split3_in_registers(vals)
    want = _split_tf32(vals[None], 3)[:, 0, :vals.size]
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # three pieces of 11 bits hold an f32 of 24 exactly, where the pieces
    # stay normal (a subnormal's remainder falls below the tf32 quantum)
    big = np.abs(vals) >= 1e-30
    assert np.array_equal(got[:, big].astype(np.float64).sum(0),
                          vals[big].astype(np.float64))


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tiles(dev, n, h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.asarray(Image.open(os.path.join(
        DATA, "corpus_hr", "peacock_tiled.png")).convert("RGB"))
    out = np.empty((n, 3, h, w), np.float32)
    for i in range(n):
        y = int(rng.integers(0, img.shape[0] - h))
        x = int(rng.integers(0, img.shape[1] - w))
        out[i] = img[y:y + h, x:x + w].transpose(2, 0, 1) / 255.0
    return torch.tensor(out, device=dev)


@pytest.mark.parametrize("n, h, w, c", [(3, 448, 448, 3), (2, 200, 328, 3),
                                        (1, 481, 637, 3), (1, 480, 640, 1)])
def test_cuda_tile_estimate_highest_matches_plain(cuda_dev, n, h, w, c):
    x = _tiles(cuda_dev, n, h, w, 1)
    view = TileView.of_tiles(x[:, :c].contiguous())
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8, device=cuda_dev)
    want = tile_estimate_plain(view, coeffs)
    with f32_dot_mode_scope("highest"):
        before = dict(pcuda.launches)
        got = tile_estimate(view, coeffs)
        torch.cuda.synchronize()
        name = "tile_estimate[highest]"
        assert pcuda.launches[name] - before.get(name, 0) == 4
    assert torch.equal(got[:, 0], want[:, 0])
    rel = ((got[:, 1:] - want[:, 1:]).abs()
           / want[:, 1:].abs().clamp(min=1e-30)).max()
    assert float(rel) <= TOL_REL_EST


@pytest.mark.parametrize("n_angles", [4, 8])
def test_cuda_maxima_any_angles_highest_matches_plain(cuda_dev, n_angles):
    """Another angle count than the estimate's 7 (the kMaximaAny epilogue
    of the same GEMM)."""
    view = TileView.of_tiles(_tiles(cuda_dev, 2, 448, 448, 5))
    want = _maxima_plain(view, n_angles)
    with f32_dot_mode_scope("highest"):
        maxima, _, runs = estimate_launches(view, "est_highest_test",
                                            n_angles=n_angles)
        for run in runs[:3]:
            run()
        torch.cuda.synchronize()
        assert pcuda.launches["est_highest_test[highest]"] >= 3
    rel = ((maxima - want).abs() / want.abs().clamp(min=1e-30)).max()
    assert float(rel) <= TOL_REL_MAXIMA


@pytest.mark.parametrize("n, h, w", [(2, 448, 448), (1, 200, 328)])
def test_cuda_halo_highest_matches_plain(cuda_dev, n, h, w):
    view = TileView.of_tiles(_tiles(cuda_dev, n, h, w, 2))
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.random((n, 3, h, w), np.float32) * 1.2 - 0.1,
                     device=cuda_dev)
    u = TileView.of_tiles(_tiles(cuda_dev, n, h, w, 4))
    noise = torch.tensor(rng.standard_normal((n, 3, h, w)).astype(
        np.float32) * 0.01, device=cuda_dev)
    gp = halo_grads_plain(view)
    want = halo_mask_plain(o, gp, u, noise, torch.empty_like(o))
    with f32_dot_mode_scope("highest"):
        before = dict(pcuda.launches)
        grads = halo_grads(view)
        got = halo_mask(o, grads, u, noise, torch.empty_like(o))
        torch.cuda.synchronize()
        assert pcuda.launches["halo[highest]"] - before.get(
            "halo[highest]", 0) == 2
    scale = float(gp.gx.abs().max())
    for a, b in ((grads.gx, gp.gx), (grads.gy, gp.gy)):
        assert float((a - b).abs().max()) / scale <= TOL_REL_GRADS
    assert float((got - want).abs().max()) <= TOL_MASK
