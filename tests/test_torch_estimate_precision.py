"""The precision choice of the estimate's derivative products, on the CPU.

``csrc/estimate.cu`` runs the blur estimate's and the halo mask's
derivative products gx = g Dw^T and gy = Dh g on the tensor cores as
3xTF32: every f32 operand a = hi + lo with hi = a rounded to the nearest
tf32 (ties away from zero, as ``cvt.rna.tf32.f32``) and lo = tf32(a - hi),
and a b ~ hi lo + lo hi + hi hi accumulated in f32. This module tests no
kernel: it emulates that split in numpy (tf32 rounding by bit arithmetic on
float32, three float32 products) on the tiles the patch engine cuts from
real photos (the peacock and four corpus photos, 448 px tiles at step 384,
bf16 and f32 canvases), and holds the result to the gates the kernel is
held to on the card (``chip_smoke.py``): the blur direction (theta index)
identical to the exact-f32 plain estimate's on every tile, the other
estimate values within TOL_REL_EST = 1e-4 relative, and the gradients
within TOL_REL_GRADS = 1e-5 of max |g|.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from polyblur_torch.estimation import directional_maxima, weighted_sum
from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast_plain
from polyblur_torch.ops.cuda.polyblur_fused import (
    TileView, _gray_norm_plain, _split_tf32, _tf32, estimate_rows,
    estimate_tables, tile_estimate_plain)
from polyblur_torch.patches import _grid_steps, plan_patch_grid
from polyblur_torch.pipeline import _mega_pack

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL_REL_EST = 1e-4
TOL_REL_GRADS = 1e-5
PHOTOS = ["peacock_defocus.png", "corpus_hr/peacock_tiled.png",
          "corpus_hr/deadleaves_coarse.png", "corpus_hr/mosaic_fine.png",
          "corpus_hr/hicontrast_leaves.png"]


def split_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernel forms it: 3xTF32 with float32 accumulation."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _tiles(path: str, dtype: torch.dtype) -> TileView:
    """The 448 px tiles at step 384 of a photo's canvas in ``dtype``, as
    the 12 MP main path cuts them."""
    img = np.asarray(Image.open(os.path.join(DATA, path)))[..., :3]
    x = torch.as_tensor((img / 255.0).astype(np.float32).transpose(2, 0, 1)
                        [None].copy())
    grid = plan_patch_grid(x.shape[-2], x.shape[-1], 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast_plain(x, grid.orig_size, grid.pad, dtype)
    return TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("path", PHOTOS)
def test_split_tf32_keeps_the_estimate_gates(path, dtype):
    view = _tiles(path, dtype)
    coeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    t = estimate_tables(448, 448, "cpu")
    g = _gray_norm_plain(view).numpy()
    dw, dh = t.dw.numpy(), t.dh.numpy()
    gx = torch.as_tensor(split_matmul(g, dw.T))
    gy = torch.as_tensor(split_matmul(dh, g))
    gx_p, gy_p = (torch.as_tensor(v) for v in (g @ dw.T, dh @ g))
    scale = float(gx_p.abs().max())
    assert float((gx - gx_p).abs().max()) <= TOL_REL_GRADS * scale
    assert float((gy - gy_p).abs().max()) <= TOL_REL_GRADS * scale
    vals = weighted_sum(t.wts, directional_maxima(gx, gy, t.cs))
    est = estimate_rows(vals, coeffs)
    est_p = tile_estimate_plain(view, coeffs)
    assert torch.equal(est[:, 0], est_p[:, 0]), (
        f"theta index differs on tiles "
        f"{torch.nonzero(est[:, 0] != est_p[:, 0]).flatten().tolist()}")
    rel = ((est[:, 1:] - est_p[:, 1:]).abs()
           / est_p[:, 1:].abs().clamp(min=1e-30)).max()
    assert float(rel) <= TOL_REL_EST


def test_tf32_rounding_is_to_nearest_ties_away():
    x = np.array([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -12, 1.0 - 2.0 ** -24, 3.0], np.float32)
    want = np.array([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10),
                     1.0, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)
    # the split's remainder is exact in tf32 for any value a tf32 hi leaves
    rng = np.random.default_rng(0)
    a = rng.uniform(-2.0, 2.0, 10000).astype(np.float32)
    hi = _tf32(a)
    lo = _tf32(a - hi)
    assert np.all(np.abs(a - hi) <= np.abs(a) * 2.0 ** -11)
    assert np.all(np.abs((a - hi) - lo) <= np.abs(a) * 2.0 ** -22)
    # the kernel's host tables are that split, K zero-padded to 64
    d = rng.uniform(-1.0, 1.0, (3, 70)).astype(np.float32)
    d2 = _split_tf32(d)
    assert d2.shape == (2, 3, 128) and not d2[:, :, 70:].any()
    np.testing.assert_array_equal(d2[0, :, :70], _tf32(d))
    np.testing.assert_array_equal(d2[1, :, :70], _tf32(d - _tf32(d)))
