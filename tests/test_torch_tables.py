"""polyblur_torch host tables and tile grids vs the JAX package: bit-equal.

Polyblur has no learned weights; what the port carries over from the JAX
package is its constant tables, its coefficient vector and its tile grid
plan, and each must be identical, not merely close.
"""

import numpy as np
import pytest

import polyblur_tpu.ops.pallas.polyblur_fused as jfused
import polyblur_tpu.ops.pallas.sep_poly_fused as jsep
import polyblur_tpu.ops.spectral_matmul as jsm
import polyblur_tpu.patches as jpatches
import polyblur_tpu.pipeline as jpipe
import polyblur_tpu.utils.imaging as jimg

import polyblur_torch.ops.spectral_matmul as tsm
import polyblur_torch.ops.tables as ttab
import polyblur_torch.patches as tpatches
import polyblur_torch.pipeline as tpipe
import polyblur_torch.utils.imaging as timg
from polyblur_torch.convert import params_from_jax


def _same(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [48, 160, 184, 200, 448])
def test_derivative_matrix_bit_equal(n):
    _same(tsm._derivative_matrix_np(n), jsm._derivative_matrix_np(n))


@pytest.mark.parametrize("size", [184, 472])
def test_dft_and_tap_tables_bit_equal(size):
    for t, j in zip(ttab._dft_mats_np(size), jsep._dft_mats_np(size)):
        _same(t, j)
    for t, j in zip(ttab._ydft_mats_np(size), jsep._ydft_mats_np(size)):
        _same(t, j)
    assert ttab._packed_k(size) == jsep._packed_k(size)
    for t, j in zip(ttab._dft_operands_packed(size),
                    jsep._dft_operands_packed(size, np.float32)):
        _same(t, j)
    for t, j in zip(ttab._tap_tables_np(size, size, 12),
                    jsep._tap_tables_np(size, size, 12)):
        _same(t, j)


def test_interp_weights_bit_equal():
    _same(ttab._interp_weights_np(), jfused._interp_weights_np())


@pytest.mark.parametrize("window", ["kaiser", "hann", "hamming", "bartlett"])
@pytest.mark.parametrize("size", [(448, 448), (160, 200)])
def test_build_window_bit_equal(window, size):
    _same(timg.build_window_np(size, window), jimg.build_window_np(size, window))


def test_params_from_jax_bit_equal():
    args = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    want = tpipe._mega_pack(*args).numpy()
    _same(params_from_jax(np.asarray(jpipe._mega_pack(*args))), want)
    fields = dict(zip(("c", "b", "alpha", "beta", "sigma_s", "sigma_r"),
                      args))
    _same(params_from_jax(fields), want)
    with pytest.raises(ValueError):
        params_from_jax(np.zeros(7))


@pytest.mark.parametrize("h, w, patch, overlap", [
    (3000, 4000, 448, 64.0 / 448.0),     # the 12 MP main path
    (500, 520, 400, 0.25),               # truncating 400/0.25 grid (step 300)
    (200, 300, 160, 32.0 / 160.0),
    (1024, 1024, 448, 64.0 / 448.0),
    (90, 120, 48, 0.25),
    (333, 517, 160, 0.2),                # odd sizes: even-crop
    (301, 299, 100, 0.3),                # int(100 * 0.7) == 69: truncation
    (300, 500, (320, 448), (64.0 / 320.0, 64.0 / 448.0)),
])
def test_plan_patch_grid_matches_jax(h, w, patch, overlap):
    t = tpatches.plan_patch_grid(h, w, patch, overlap)
    j = jpatches.plan_patch_grid(h, w, patch, overlap)
    assert tuple(t) == tuple(j)
    assert tpatches._grid_steps(t) == jpatches._grid_steps(j)
