"""The blocked IIR column scan and the taper folded into the spectral
polynomial, on CPU.

* The column kernel (``csrc/iir.cu`` ``iir_cols_kernel``) composes the
  recurrence in chunks of 32 rows: a 5-step shift-and-compose scan inside
  a chunk, a carry across chunks, forward then backward, every product and
  sum rounded once. :func:`_chunked_scan` runs that order in torch; it is
  held to the JAX package's ``iir_scan_rows`` (associative scan) on the
  swapaxes'd input and to ``iir_scan_rows_pallas(interpret=True)`` at
  atol 1e-5 (the recurrence contracts, v < 1, so the orders agree to a few
  f32 ulps), with v up to 0.999, the slowest contraction.
* ``spectral_poly(..., taper=(av, ah))`` on CPU runs ``spectral_poly_plain``
  and then ``taper_blend_plain``: exactly the two-step sequence the tiles
  route ran before the blend moved into the last product's epilogue.

The staged patch route with every flag is held to the mega kernel in
interpret mode by tests/test_torch_features.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from polyblur_tpu.ops.domain_transform import iir_scan_rows as jax_scan
from polyblur_tpu.ops.pallas.iir import iir_scan_rows_pallas

from polyblur_torch.ops.cuda.features import taper_weights
from polyblur_torch.ops.cuda.iir import _affine_scan, scan_cols
from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast
from polyblur_torch.ops.cuda.polyblur_fused import (
    HALF, TileView, kernel_spectrum, spectral_poly, stage_tables,
    taper_blend_plain)
from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs
from polyblur_torch.patches import _grid_steps, plan_patch_grid
from polyblur_torch.pipeline import _unit_horner

CHUNK = 32


def _chunked_pass(a, b, reverse):
    """Apply the affine maps (a, b) along the last axis to a zero start,
    in the column kernel's order: chunks of 32 aligned to index 0, each
    composed by the 5-step scan (identity past the end), then applied to
    the carry of the previous chunk (the next one, reversed)."""
    n = a.shape[-1]
    nch = -(-n // CHUNK)
    pad = nch * CHUNK - n
    a = torch.cat([a, torch.ones_like(a[..., :1]).expand(
        *a.shape[:-1], pad)], -1).reshape(*a.shape[:-1], nch, CHUNK)
    b = torch.cat([b, torch.zeros_like(b[..., :1]).expand(
        *b.shape[:-1], pad)], -1).reshape(*b.shape[:-1], nch, CHUNK)
    a, b = _affine_scan(a, b, reverse)
    out = torch.empty_like(b)
    carry = torch.zeros_like(b[..., 0, :1])
    order = range(nch - 1, -1, -1) if reverse else range(nch)
    for k in order:
        out[..., k, :] = a[..., k, :] * carry + b[..., k, :]
        carry = out[..., k, :1] if reverse else out[..., k, CHUNK - 1:]
    return out.reshape(*out.shape[:-2], nch * CHUNK)[..., :n]


def _chunked_scan(x, v):
    """The bidirectional IIR along the last axis in the column kernel's
    composition order (iir.py:76-90's recurrence)."""
    col = torch.arange(x.shape[-1])
    vf = torch.where(col == 0, torch.zeros_like(v), v)
    y = _chunked_pass(vf, (1.0 - vf) * x, reverse=False)
    vs = torch.cat([v[..., 1:], torch.zeros_like(v[..., :1])], -1)
    return _chunked_pass(vs, (1.0 - vs) * y, reverse=True)


@pytest.mark.parametrize("h", [448, 1200, 333])
def test_chunked_column_scan_matches_jax_and_pallas(h):
    rng = np.random.default_rng(70 + h)
    x = rng.uniform(size=(1, 2, h, 24)).astype(np.float32)
    v = rng.uniform(0.0, 0.999, size=(1, h, 24)).astype(np.float32)
    v[0, :5] = 0.999   # the slowest contraction at the top of the columns
    vb = np.broadcast_to(v[:, None], x.shape).copy()
    # down the columns = along the last axis of the transposed planes
    got = _chunked_scan(torch.as_tensor(x).transpose(-1, -2),
                        torch.as_tensor(vb).transpose(-1, -2))
    got = got.transpose(-1, -2).numpy()
    xt, vt = (jnp.swapaxes(jnp.asarray(a), -1, -2) for a in (x, vb))
    want = np.swapaxes(np.asarray(jax_scan(xt, vt)), -1, -2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pallas = np.swapaxes(np.asarray(iir_scan_rows_pallas(
        xt, vt, interpret=True)), -1, -2)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    # the port's plain column pass (a full Hillis-Steele scan) agrees too
    plain = scan_cols(torch.as_tensor(x).clone(), torch.as_tensor(v))
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)


def test_chunked_scan_of_one_chunk_is_the_plain_scan():
    """Within one chunk the emulation is the plain version's own scan:
    bit-equal at W <= 32."""
    from polyblur_torch.ops.cuda.iir import iir_scan_rows_plain

    rng = np.random.default_rng(71)
    x = torch.as_tensor(rng.uniform(size=(3, 32)).astype(np.float32))
    v = torch.as_tensor(rng.uniform(0.0, 0.999, (3, 32)).astype(np.float32))
    assert torch.equal(_chunked_scan(x, v), iir_scan_rows_plain(x, v))


# ------------------------------------------------------------------- taper

def _taper_inputs(wd, n_tiles_seed=72, patch=48):
    """A bf16 or f32 tile canvas of a (1, 3) image, its TileView, the
    degree-1 spectrum of random blurs and their taper weights."""
    rng = np.random.default_rng(n_tiles_seed)
    img = torch.as_tensor(rng.uniform(size=(1, 3, 90, 120)).astype(
        np.float32))
    grid = plan_patch_grid(90, 120, patch, 0.25)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, wd)
    view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (patch, patch))
    n = view.n
    sigma = torch.as_tensor(rng.uniform(0.4, 3.0, n).astype(np.float32))
    rho = torch.as_tensor(rng.uniform(0.4, 3.0, n).astype(np.float32))
    theta = torch.as_tensor(rng.uniform(0.0, math.pi, n).astype(np.float32))
    est = torch.zeros((n, 8))
    est[:, 5:8] = torch.stack(gaussian_quadratic_coeffs(sigma, rho, theta), 1)
    tabs = stage_tables(patch, patch, wd, "cpu")
    h, wc = tabs.h, tabs.wc
    av, ah = taper_weights(est, h, wc)
    khat2 = kernel_spectrum(est, _unit_horner("cpu"), tabs)
    return view, tabs, khat2, av, ah


def _blend_sequence(u, pad, khat2, tabs, av, ah, xc):
    """The two-step taper blend: the unclipped f32 application, then the
    plain blend."""
    ku = spectral_poly(u, khat2, tabs, pad=pad, crop=0, clip=False,
                       out_dtype=torch.float32)
    return taper_blend_plain(u, pad, av, ah, ku, xc)


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("source", ["canvas", "f32_planes"])
def test_spectral_poly_taper_cpu_route_is_the_blend_sequence(wd, source):
    view, tabs, khat2, av, ah = _taper_inputs(wd)
    if source == "f32_planes":   # the prefilter's smooth part
        view = TileView.of_tiles(view.tiles().float() * 0.75 + 0.1)
    n, c = view.n, view.channels
    shape = (n, c, tabs.h, tabs.wc)
    want = _blend_sequence(view, HALF, khat2, tabs, av, ah,
                           torch.empty(shape))
    xc = torch.empty(shape)
    got = spectral_poly(view, khat2, tabs, xc, pad=HALF, crop=0, clip=False,
                        out_dtype=torch.float32, taper=(av, ah))
    assert got is xc
    assert torch.equal(got, want)
    # the next two blends run on the canvas itself, in place
    for _ in range(2):
        _blend_sequence(TileView.of_tiles(want), 0, khat2, tabs, av, ah, want)
        spectral_poly(TileView.of_tiles(xc), khat2, tabs, xc, pad=0, crop=0,
                      clip=False, out_dtype=torch.float32, taper=(av, ah))
        assert torch.equal(xc, want)


def test_spectral_poly_taper_refuses_what_it_cannot_blend():
    view, tabs, khat2, av, ah = _taper_inputs(torch.bfloat16)
    base = dict(pad=HALF, crop=0, clip=False, out_dtype=torch.float32,
                taper=(av, ah))
    for bad in (dict(crop=HALF), dict(clip=True), dict(out_dtype=None),
                dict(taper=(av[:, 1:], ah))):
        with pytest.raises(ValueError):
            spectral_poly(view, khat2, tabs, **dict(base, **bad))
