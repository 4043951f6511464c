"""polyblur_torch per-kernel checks.

CPU: each kernel's plain PyTorch version against the JAX package's own
counterpart, run as the JAX tests run it (Pallas in interpret mode, or the
XLA reference the Pallas kernel is held to):

* edge_pad_cast     vs ``pad_cast.edge_pad_cast(interpret=True)``, bit-equal;
* kernel_spectrum   vs ``sep_poly.kernel_spectrum`` + Horner, atol 1e-5;
* spectral_poly     vs ``sep_poly._spectral2d`` (rfft2) in f32, atol 1e-5;
* tile_estimate     vs ``gaussian_blur_estimation``: same theta index,
                    sigma and rho within 1e-5 relative;
* blend_overlap_add vs ``patches.overlap_add``, atol 1e-6 (its backward
                    kernel on the card against autograd of the plain blend,
                    bit for bit);
* fused_polynomial  vs ``sep_poly_fused.fused_polynomial_pallas(interpret=
                    True)`` with and without the replicate pad and the clip,
                    and inside ``_blocked_polynomial`` vs the JAX blocked
                    route and ``_spectral2d``, atol 1e-5;
* directional_maxima vs ``est_fused.directional_maxima_pallas(interpret=
                    True)`` for C = 1 and C = 3, atol 1e-5.

CUDA (``test_cuda_*``, skipped without a card): each kernel against its
plain version on the card; each autograd Function (ROADMAP B.1 items 1-8
and the blend) against autograd of its plain version (the flagged tiles
and canvas Functions against autograd of the scan route they replay),
the flagged routes' finite gradients, the refusal of a graph through a
bare kernel wrapper, and the launches of grad-free calls. They import no JAX, so on a machine without it
they run with ``python -m pytest --noconftest tests/test_torch_kernels.py
-k cuda``.
"""

import math
import os

import numpy as np
import pytest
import torch

from polyblur_torch.convert import params_from_jax
from polyblur_torch.ops import cuda as pcuda
from polyblur_torch.ops.cuda.est_fused import (directional_maxima,
                                               directional_maxima_plain)
from polyblur_torch.ops.cuda.overlap_add import (blend_overlap_add,
                                                 blend_overlap_add_plain)
from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast, edge_pad_cast_plain
from polyblur_torch.ops.cuda.polyblur_fused import (
    TileView, kernel_spectrum, kernel_spectrum_plain, polyblur_tiles_fused,
    spectral_poly, spectral_poly_plain, stage_tables, tile_estimate,
    tile_estimate_plain)
from polyblur_torch.ops.cuda.sep_poly_fused import (fused_polynomial,
                                                    fused_polynomial_plain)
from polyblur_torch.patches import (PatchGrid, _blend_constants, _grid_steps,
                                    extract_patches, overlap_add,
                                    plan_patch_grid)
from polyblur_torch.pipeline import _mega_pack

DATA = os.path.join(os.path.dirname(__file__), "data")
HALF = 12
COEFFS = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)  # c, b, alpha, beta, s_s, s_r
PAD_CASES = [
    ((1, 3, 64, 200), (4, 12, 8, 24)),       # ragged W
    ((2, 1, 16, 256), (0, 8, 0, 0)),         # zero pads
    ((1, 1, 512, 384), (68, 196, 80, 208)),  # tall, wide pads
    ((1, 2, 24, 130), (5, 0, 3, 1)),         # tiny ragged
    ((1, 1, 32, 128), (0, 0, 0, 0)),         # no-op pad
]


def _quad_forms(rng, n):
    """(n,) f32 quadratic forms (a, b, c) of random anisotropic blurs."""
    from polyblur_tpu.ops.sep_poly import gaussian_quadratic_coeffs
    import jax.numpy as jnp

    sigma = rng.uniform(0.3, 4.0, n).astype(np.float32)
    rho = rng.uniform(0.3, 4.0, n).astype(np.float32)
    theta = rng.uniform(0.0, math.pi, n).astype(np.float32)
    return [np.asarray(v, np.float32) for v in gaussian_quadratic_coeffs(
        jnp.asarray(sigma), jnp.asarray(rho), jnp.asarray(theta))]


def _est_rows(a, b, c):
    """tile_estimate-shaped rows carrying only the quadratic forms."""
    est = torch.zeros((len(a), 8))
    est[:, 5], est[:, 6], est[:, 7] = (torch.tensor(v) for v in (a, b, c))
    return est


def _photo_tiles(peacock):
    """(6, 3, 96, 128) f32 crops of real photos (peacock and two corpus
    images): a clear blur direction, unlike noise, so theta is well posed."""
    from PIL import Image

    crops = [peacock[y:y + 96, x:x + 128]
             for (y, x) in ((0, 0), (100, 200), (300, 400), (380, 560))]
    for name, (y, x) in (("deadleaves_coarse.png", (200, 300)),
                         ("mosaic_fine.png", (400, 500))):
        img = np.asarray(Image.open(os.path.join(DATA, "corpus_hr", name)))
        img = (img[..., :3] / 255.0).astype(np.float32)
        crops.append(img[y:y + 96, x:x + 128])
    return np.stack(crops).transpose(0, 3, 1, 2).copy()


# ---------------------------------------------------------------- CPU / JAX

@pytest.mark.parametrize("shape, pads", PAD_CASES)
def test_edge_pad_cast_plain_matches_pallas(shape, pads):
    import jax.numpy as jnp
    from polyblur_tpu.ops.pallas.pad_cast import edge_pad_cast as jpad

    x = np.random.default_rng(40).uniform(size=shape).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(jpad(jnp.asarray(x), pads, jdt, True), np.float32)
        got = edge_pad_cast(torch.as_tensor(x), shape[-2:], pads, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_edge_pad_cast_even_crop():
    x = torch.rand(1, 2, 33, 41)
    got = edge_pad_cast(x, (32, 40), (1, 2, 3, 4), torch.bfloat16)
    want = edge_pad_cast(x[..., :32, :40].contiguous(), (32, 40),
                         (1, 2, 3, 4), torch.bfloat16)
    assert torch.equal(got, want) and got.shape == (1, 2, 35, 47)


def test_kernel_spectrum_plain_matches_jax():
    import jax.numpy as jnp
    from polyblur_tpu.ops import sep_poly as jsp

    from polyblur_torch.ops import sep_poly as tsp

    a, b, c = _quad_forms(np.random.default_rng(1), 5)
    ph, pw = 40, 56
    h, wc = ph + 2 * HALF, pw + 2 * HALF
    coeffs = _mega_pack(*COEFFS)
    horner = tuple(float(v) for v in coeffs[:4])
    tabs = stage_tables(ph, pw, torch.float32, "cpu")
    q2 = kernel_spectrum(_est_rows(a, b, c), coeffs, tabs)
    K, kp = wc // 2 + 1, tabs.er.shape[1]
    assert q2.shape == (5, h, 2 * kp)
    khat = jsp.kernel_spectrum(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                               h, wc, HALF)
    want = np.asarray(jsp._horner_spectrum(khat, horner))
    np.testing.assert_allclose((q2[..., :K] * h).numpy(), want, atol=1e-5,
                               rtol=0)
    # the packed layout: [q | q], pad columns hold p(0) = beta
    assert torch.equal(q2[..., :kp], q2[..., kp:])
    np.testing.assert_allclose((q2[..., K:kp] * h).numpy(), horner[3],
                               atol=1e-6)
    # the port's whole-image spectrum helpers agree too
    ta, tb, tc = tsp.gaussian_quadratic_coeffs(
        torch.tensor(1.5), torch.tensor(0.7), torch.tensor(0.4))
    ja, jb, jc = jsp.gaussian_quadratic_coeffs(1.5, 0.7, 0.4)
    np.testing.assert_allclose([ta, tb, tc], [ja, jb, jc], rtol=1e-6)
    np.testing.assert_allclose(
        tsp.kernel_spectrum(*(torch.tensor(v) for v in (a, b, c)), h, wc,
                            HALF).numpy(), np.asarray(khat), atol=1e-5,
        rtol=0)


def test_spectral_poly_plain_matches_jax_spectral2d():
    import jax.numpy as jnp
    from polyblur_tpu.ops.sep_poly import _spectral2d

    rng = np.random.default_rng(2)
    n, c, ph, pw = 2, 3, 40, 56
    x = rng.uniform(size=(n, c, ph, pw)).astype(np.float32)
    a, b, cq = _quad_forms(rng, n)
    coeffs = _mega_pack(*COEFFS)
    tabs = stage_tables(ph, pw, torch.float32, "cpu")
    q2 = kernel_spectrum(_est_rows(a, b, cq), coeffs, tabs)
    got = spectral_poly(TileView.of_tiles(torch.as_tensor(x)), q2, tabs)
    xp = jnp.pad(jnp.asarray(x.reshape(n * c, ph, pw)),
                 ((0, 0), (HALF, HALF), (HALF, HALF)), mode="edge")
    rep = [jnp.asarray(np.repeat(v, c)) for v in (a, b, cq)]
    out = _spectral2d(xp, *rep, tuple(float(v) for v in coeffs[:4]), HALF)
    want = np.clip(np.asarray(out)[:, HALF:-HALF, HALF:-HALF], 0.0, 1.0)
    np.testing.assert_allclose(got.reshape(n * c, ph, pw).numpy(), want,
                               atol=1e-5, rtol=0)


def _spectral_poly_old_formulation(x, q2, h, wc, pad, crop):
    """The spectral application in the half-swap / sign formulation:
    R = pad(x) F with F = [Cf | -Sf], the y-DFT as one K = 2h product of
    [Cy | Sy] with [R ; swap(R) sgn], the inverse the same with -sgn, then
    crop(Yi G) clipped; all f32."""
    from polyblur_torch.ops.tables import (_dft_operands_packed, _packed_k,
                                           _ydft_mats_np)

    n, c, ph, pw = x.shape
    kp = _packed_k(wc)
    fwd, inv = (torch.tensor(a) for a in _dft_operands_packed(wc))
    cysy = torch.tensor(np.concatenate(_ydft_mats_np(h), axis=1))

    def swap(u):
        return torch.cat([u[..., kp:], u[..., :kp]], -1)

    sgn = torch.ones(2 * kp)
    sgn[kp:] = -1.0
    xc = torch.nn.functional.pad(x.reshape(n * c, 1, ph, pw), (pad,) * 4,
                                 mode="replicate")[:, 0]
    r = xc @ fwd
    yf = cysy @ torch.cat([r, swap(r) * sgn], 1)
    pq = (yf.reshape(n, c, h, 2 * kp) * q2[:, None]).reshape(yf.shape)
    yi = cysy @ torch.cat([pq, swap(pq) * -sgn], 1)
    oh, ow = h - 2 * crop, wc - 2 * crop
    o = yi[:, crop:crop + oh] @ inv[:, crop:crop + ow]
    return o.clamp(0.0, 1.0).reshape(n, c, oh, ow)


@pytest.mark.parametrize("pad, crop", [(12, 12), (0, 0), (12, 0), (0, 12)])
def test_stacked_tables_match_old_formulation(pad, crop):
    """The stacked y-DFT tables ([[Cy, Sy], [-Sy, Cy]] and its inverse on
    [Re ; Im]) and the K-major transposed x-DFT tables reproduce the
    half-swap / sign formulation in f32, on a 40 x 56 tile at every
    pad / crop pair the callers use (the taper pads onto the canvas and
    crops back)."""
    from polyblur_torch.ops.cuda.polyblur_fused import pad64

    rng = np.random.default_rng(12)
    ph, pw = 40, 56
    if pad == 0:
        ph, pw = ph + 24, pw + 24  # the same canvas, the tile is the canvas
    h, wc = ph + 2 * pad, pw + 2 * pad
    x = torch.as_tensor(rng.uniform(size=(2, 3, ph, pw)).astype(np.float32))
    a, b, cq = _quad_forms(rng, 2)
    tabs = stage_tables(ph, pw, torch.float32, "cpu", pad)
    q2 = kernel_spectrum(_est_rows(a, b, cq), _mega_pack(*COEFFS), tabs)
    got = spectral_poly(TileView.of_tiles(x), q2, tabs, crop=crop)
    want = _spectral_poly_old_formulation(x, q2, h, wc, pad, crop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # the kernel operands: K-major, K zero-padded to 64, and each entry one
    # of the old tables' entries (so bf16 rounds them alike)
    kp = tabs.er.shape[1]
    assert tabs.fwd_t.shape == (2 * kp, pad64(wc))
    assert tabs.inv_t.shape == (wc, 2 * kp)
    assert tabs.ydft.shape == tabs.ydft_inv.shape == (2 * h, pad64(2 * h))
    assert (tabs.h, tabs.wc) == (h, wc)
    for t, k in ((tabs.fwd_t, wc), (tabs.ydft, 2 * h), (tabs.ydft_inv, 2 * h)):
        assert not bool(t[:, k:].any())
    b16 = stage_tables(ph, pw, torch.bfloat16, "cpu", pad)
    from polyblur_torch.ops.tables import _ydft_mats_np

    cy, sy = (torch.tensor(m).to(torch.bfloat16) for m in _ydft_mats_np(h))
    assert torch.equal(b16.ydft[:h, :h], cy) and torch.equal(
        b16.ydft[:h, h:2 * h], sy)
    assert torch.equal(b16.ydft[h:, :h], -sy) and torch.equal(
        b16.ydft_inv[:h, h:2 * h], -sy)
    assert torch.equal(b16.ydft_inv.T[:2 * h], b16.ydft[:, :2 * h])


def test_tile_estimate_plain_matches_jax(peacock):
    import jax.numpy as jnp
    from polyblur_tpu.estimation import gaussian_blur_estimation as jest

    from polyblur_torch.estimation import gaussian_blur_estimation as port_est

    x = _photo_tiles(peacock)
    c, b = COEFFS[0], COEFFS[1]
    est = tile_estimate(TileView.of_tiles(torch.as_tensor(x)),
                        _mega_pack(*COEFFS))
    sigma, rho, theta = (np.asarray(v)[:, 0] for v in jest(
        jnp.asarray(x), c=c, b=b, return_2d_filters=False))
    idx = np.rint(theta / (6.0 * math.pi / 180.0)).astype(int)
    np.testing.assert_array_equal(est[:, 0].numpy().astype(int), idx)
    np.testing.assert_allclose(est[:, 3].sqrt().numpy(), sigma, rtol=1e-5)
    np.testing.assert_allclose(est[:, 4].sqrt().numpy(), rho, rtol=1e-5)
    # the port's whole-image estimator (same chain, batched) agrees too
    ts, tr, tt = (v[:, 0].numpy() for v in port_est(
        torch.as_tensor(x), c=c, b=b, return_2d_filters=False))
    np.testing.assert_allclose(ts, sigma, rtol=1e-5)
    np.testing.assert_allclose(tr, rho, rtol=1e-5)
    np.testing.assert_allclose(tt, theta, rtol=1e-6)


@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16])
def test_blend_plain_matches_jax_overlap_add(tile_dtype):
    import jax.numpy as jnp
    from polyblur_tpu.patches import overlap_add as joa
    from polyblur_tpu.patches import plan_patch_grid as jplan

    rng = np.random.default_rng(3)
    bsz = 2
    g = plan_patch_grid(200, 300, 160, 32.0 / 160.0)
    tiles = torch.as_tensor(rng.uniform(
        size=(len(g.coords) * bsz, 3, 160, 160)).astype(np.float32))
    tiles = tiles.to(tile_dtype)
    got = overlap_add(tiles, g, bsz, out_dtype=torch.float32)
    jt = jnp.asarray(tiles.float().numpy()).astype(
        jnp.bfloat16 if tile_dtype == torch.bfloat16 else jnp.float32)
    want = np.asarray(joa(jt, jplan(200, 300, 160, 32.0 / 160.0), bsz,
                          out_dtype=jnp.float32))
    assert got.shape == want.shape == (bsz, 3, 200, 300)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _jax_poly_inputs(rng, n):
    """(params (n, 3), coeffs (4,)) as the JAX package feeds its fused
    polynomial (test_kernels.py:183-198)."""
    import jax.numpy as jnp
    from polyblur_tpu.ops.sep_poly import gaussian_quadratic_coeffs

    sg = rng.uniform(0.5, 3.0, n).astype(np.float32)
    rh = rng.uniform(0.4, 1.5, n).astype(np.float32)
    th = rng.uniform(0.0, math.pi, n).astype(np.float32)
    a, b, c = gaussian_quadratic_coeffs(jnp.asarray(sg), jnp.asarray(rh),
                                        jnp.asarray(th))
    return jnp.stack([a, b, c], -1), jnp.asarray([4.0, -5.0, 2.0, 1.0],
                                                 jnp.float32)


@pytest.mark.parametrize("replicate_pad", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_fused_polynomial_plain_matches_pallas(replicate_pad, clip):
    import jax.numpy as jnp
    from polyblur_tpu.ops.pallas.sep_poly_fused import fused_polynomial_pallas

    rng = np.random.default_rng(11)
    x = rng.uniform(size=(3, 48, 72)).astype(np.float32)
    params, coeffs = _jax_poly_inputs(rng, 3)
    want = np.asarray(fused_polynomial_pallas(
        jnp.asarray(x), params, coeffs, replicate_pad, clip, True))
    tp, tc = params_from_jax((np.asarray(params), np.asarray(coeffs)))
    got = fused_polynomial(torch.as_tensor(x), tp, tc, replicate_pad, clip)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if clip:
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_blocked_polynomial_matches_jax_blocked_and_spectral2d():
    """The overlap-save block grid (blocks cut from the wrap-extended
    canvas by a TileView) against the JAX package's blocked route and the
    whole-canvas rfft2 composition (test_kernels.py:626-648)."""
    import jax.numpy as jnp
    from polyblur_tpu.ops import sep_poly as jsp
    from scipy import ndimage

    from polyblur_torch.ops import sep_poly as tsp

    rng = np.random.default_rng(30)
    base = ndimage.gaussian_filter(rng.uniform(size=(300, 260)), 1.0)
    x = np.stack([base, base[::-1]]).astype(np.float32)
    sg, rh, th = (np.asarray(v, np.float32) for v in ([2.0, 1.2], [0.8, 1.0],
                                                        [0.5, 2.0]))
    a, b, c = (np.asarray(v, np.float32)
               for v in jsp.gaussian_quadratic_coeffs(
                   jnp.asarray(sg), jnp.asarray(rh), jnp.asarray(th)))
    horner = (6.0 / 2 - 1.0 + 2, 3 * 1.0 - 6.0 - 6, 5 - 3 * 1.0 + 6.0 / 2, 1.0)
    want = np.asarray(jsp._blocked_polynomial(
        jnp.asarray(x), *(jnp.asarray(v) for v in (a, b, c)), horner, 12,
        block=160, interpret=True))
    ta, tb, tc = (torch.tensor(v) for v in (a, b, c))
    got = tsp._blocked_polynomial(torch.as_tensor(x), ta, tb, tc, horner, 12,
                                  block=160)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ref = tsp._spectral2d(torch.as_tensor(x), ta, tb, tc, horner, 12)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("channels", [1, 3])
def test_directional_maxima_plain_matches_pallas(peacock, channels):
    import jax.numpy as jnp
    from polyblur_tpu.ops.pallas.est_fused import directional_maxima_pallas

    x = peacock[:128, :160].transpose(2, 0, 1)[None]
    x = np.concatenate([x, peacock[200:328, 300:460].transpose(2, 0, 1)[None]])
    if channels == 1:
        x = x.mean(axis=1, keepdims=True)
    x = np.ascontiguousarray(x, np.float32)
    want = np.asarray(directional_maxima_pallas(jnp.asarray(x), n_angles=6,
                                                interpret=True))
    got = directional_maxima(torch.as_tensor(x))
    assert got.shape == (2, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts(before, name):
    return pcuda.launches[name] - before.get(name, 0)


@pytest.mark.parametrize("shape, pads", PAD_CASES)
def test_cuda_edge_pad_cast_matches_plain(cuda_dev, shape, pads):
    x = torch.rand(shape, device=cuda_dev)
    for dt in (torch.float32, torch.bfloat16):
        before = dict(pcuda.launches)
        got = edge_pad_cast(x, shape[-2:], pads, dt)
        assert _counts(before, "edge_pad_cast") == 1
        want = edge_pad_cast_plain(x, shape[-2:], pads, dt)
        assert torch.equal(got, want)
    # the public tile cutter pads through the kernel too (one canvas tile)
    hp, wp = shape[-2] + pads[0] + pads[1], shape[-1] + pads[2] + pads[3]
    grid = PatchGrid(tuple(shape[-2:]), (hp, wp), (hp, wp), ((0, 0),), pads)
    before = dict(pcuda.launches)
    tiles = extract_patches(x, grid)
    assert _counts(before, "edge_pad_cast") == 1
    assert torch.equal(tiles, edge_pad_cast_plain(x, shape[-2:], pads))


def _photo(dev, h, w, y=0, x=0, seed=None):
    """(1, 3, h, w) f32 crop of the 2 MP corpus photo at (y, x), tiled to
    any size (a clear blur direction per tile, unlike noise), with
    N(0, 0.005) noise when ``seed`` is given (as bench.py's image)."""
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(
        DATA, "corpus_hr", "peacock_tiled.png")))[..., :3] / 255.0
    reps = ((y + h) // img.shape[0] + 1, (x + w) // img.shape[1] + 1, 1)
    img = np.tile(img, reps)[y:y + h, x:x + w].astype(np.float32)
    if seed is not None:
        img = np.clip(img + np.random.default_rng(seed).normal(
            0.0, 0.005, img.shape), 0.0, 1.0).astype(np.float32)
    return torch.as_tensor(img.transpose(2, 0, 1)[None].copy()).to(dev)


@pytest.mark.parametrize("dt, tol", [(torch.bfloat16, 2.0 ** -7),
                                     (torch.float32, 1e-4)])
def test_cuda_tile_stages_match_plain(cuda_dev, dt, tol):
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, 3, 300, 420), generator=g).to(cuda_dev)
    grid = plan_patch_grid(300, 420, 160, 32.0 / 160.0)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, dt)
    view = TileView(canvas, 2, 1, 2 * (th * tw - 1), tw, (sh, sw), (160, 160))
    _check_estimate(view, cuda_dev)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    before = dict(pcuda.launches)
    est = tile_estimate(view, coeffs)
    tabs = stage_tables(160, 160, dt, str(cuda_dev))
    q2 = kernel_spectrum(est, coeffs, tabs)
    q2_p = kernel_spectrum_plain(est, coeffs, tabs)
    assert float((q2 - q2_p).abs().max()) <= 1e-5 * float(q2_p.abs().max())
    out = spectral_poly(view, q2, tabs)
    assert _counts(before, "spectral_gemm") == 4
    out_p = spectral_poly_plain(view, q2, tabs)
    assert float((out.float() - out_p.float()).abs().max()) <= tol


def _check_estimate(view, dev):
    """tile_estimate of ``view``: 4 launches, theta index identical to the
    plain version's, the other values within 1e-4 relative."""
    coeffs = _mega_pack(*COEFFS, device=dev)
    before = dict(pcuda.launches)
    est = tile_estimate(view, coeffs)
    assert _counts(before, "tile_estimate") == 4
    est_p = tile_estimate_plain(view, coeffs)
    assert torch.equal(est[:, 0], est_p[:, 0])
    torch.testing.assert_close(est[:, 1:], est_p[:, 1:], rtol=1e-4, atol=0)


@pytest.mark.parametrize("case", ["12mp_448", "481x637", "480x512",
                                  "160_tiles", "n1_c1", "n1_c3"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_cuda_estimate_shapes_match_plain(cuda_dev, case, dt):
    """The estimate at the shapes the routes pass: the 12 MP main path's
    88 tiles of 448 px on their canvas (16-byte vector operand loads), the
    tiles route's 481 x 637 (rows no multiple of 16 bytes: scalar loads)
    and 480 x 512, the small-input phase's 160 px tiles, and one image
    with C = 1 and C = 3."""
    if case == "12mp_448":
        img = _photo(cuda_dev, 3000, 4000, seed=0)
        grid = plan_patch_grid(3000, 4000, 448, 64.0 / 448.0)
        th, tw, sh, sw = _grid_steps(grid)
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, dt)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (448, 448))
        assert view.n == 88
    elif case == "160_tiles":
        img = _photo(cuda_dev, 200, 300, 400, 500)
        grid = plan_patch_grid(200, 300, 160, 32.0 / 160.0)
        th, tw, sh, sw = _grid_steps(grid)
        canvas = edge_pad_cast(img, grid.orig_size, grid.pad, dt)
        view = TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (160, 160))
    else:
        h, w = {"481x637": (481, 637), "480x512": (480, 512),
                "n1_c1": (480, 640), "n1_c3": (480, 640)}[case]
        x = _photo(cuda_dev, h, w, 100, 200)
        if case == "n1_c1":
            x = x.mean(1, keepdim=True)
        view = TileView.of_tiles(x.to(dt).contiguous())
    _check_estimate(view, cuda_dev)


def test_cuda_blend_matches_plain(cuda_dev):
    g = plan_patch_grid(300, 420, 160, 32.0 / 160.0)
    th, tw, sh, sw = _grid_steps(g)
    tiles = torch.rand((th * tw * 2, 3, 160, 160), device=cuda_dev)
    win, inv = _blend_constants(g, "kaiser", cuda_dev)
    args = (win, inv, (th, tw, sh, sw, 160, 160), 2,
            (g.pad[0], g.pad[2]) + g.orig_size)
    for tdt, odt in ((torch.bfloat16, torch.float32),
                     (torch.float32, torch.bfloat16)):
        t = tiles.to(tdt)
        got = blend_overlap_add(t, *args, out_dtype=odt)
        want = blend_overlap_add_plain(t, *args, out_dtype=odt)
        assert got.dtype == odt
        assert float((got.float() - want.float()).abs().max()) <= 1e-6


# (image size, tile, overlap, batch, tile dtype, output dtype) of the blend's
# backward kernel: the training cell's 130 tiles of 400 px at step 300 and
# the flags cell's 2 MP grid, the 448 / 384 grid with a left crop of 144 and
# of 1 (the output gradient read a column at a time), all on the 4-column
# path, and 150 px tiles at step 105 (one column a thread)
BLEND_BACKWARD_CASES = {
    "train12mp": ((3000, 4000), 400, 0.25, 1, torch.bfloat16, torch.float32),
    "flags2mp": ((1200, 1600), 400, 0.25, 2, torch.bfloat16, torch.float32),
    "g448": ((3000, 4000), 448, 64.0 / 448.0, 1, torch.float32,
             torch.bfloat16),
    "g448_crop1": ((1198, 1598), 448, 64.0 / 448.0, 1, torch.bfloat16,
                   torch.bfloat16),
    "step105": ((300, 420), 150, 0.3, 2, torch.float32, torch.float32),
}


@pytest.mark.parametrize("case", list(BLEND_BACKWARD_CASES))
def test_cuda_blend_backward_is_autograd_of_plain(cuda_dev, case):
    """The blend's backward kernel against autograd of the plain blend,
    bit for bit, with pre-clip values below 0 and above 1: one backward
    launches one ``blend_overlap_add`` backward kernel and no forward
    kernel."""
    hw, p, overlap, b, tdt, odt = BLEND_BACKWARD_CASES[case]
    grid = plan_patch_grid(*hw, p, overlap)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, p, p)
    crop = (grid.pad[0], grid.pad[2]) + grid.orig_size
    win, inv = _blend_constants(grid, "kaiser", cuda_dev)
    gen = torch.Generator(cuda_dev).manual_seed(26)
    tiles = (torch.rand((th * tw * b, 3, p, p), generator=gen,
                        device=cuda_dev) * 1.5 - 0.25).to(tdt)
    g = torch.randn((b, 3) + grid.orig_size, generator=gen,
                    device=cuda_dev).to(odt)
    x = tiles.clone().requires_grad_()
    out = blend_overlap_add(x, win, inv, gi, b, crop, odt)
    assert out.grad_fn.name() == "_ReplayBackward"
    before = dict(pcuda.launches)
    kernels = pcuda.backward_launches["blend_overlap_add"]
    got = torch.autograd.grad(out, x, g)[0]
    torch.cuda.synchronize()
    assert dict(pcuda.launches) == before
    assert pcuda.backward_launches["blend_overlap_add"] == kernels + 1
    xp = tiles.clone().requires_grad_()
    want = torch.autograd.grad(
        blend_overlap_add_plain(xp, win, inv, gi, b, crop, odt), xp, g)[0]
    bits = torch.int16 if tdt == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype == tdt
    assert torch.equal(got.view(bits), want.view(bits)), \
        float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("n", [1, 12, 88])
def test_cuda_kernel_spectrum_planes_match_plain(cuda_dev, n):
    """kernel_spectrum at the plane counts of the routes: one 481 x 637
    image (the tiles route: h 505, kp 384, rows no multiple of the 64-row
    pass), config 2's 12 tiles and the 12 MP main path's 88 tiles of
    448 px. Within 1e-5 of max |q| of the plain version."""
    from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs

    g = torch.Generator().manual_seed(7)
    sigma, rho = (0.3 + 3.7 * torch.rand(n, generator=g) for _ in range(2))
    theta = torch.randint(0, 30, (n,), generator=g).float() * (math.pi / 30)
    est = _est_rows(*(v.numpy() for v in gaussian_quadratic_coeffs(
        sigma, rho, theta))).to(cuda_dev)
    tabs = (stage_tables(481, 637, torch.float32, str(cuda_dev)) if n == 1
            else stage_tables(448, 448, torch.bfloat16, str(cuda_dev)))
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    before = dict(pcuda.launches)
    got = kernel_spectrum(est, coeffs, tabs)
    assert _counts(before, "kernel_spectrum") == 1
    want = kernel_spectrum_plain(est, coeffs, tabs)
    assert got.shape == want.shape == (n, tabs.h, 2 * tabs.er.shape[1])
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("odt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(3000, 4000), (1198, 1598)])
def test_cuda_blend_geometries_match_plain(cuda_dev, hw, tdt, odt):
    """The blend on 448/384 tiles: the 12 MP main path's grid (16-byte
    path: left crop 144, width 4000) and an even-cropped 1198 x 1598 image
    (scalar path: left crop 1, width 1598), for every tile and output
    dtype. Within 1e-6 of the plain version."""
    grid = plan_patch_grid(*hw, 448, 64.0 / 448.0)
    th, tw, sh, sw = _grid_steps(grid)
    tiles = torch.rand((th * tw, 3, 448, 448),
                       generator=torch.Generator().manual_seed(8)).to(
        cuda_dev, tdt)
    win, inv = _blend_constants(grid, "kaiser", cuda_dev)
    args = (win, inv, (th, tw, sh, sw, 448, 448), 1,
            (grid.pad[0], grid.pad[2]) + grid.orig_size)
    before = dict(pcuda.launches)
    got = blend_overlap_add(tiles, *args, out_dtype=odt)
    assert _counts(before, "blend_overlap_add") == 1
    want = blend_overlap_add_plain(tiles, *args, out_dtype=odt)
    assert got.dtype == want.dtype == odt
    assert got.shape == want.shape == (1, 3) + grid.orig_size
    assert float((got.float() - want.float()).abs().max()) <= 1e-6


def test_cuda_deblur_patches_matches_cpu(cuda_dev):
    from polyblur_torch import deblur_patches

    img = torch.rand((1, 3, 200, 300), generator=torch.Generator()
                     .manual_seed(5))
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2, c=0.362,
              b=0.468, alpha=6.0, beta=1.0, out_dtype=torch.float32,
              method="direct_separable")
    got = deblur_patches(img.to(cuda_dev), device=cuda_dev, **kw).cpu()
    want = deblur_patches(img, device="cpu", **kw)
    mse = float(((got.double() - want.double()) ** 2).mean())
    assert 10 * math.log10(1.0 / max(mse, 1e-20)) >= 60.0


@pytest.mark.parametrize("replicate_pad, clip, shape", [
    (True, True, (3, 480, 640)),     # the fused whole-image route
    (False, False, (5, 280, 240)),   # blocked-route blocks
    (True, True, (2, 97, 141)),      # odd sizes
])
def test_cuda_fused_polynomial_matches_plain(cuda_dev, replicate_pad, clip,
                                             shape):
    g = torch.Generator().manual_seed(6)
    x = torch.rand(shape, generator=g).to(cuda_dev)
    a, b, c = (torch.as_tensor(v) for v in _quad_forms(
        np.random.default_rng(7), shape[0]))
    params = torch.stack([a, b, c], -1).to(cuda_dev)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)):
        before = dict(pcuda.launches)
        got = fused_polynomial(x.to(dt), params, coeffs, replicate_pad, clip)
        assert _counts(before, "fused_polynomial") == 5
        want = fused_polynomial_plain(x.to(dt), params, coeffs,
                                      replicate_pad, clip)
        assert got.dtype == dt and got.shape == shape
        assert float((got.float() - want.float()).abs().max()) <= tol


def test_cuda_blocked_polynomial_matches_plain(cuda_dev):
    from polyblur_torch.ops import sep_poly as tsp

    x = torch.rand((2, 700, 500), generator=torch.Generator()
                   .manual_seed(8)).to(cuda_dev)
    a, b, c = (torch.as_tensor(v).to(cuda_dev)
               for v in _quad_forms(np.random.default_rng(9), 2))
    horner = tuple(float(v) for v in _mega_pack(*COEFFS)[:4])
    got = tsp._blocked_polynomial(x, a, b, c, horner, 12)
    with pcuda.plain_versions():
        want = tsp._blocked_polynomial(x, a, b, c, horner, 12)
    ref = tsp._spectral2d(x, a, b, c, horner, 12)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("shape", [(1, 1, 480, 640), (4, 3, 481, 637),
                                   (1, 3, 480, 640), (1, 3, 480, 512),
                                   (3, 1, 160, 160)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_directional_maxima_matches_plain(cuda_dev, shape, dt):
    """Images as one tile each: n = 1 with C = 1 and C = 3 (the split gray
    pass's one-row bands), rows whose pitch is no multiple of 16 bytes
    (scalar operand loads), ragged 64 x 64 output tiles."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(10))
    x = x.to(cuda_dev).to(dt)
    before = dict(pcuda.launches)
    got = directional_maxima(x)
    assert _counts(before, "directional_maxima") == 3
    want = directional_maxima_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


def test_cuda_tiles_mode_matches_plain(cuda_dev):
    """The whole-image tiles route at an odd rectangle whose 2h is not a
    multiple of 16 (h = 505, wc = 661, kp = 384)."""
    x = torch.rand((1, 3, 481, 637), generator=torch.Generator()
                   .manual_seed(11)).to(cuda_dev)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    before = dict(pcuda.launches)
    got = polyblur_tiles_fused(x, coeffs, 2)
    assert _counts(before, "tile_estimate") == 8
    assert _counts(before, "spectral_gemm") == 8
    with pcuda.plain_versions():
        want = polyblur_tiles_fused(x, coeffs, 2)
    mse = float(((got.double() - want.double()) ** 2).mean())
    assert 10 * math.log10(1.0 / max(mse, 1e-20)) >= 60.0


# ------------------------------------------------ feature-flag kernels (CUDA)

def _canvas_view(dev, dt, seed, size=(300, 420), patch=160):
    """A (1, 3) image's tile canvas in ``dt`` and the TileView of its
    tiles (the patch engine's first-iteration input)."""
    img = torch.rand((1, 3) + size, generator=torch.Generator()
                     .manual_seed(seed)).to(dev)
    grid = plan_patch_grid(*size, patch, 32.0 / patch)
    th, tw, sh, sw = _grid_steps(grid)
    canvas = edge_pad_cast(img, grid.orig_size, grid.pad, dt)
    return TileView(canvas, 1, 0, th * tw, tw, (sh, sw), (patch, patch))


@pytest.mark.parametrize("dt, tol", [(torch.float32, 1e-5),
                                     (torch.bfloat16, 2.0 ** -7)])
def test_cuda_bilateral_matches_plain(cuda_dev, dt, tol):
    """Whole planes of 1 x 1, 2 x 3 and 5 x 5 (the clamp makes several
    taps one pixel), 7 x 33, 8 x 64 and 301 x 419 (widths that are and are
    not multiples of 4: the 16-byte and the scalar stores; 419 > 124, the
    columns of one warp), output in the input dtype; then tiles read from
    a canvas, f32 smooth and noise: the patch engine's grid, and a grid at
    odd steps (rows off the 8-byte pair loads) of 160^2 and 157 x 161
    tiles."""
    from polyblur_torch.ops.bilateral import bilateral_filter
    from polyblur_torch.ops.cuda.bilateral import bilateral, bilateral_plain

    g = torch.Generator().manual_seed(20)
    for h, w in ((1, 1), (2, 3), (5, 5), (7, 33), (8, 64), (301, 419)):
        x = torch.rand((2, 3, h, w), generator=g).to(cuda_dev).to(dt)
        before = dict(pcuda.launches)
        got = bilateral_filter(x)
        assert _counts(before, "bilateral") == 1 and got.dtype == dt
        with pcuda.plain_versions():
            want = bilateral_filter(x)
        assert float((got.float() - want.float()).abs().max()) <= tol, (h, w)
    odd = torch.rand((1, 3, 2 * 127 + 161, 3 * 129 + 161),
                     generator=g).to(cuda_dev).to(dt)
    views = [_canvas_view(cuda_dev, dt, 21)] + [
        TileView(odd, 1, 0, 12, 4, (127, 129), patch)
        for patch in ((160, 160), (157, 161))]
    for view in views:
        smooth, noise = bilateral(view, out_dtype=torch.float32,
                                  with_noise=True)
        s_p, n_p = bilateral_plain(view, out_dtype=torch.float32,
                                   with_noise=True)
        assert float((smooth - s_p).abs().max()) <= 1e-5, view.patch
        assert float((noise - n_p).abs().max()) <= 1e-5, view.patch


def test_cuda_iir_matches_plain(cuda_dev):
    """Row and column passes and the dt stage's fused maps and row pass;
    the kernels' compositions round differently from the Hillis-Steele
    plain version (1e-5; the maps 1e-6). The
    column pass at H = 200 and 448 (the strip's forward result in shared
    memory, a last partial chunk at 200) and 777 (through device memory),
    at W = 333 (4-byte copies) and, at 777, W = 336 (16-byte copies and
    stores), in place, with and without the noise, and from a bf16
    canvas."""
    from polyblur_torch.ops.cuda.iir import (dt_coeffs_plain, dt_scan_rows,
                                             scan_cols, scan_cols_plain,
                                             scan_rows, scan_rows_plain)
    from polyblur_torch.ops.domain_transform import iir_scan_rows

    g = torch.Generator().manual_seed(22)
    for h, w in ((200, 333), (448, 333), (777, 333), (777, 336)):
        x = torch.rand((2, 3, h, w), generator=g).to(cuda_dev)
        v = (0.95 * torch.rand((2, h, w), generator=g)).to(cuda_dev)
        view = TileView.of_tiles(x)
        before = dict(pcuda.launches)
        rows = scan_rows(view, v)
        assert _counts(before, "iir_scan_rows") == 1
        assert float((rows - scan_rows_plain(view, v)).abs().max()) <= 1e-5
        out_p, noise_p = scan_cols_plain(rows, v, src=view)
        xin = rows.clone()
        out = scan_cols(xin, v)
        assert out.data_ptr() == xin.data_ptr()
        assert float((out - out_p).abs().max()) <= 1e-5
        xin = rows.clone()
        out, noise = scan_cols(xin, v, src=view)
        assert out.data_ptr() == xin.data_ptr()
        assert _counts(before, "iir_scan_rows") == 3
        assert float((out - out_p).abs().max()) <= 1e-5
        assert float((noise - noise_p).abs().max()) <= 1e-5
    cv = _canvas_view(cuda_dev, torch.bfloat16, 27)
    vc = (0.95 * torch.rand((cv.n, 160, 160), generator=g)).to(cuda_dev)
    rows = scan_rows(cv, vc)
    out_p, noise_p = scan_cols_plain(rows, vc, src=cv)
    out, noise = scan_cols(rows.clone(), vc, src=cv)
    assert float((out - out_p).abs().max()) <= 1e-5
    assert float((noise - noise_p).abs().max()) <= 1e-5
    vf = v[:, None].expand(x.shape)
    got = iir_scan_rows(x, vf)
    with pcuda.plain_versions():
        want = iir_scan_rows(x, vf)
    assert float((got - want).abs().max()) <= 1e-5
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    for dt in (torch.float32, torch.bfloat16):
        cv = _canvas_view(cuda_dev, dt, 23)
        before = dict(pcuda.launches)
        rows, vv = dt_scan_rows(cv, coeffs)
        assert _counts(before, "dt_scan_rows") == 1
        vh_p, vv_p = dt_coeffs_plain(cv, coeffs)
        assert float((vv - vv_p).abs().max()) <= 1e-6
        assert float((rows - scan_rows_plain(cv, vh_p)).abs().max()) <= 1e-5


def _odd_canvas_view(dev, dt, seed, patch, x0):
    """A 2 x 2 grid of ``patch`` tiles at odd steps on a (1, 3) canvas
    whose columns start ``x0`` elements past an allocation (x0 = 1: every
    tile origin off 16 bytes)."""
    ph, pw = patch
    g = torch.Generator().manual_seed(seed)
    full = torch.rand((1, 3, ph + 37, pw + 41 + x0), generator=g)
    data = full.to(dev).to(dt)[..., x0:]
    return TileView(data, 1, 0, 4, 2, (37, 41), patch)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [1, 31, 33, 160, 447, 448, 512, 513, 1600,
                               4100])
def test_cuda_iir_rows_geometries_match_plain(cuda_dev, dt, w):
    """The row pass at widths in one lane's run, in one warp (<= 512: the
    row in registers), split over the warps of a block (513, 1600) and
    past one span of 4096; one map per plane (vdiv 1) and per tile (vdiv
    C = 3); dense tiles and a canvas at odd steps, aligned and with every
    tile origin off 16 bytes (the element-wise loads); then the dt
    stage's fused maps and row pass on the same views (v_v within 1e-6;
    past its one span it refuses the tiles)."""
    from polyblur_torch.ops.cuda.iir import (DT_MAX_WIDTH, dt_coeffs_plain,
                                             dt_scan_rows, scan_rows,
                                             scan_rows_plain)

    g = torch.Generator().manual_seed(40 + w)
    h = 3 if w > 512 else 17
    x = torch.rand((2, 3, h, w), generator=g).to(cuda_dev).to(dt)
    views = [TileView.of_tiles(x)] + [
        _odd_canvas_view(cuda_dev, dt, w, (h, w), x0) for x0 in (0, 1)]
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    for view in views:
        for maps in (view.n * 3, view.n):
            v = (0.999 * torch.rand((maps, h, w), generator=g)).to(cuda_dev)
            before = dict(pcuda.launches)
            rows = scan_rows(view, v)
            assert _counts(before, "iir_scan_rows") == 1
            err = float((rows - scan_rows_plain(view, v)).abs().max())
            assert err <= 1e-5, (view.step, maps, err)
        if w > DT_MAX_WIDTH:
            with pytest.raises(ValueError):
                dt_scan_rows(view, coeffs)
            continue
        before = dict(pcuda.launches)
        rows, vv = dt_scan_rows(view, coeffs)
        assert _counts(before, "dt_scan_rows") == 1
        vh_p, vv_p = dt_coeffs_plain(view, coeffs)
        assert float((vv - vv_p).abs().max()) <= 1e-6, view.step
        err = float((rows - scan_rows_plain(view, vh_p)).abs().max())
        assert err <= 1e-5, (view.step, err)


def test_cuda_taper_and_halo_stages_match_plain(cuda_dev):
    """The taper weights against their plain version; each blend, folded
    into the last product of its blur (``spectral_poly(..., taper=)``),
    against the same kernels' unfolded application followed by the plain
    blend: the same f32 accumulator and rounding, so equal (gate 1e-6),
    from the tiles padded by 12 and in place on the canvas; then the
    halo."""
    from polyblur_torch.ops.cuda.features import (
        halo_grads, halo_grads_plain, halo_mask, halo_mask_plain,
        taper_weights, taper_weights_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import taper_blend_plain
    from polyblur_torch.pipeline import _unit_horner

    f32 = torch.float32
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    view = _canvas_view(cuda_dev, f32, 24)
    est = tile_estimate(view, coeffs)
    h = w = 160 + 2 * HALF
    before = dict(pcuda.launches)
    av, ah = taper_weights(est, h, w)
    av_p, ah_p = taper_weights_plain(est, h, w)
    assert float((av - av_p).abs().max()) <= 1e-6
    assert float((ah - ah_p).abs().max()) <= 1e-6
    assert _counts(before, "taper") == 1
    for dt in (f32, torch.bfloat16):
        u = _canvas_view(cuda_dev, dt, 25)
        tabs = stage_tables(160, 160, dt, str(cuda_dev))
        khat2 = kernel_spectrum(est, _unit_horner(str(cuda_dev)), tabs)
        for src in (u, TileView.of_tiles(u.tiles().float())):
            ku = spectral_poly(src, khat2, tabs, crop=0, clip=False,
                               out_dtype=f32)
            want = taper_blend_plain(src, HALF, av, ah, ku,
                                     torch.empty_like(ku))
            xc = torch.empty_like(ku)
            before = dict(pcuda.launches)
            spectral_poly(src, khat2, tabs, xc, crop=0, clip=False,
                          out_dtype=f32, taper=(av, ah))
            assert _counts(before, "spectral_gemm") == 4
            assert float((xc - want).abs().max()) <= 1e-6
            for _ in range(2):   # in place on the canvas
                cw = TileView.of_tiles(want)
                ku = spectral_poly(cw, khat2, tabs, pad=0, crop=0,
                                   clip=False, out_dtype=f32)
                taper_blend_plain(cw, 0, av, ah, ku, want)
                spectral_poly(TileView.of_tiles(xc), khat2, tabs, xc, pad=0,
                              crop=0, clip=False, out_dtype=f32,
                              taper=(av, ah))
                assert float((xc - want).abs().max()) <= 1e-6
    before = dict(pcuda.launches)
    grads = halo_grads(view)
    grads_p = halo_grads_plain(view)
    scale = float(grads_p.gx.abs().max())
    assert float((grads.gx - grads_p.gx).abs().max()) <= 1e-5 * scale
    assert float((grads.gy - grads_p.gy).abs().max()) <= 1e-5 * scale
    nm, nm_p = grads.part.sum(-1), grads_p.part.sum(-1)
    assert float(((nm - nm_p).abs() / nm_p).max()) <= 1e-5
    o = view.tiles().float() + 0.05 * torch.randn(
        (view.n, 3, 160, 160), generator=torch.Generator().manual_seed(26)
    ).to(cuda_dev)
    noise = 0.01 * torch.randn_like(o)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -7)):
        out = torch.empty_like(o, dtype=dt)
        halo_mask(o, grads, view, noise, out)
        want = halo_mask_plain(o, grads, view, noise, torch.empty_like(out))
        assert float((out.float() - want.float()).abs().max()) <= tol
    assert _counts(before, "halo") == 3


@pytest.mark.parametrize("patch, dt, offset", [
    (448, torch.bfloat16, 0), (448, torch.float32, 0),    # config 2 tiles
    (160, torch.bfloat16, 3), (160, torch.float32, 1),    # origin off 16 B
    (157, torch.float32, 0)])                             # ragged, odd pitch
def test_cuda_halo_views_match_plain(cuda_dev, patch, dt, offset):
    """The halo's derivative GEMM on TileViews whose tiles start off a
    16-byte boundary (a canvas cut one or three columns in), on ragged
    tiles, and the mask with ``out`` aliasing ``ucmp`` (as the tiles
    route's later iterations run it)."""
    from polyblur_torch.ops.cuda.features import (
        halo_grads, halo_grads_plain, halo_mask, halo_mask_plain)

    img = _photo(cuda_dev, 2 * patch, 2 * patch + 8, 50, 60)
    canvas = img.to(dt)[..., offset:]
    step = patch - patch // 4
    view = TileView(canvas, 1, 0, 4, 2, (step, step), (patch, patch))
    before = dict(pcuda.launches)
    grads = halo_grads(view)
    grads_p = halo_grads_plain(view)
    scale = float(grads_p.gx.abs().max())
    assert float((grads.gx - grads_p.gx).abs().max()) <= 1e-5 * scale
    assert float((grads.gy - grads_p.gy).abs().max()) <= 1e-5 * scale
    nm, nm_p = grads.part.sum(-1), grads_p.part.sum(-1)
    assert float(((nm - nm_p).abs() / nm_p).max()) <= 1e-5
    g = torch.Generator().manual_seed(35)
    o = (view.tiles().float() + 0.05 * torch.randn(
        (4, 3, patch, patch), generator=g).to(cuda_dev)).contiguous()
    tol = 1e-4 if dt == torch.float32 else 2.0 ** -7
    u = view.tiles().contiguous()
    want = halo_mask_plain(o, grads, TileView.of_tiles(u), None,
                           torch.empty_like(u))
    out = halo_mask(o, grads, TileView.of_tiles(u), None, u)   # in place
    assert out.data_ptr() == u.data_ptr()
    assert float((u.float() - want.float()).abs().max()) <= tol
    assert _counts(before, "halo") == 2


def test_cuda_spectral_poly_f32_tiles_and_noise_match_plain(cuda_dev):
    """The taper's applications: f32 tiles under bf16 operands, the tile
    padded onto the whole canvas (pad 12, crop 0) and the canvas cropped
    back (pad 0, crop 12) with the noise epilogue."""
    view = _canvas_view(cuda_dev, torch.bfloat16, 27)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    est = tile_estimate(view, coeffs)
    tabs = stage_tables(160, 160, torch.bfloat16, str(cuda_dev))
    q2 = kernel_spectrum(est, coeffs, tabs)
    x32 = TileView.of_tiles(view.tiles().float())
    canvas = spectral_poly(x32, q2, tabs, crop=0, clip=False,
                           out_dtype=torch.float32)
    want = spectral_poly_plain(x32, q2, tabs, crop=0, clip=False,
                               out_dtype=torch.float32)
    assert canvas.shape == (view.n, 3, 184, 184)
    assert float((canvas - want).abs().max()) <= 2.0 ** -7
    noise = 0.01 * torch.randn((view.n, 3, 160, 160), device=cuda_dev)
    cv = TileView.of_tiles(want)
    got = spectral_poly(cv, q2, tabs, pad=0, noise=noise)
    ref = spectral_poly_plain(cv, q2, tabs, pad=0, noise=noise)
    assert got.dtype == torch.bfloat16 and got.shape == (view.n, 3, 160, 160)
    assert float((got.float() - ref.float()).abs().max()) <= 2.0 ** -7


@pytest.mark.parametrize("dt, prefilter, min_db", [
    (torch.float32, "dt", 60.0), (torch.float32, "bilateral", 60.0),
    (torch.bfloat16, "dt", 40.0), (torch.bfloat16, "bilateral", 40.0)])
def test_cuda_feature_stages_match_plain(cuda_dev, dt, prefilter, min_db):
    """restore_tiles with every flag on the patch canvas, 2 iterations."""
    from polyblur_torch.pipeline import restore_tiles

    view = _canvas_view(cuda_dev, dt, 28)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    flags = dict(do_taper=True, do_halo=True, prefilter=prefilter)
    before = dict(pcuda.launches)
    got = restore_tiles(view, coeffs, 2, **flags)
    for name in ("taper", "halo") + (("dt_scan_rows", "iir_scan_rows")
                                     if prefilter == "dt" else ("bilateral",)):
        assert _counts(before, name) > 0, name
    with pcuda.plain_versions():
        want = restore_tiles(view, coeffs, 2, **flags)
    mse = float(((got.double() - want.double()) ** 2).mean())
    assert 10 * math.log10(1.0 / max(mse, 1e-20)) >= min_db


@pytest.mark.parametrize("shape, pad, dt, tol", [
    ((1, 3, 481, 637), 12, torch.float32, 1e-4),     # tiles stage, ragged
    ((1, 3, 481, 637), 12, torch.bfloat16, 2.0 ** -7),
    ((6, 1, 280, 240), 0, torch.float32, 1e-4),      # blocked-route blocks
    ((6, 1, 280, 240), 0, torch.bfloat16, 2.0 ** -7),
])
def test_cuda_spectral_poly_ragged_matches_plain(cuda_dev, shape, pad, dt,
                                                 tol):
    """Ragged M / N / K against the 128 x 128 x 64 GEMM tiles: odd canvas
    rows (h = 505) and an M that is no multiple of 128 (280)."""
    n, c, ph, pw = shape
    x = torch.rand(shape, generator=torch.Generator().manual_seed(30))
    view = TileView.of_tiles(x.to(cuda_dev).to(dt))
    a, b, cq = _quad_forms(np.random.default_rng(31), n)
    tabs = stage_tables(ph, pw, dt, str(cuda_dev), pad)
    q2 = kernel_spectrum(_est_rows(a, b, cq).to(cuda_dev),
                         _mega_pack(*COEFFS, device=cuda_dev), tabs)
    before = dict(pcuda.launches)
    got = spectral_poly(view, q2, tabs, clip=False)
    assert _counts(before, "spectral_gemm") == 4
    want = spectral_poly_plain(view, q2, tabs, clip=False)
    assert got.shape == shape and got.dtype == dt
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dt, tol", [(torch.float32, 1e-4),
                                     (torch.bfloat16, 2.0 ** -7)])
def test_cuda_spectral_poly_taper_pair_noise_alias(cuda_dev, dt, tol):
    """The taper's pair (the tile padded onto the whole canvas, f32 out;
    the canvas cropped back), the noise epilogue with f32 and work-dtype
    out, and an output that aliases the input."""
    view = _canvas_view(cuda_dev, dt, 32)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    tabs = stage_tables(160, 160, dt, str(cuda_dev))
    q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs, tabs)
    f32 = torch.float32
    canvas = spectral_poly(view, q2, tabs, crop=0, clip=False, out_dtype=f32)
    want = spectral_poly_plain(view, q2, tabs, crop=0, clip=False,
                               out_dtype=f32)
    assert canvas.shape == (view.n, 3, 184, 184)
    assert float((canvas - want).abs().max()) <= tol
    cv = TileView.of_tiles(want)
    noise = 0.01 * torch.randn((view.n, 3, 160, 160), generator=torch
                               .Generator().manual_seed(33)).to(cuda_dev)
    for odt in (f32, dt):
        got = spectral_poly(cv, q2, tabs, pad=0, noise=noise, out_dtype=odt)
        ref = spectral_poly_plain(cv, q2, tabs, pad=0, noise=noise,
                                  out_dtype=odt)
        assert got.dtype == odt
        assert float((got.float() - ref.float()).abs().max()) <= tol
    x = view.tiles().clone()
    ref = spectral_poly_plain(TileView.of_tiles(x), q2, tabs)
    got = spectral_poly(TileView.of_tiles(x), q2, tabs, out=x)
    assert got.data_ptr() == x.data_ptr()
    assert float((x.float() - ref.float()).abs().max()) <= tol


def test_cuda_edge_pad_cast_unaligned(cuda_dev):
    """Odd left pads and source widths, a source that starts off a
    16-byte boundary, rows of the canvas that start off one, every pair
    of dtypes: bit-equal to the plain version."""
    g = torch.Generator().manual_seed(34)
    big = torch.rand((2, 3, 41, 133), generator=g).to(cuda_dev)
    for src in (big, big[1:], big[:, :, :, 3:].contiguous()):
        h, w = src.shape[-2] - 1, src.shape[-1] - 1
        for pads in ((3, 4, 5, 7), (0, 1, 1, 0), (68, 68, 144, 144)):
            for idt in (torch.float32, torch.bfloat16):
                for odt in (torch.float32, torch.bfloat16):
                    x = src.to(idt)
                    got = edge_pad_cast(x, (h, w), pads, odt)
                    want = edge_pad_cast_plain(x, (h, w), pads, odt)
                    assert torch.equal(got, want), (tuple(x.shape), pads,
                                                    idt, odt)


# ------------------------------------------------ autograd Functions (CUDA)

def _function_vs_plain_cuda(fn, plain, inputs):
    """A Function's gradients (its kernels forward, autograd of its plain
    version backward) against autograd of the plain version on the same
    inputs and seeded cotangent: bit-equal (no plain backward accumulates
    with atomics). The forward launches, the backward does not."""
    def grads(f, under_plain):
        xs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
        n0 = sum(pcuda.launches.values())
        if under_plain:
            with pcuda.plain_versions():
                out = f(*xs)
        else:
            out = f(*xs)
        n1 = sum(pcuda.launches.values())
        gen = torch.Generator(device=out.device).manual_seed(7)
        g = torch.randn(out.shape, generator=gen, device=out.device)
        gs = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                 g.to(out.dtype))
        return gs, n1 - n0, sum(pcuda.launches.values()) - n1

    got, fwd, bwd = grads(fn, False)
    want, _, _ = grads(plain, True)
    assert fwd > 0 and bwd == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_functions_backward_match_plain_autograd(cuda_dev, dt):
    """ROADMAP B.1 items 1-6 and the blend at small shapes."""
    from polyblur_torch.estimation import _mags_fast, _mags_xla
    from polyblur_torch.ops.cuda.polyblur_fused import (
        _restore_canvas, polyblur_image_fused)
    from polyblur_torch.ops.sep_poly import _block_view
    from polyblur_torch.pipeline import restore_tiles

    img = _photo(cuda_dev, 300, 420)
    grid = plan_patch_grid(300, 420, 160, 32.0 / 160.0)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, 160, 160)
    crop = (grid.pad[0], grid.pad[2]) + grid.orig_size
    win, inv = _blend_constants(grid, "kaiser", cuda_dev)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    flags = dict(do_taper=False, do_halo=False, prefilter=None)
    _function_vs_plain_cuda(
        lambda x: edge_pad_cast(x, grid.orig_size, grid.pad, dt),
        lambda x: edge_pad_cast_plain(x, grid.orig_size, grid.pad, dt),
        (img,))
    canvas = edge_pad_cast_plain(img, grid.orig_size, grid.pad, dt)

    def stages(cv, co):
        return _restore_canvas(cv, co, 2, gi, None, flags)

    _function_vs_plain_cuda(lambda cv, co: polyblur_image_fused(cv, co, 2,
                                                                gi),
                            stages, (canvas, coeffs))
    with torch.no_grad():
        tiles = stages(canvas, coeffs)
    _function_vs_plain_cuda(
        lambda t: blend_overlap_add(t, win, inv, gi, 1, crop, torch.float32),
        lambda t: blend_overlap_add_plain(t, win, inv, gi, 1, crop,
                                          torch.float32), (tiles,))
    x = img[..., :97, :141].contiguous().to(dt)
    _function_vs_plain_cuda(lambda t, co: polyblur_tiles_fused(t, co, 2),
                            lambda t, co: restore_tiles(t, co, 2),
                            (x, coeffs))
    planes = img[0, :, :200, :260].contiguous().to(dt)
    params = torch.tensor([[0.8, 0.1, 0.5], [0.3, -0.05, 0.9],
                           [1.2, 0.2, 0.4]], device=cuda_dev)
    _function_vs_plain_cuda(
        lambda p, q, co: fused_polynomial(p, q, co, True, True),
        lambda p, q, co: fused_polynomial_plain(p, q, co, True, True),
        (planes, params, coeffs[:4].clone()))
    view, _ = _block_view(img[0, :1, :700, :700].contiguous().to(dt), 12)
    _function_vs_plain_cuda(
        lambda d, q, co: fused_polynomial(view._replace(data=d), q, co),
        lambda d, q, co: fused_polynomial_plain(view._replace(data=d), q,
                                                co),
        (view.data, params[:1].repeat(view.n, 1), coeffs[:4].clone()))
    gray = img.mean(1, keepdim=True).to(dt)
    _function_vs_plain_cuda(lambda g: _mags_fast(g, 6),
                            lambda g: _mags_xla(g, 6), (gray,))


def test_cuda_forward_on_another_thread_launches_during_a_backward(
        cuda_dev):
    """While a Function's backward replays its plain version (on the
    autograd engine's thread), a forward on another thread launches its
    kernel and counts it: the plain mode is the replaying thread's."""
    import threading

    from polyblur_torch.ops.cuda.autograd import replay

    img = _photo(cuda_dev, 64, 96)
    seen = {}

    def forward_elsewhere():
        with torch.no_grad():
            n0 = pcuda.launches["edge_pad_cast"]
            y = edge_pad_cast(img, (64, 96), (2, 2, 3, 3), torch.bfloat16)
            seen["launched"] = pcuda.launches["edge_pad_cast"] - n0
            seen["equal"] = torch.equal(y, edge_pad_cast_plain(
                img, (64, 96), (2, 2, 3, 3), torch.bfloat16))

    def plain(t):
        other = threading.Thread(target=forward_elsewhere)
        other.start()
        other.join()
        return t * 2

    x = img.clone().requires_grad_()
    replay(lambda t: t * 2, plain, x).sum().backward()
    torch.cuda.synchronize()
    assert seen == {"launched": 1, "equal": True}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_flag_functions_backward_match_plain_autograd(cuda_dev, dt):
    """ROADMAP B.1 items 7-8: the bilateral Function, the two IIR
    Functions, and the flagged tiles and canvas Functions (their backward
    replays the scan route on all their tiles as one batch,
    ``pipeline._ref_pipeline``) against autograd of those plain versions:
    bit-equal, the forward launching and the backward not."""
    from polyblur_torch.ops.bilateral import _bilateral_plain, bilateral_filter
    from polyblur_torch.ops.cuda.iir import (scan_cols, scan_cols_plain,
                                             scan_rows, scan_rows_plain)
    from polyblur_torch.ops.cuda.polyblur_fused import (
        _ref_image_pipeline, polyblur_image_fused)
    from polyblur_torch.pipeline import _ref_pipeline

    img = _photo(cuda_dev, 300, 420)
    x = img.to(dt)
    v = torch.rand((1, 300, 420), device=cuda_dev) * 0.8 + 0.1
    _function_vs_plain_cuda(bilateral_filter,
                            lambda t: _bilateral_plain(t, 5, 5.0, 0.1), (x,))
    _function_vs_plain_cuda(
        lambda t, vv: scan_rows(TileView.of_tiles(t), vv),
        lambda t, vv: scan_rows_plain(TileView.of_tiles(t), vv), (x, v))
    _function_vs_plain_cuda(scan_cols, scan_cols_plain, (img, v))
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    grid = plan_patch_grid(300, 420, 160, 32.0 / 160.0)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, 160, 160)
    canvas = edge_pad_cast_plain(img, grid.orig_size, grid.pad, dt)
    for flags in (dict(do_taper=True, do_halo=True, prefilter="dt"),
                  dict(do_taper=True, do_halo=True, prefilter="bilateral")):
        _function_vs_plain_cuda(
            lambda t, co: polyblur_tiles_fused(t, co, 2, **flags),
            lambda t, co: _ref_pipeline(t, co, 2, **flags),
            (x[..., :97, :141].contiguous(), coeffs))
        _function_vs_plain_cuda(
            lambda cv, co: polyblur_image_fused(cv, co, 2, gi, **flags),
            lambda cv, co: _ref_image_pipeline(cv, co, 2, gi, flags),
            (canvas, coeffs))


def test_cuda_graph_through_a_route_without_backward_raises(cuda_dev):
    """The flagged routes train: the tiles route with the taper and the
    scan route with the bilateral prefilter return finite gradients, and
    the backward launches no kernel; a bare kernel wrapper given a tensor
    autograd records raises rather than cutting the graph."""
    from polyblur_torch.pipeline import polyblur_core

    x = _photo(cuda_dev, 96, 128).requires_grad_()
    for kw in (dict(n_iter=1, edgetaping=True),
               dict(n_iter=2, prefiltering=True, _disable_mega=True)):
        out = polyblur_core(x, method="direct_separable", device=cuda_dev,
                            **kw)
        pcuda.reset_launches()
        (g,) = torch.autograd.grad(out.square().mean(), x)
        assert dict(pcuda.launches) == {}
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
    with pytest.raises(RuntimeError, match="no backward"):
        tile_estimate(TileView.of_tiles(x), _mega_pack(*COEFFS,
                                                       device=cuda_dev))


def test_cuda_grad_free_calls_launch_as_before(cuda_dev):
    """The staged patch route launches the same kernels without grad,
    under no_grad with an input that requires grad, and in the forward of
    a recorded step, whose backward launches no forward kernel and the
    blend's backward kernel once."""
    from polyblur_torch.patches import deblur_patches

    img = _photo(cuda_dev, 300, 420)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2,
              method="direct_separable", work_dtype=torch.bfloat16,
              out_dtype=torch.float32, device=cuda_dev)
    want = {"edge_pad_cast": 1, "tile_estimate": 8, "kernel_spectrum": 2,
            "spectral_gemm": 8, "blend_overlap_add": 1}

    def counted(x, grad=True):
        pcuda.reset_launches()
        with torch.set_grad_enabled(grad):
            out = deblur_patches(x, **kw)
        return out, dict(pcuda.launches)

    ref, n = counted(img)
    assert n == want and ref.grad_fn is None
    xg = img.clone().requires_grad_()
    out, n = counted(xg, grad=False)
    assert n == want and torch.equal(out, ref)
    out, n = counted(xg)
    assert n == want and out.grad_fn is not None and torch.equal(
        out.detach(), ref)
    pcuda.reset_launches()
    out.square().mean().backward()
    assert dict(pcuda.launches) == {} and xg.grad is not None
    assert dict(pcuda.backward_launches) == {"blend_overlap_add": 1}


@pytest.mark.parametrize("prefilter", ["dt", "bilateral"])
def test_cuda_grad_free_flagged_calls_launch_as_before(cuda_dev, prefilter):
    """With every flag the staged patch route launches the same kernels
    without grad, under no_grad with an input that requires grad, and in
    the forward of a recorded step (its Functions' forward is the kernels'
    route); the backward, the scan route's plain replay and the blend's
    backward kernel, launches no forward kernel."""
    from polyblur_torch.patches import deblur_patches

    img = _photo(cuda_dev, 300, 420)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2,
              method="direct_separable", work_dtype=torch.bfloat16,
              out_dtype=torch.float32, device=cuda_dev, edgetaping=True,
              remove_halo=True, prefiltering=True,
              smoother="domain_transform" if prefilter == "dt"
              else "bilateral")

    def counted(x, grad=True):
        pcuda.reset_launches()
        with torch.set_grad_enabled(grad):
            out = deblur_patches(x, **kw)
        return out, dict(pcuda.launches)

    ref, want = counted(img)
    assert want[prefilter if prefilter == "bilateral" else "dt_scan_rows"] == 2
    assert want["taper"] == 2 and want["halo"] == 3
    xg = img.clone().requires_grad_()
    out, n = counted(xg, grad=False)
    assert n == want and torch.equal(out, ref)
    out, n = counted(xg)
    assert n == want and out.grad_fn is not None and torch.equal(
        out.detach(), ref)
    pcuda.reset_launches()
    out.square().mean().backward()
    assert dict(pcuda.launches) == {}
    assert dict(pcuda.backward_launches) == {"blend_overlap_add": 1}
    assert bool(torch.isfinite(xg.grad).all())
