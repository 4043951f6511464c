"""The 'highest' kernel of ``spectral_gemm`` (``csrc/spectral.cu``
``gemm_hi_kernel``): its product order, its split of the data in
registers, the tables' split on the host, and on the card its outputs.

CPU, in NumPy:

* the kernel's order, a table of (A piece, B piece) per 8-deep slice
  (``KERNEL_ORDER``, 0 hi, 1 mid, 2 lo), held bit for bit to the order of
  the design that split both operands in shared memory, as
  ``tools/dot_mode_emulation.py``'s ``6_order`` models it (a fresh
  truncating accumulator per 32-deep K stage, the stage promoted by a
  rounded f32 add), on a band of 16 output rows of a 448 px corpus tile's
  products: modes 1 and 3, whose table is A as built and which the kernel
  computes as C^T = data table^T with the factors of each product swapped,
  and modes 2 and 4, whose data is A as built; each >= 110 dB from float64
  (against the product's peak). The unswapped order on C^T is not
  bit-equal: the check sees the order;
* the register split: the A fragment each lane reads from the
  128-byte-swizzled stage (the kernel's addressing) is the data's rows and
  columns the ``wgmma`` fragment layout names, and its split (``split4<3>``)
  is the tables' rounding;
* the host's split of the tables (``table_pieces``, ``_split_tf32(.., 3)``)
  bit-equal to the three-piece rounding written from its definition (each
  piece the tf32 rounding, to nearest with ties away from zero, of what the
  larger pieces leave) over random f32 values, 0, subnormals and values on
  a tf32 rounding tie, and over the real F^T, T2, T3 and G^T at h = wc =
  472.

CUDA (``test_cuda_*``, skipped without a card): ``spectral_poly`` and
``fused_polynomial`` under ``'highest'`` against their plain versions
(``TOL_SPEC_F32``, ``TOL_POLY_F32`` of ``chip_smoke.py``), with the noise
and the taper epilogues, the launches counted as ``name[highest]``. This
file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_spectral_highest.py -k cuda`` runs them on a machine
without it.
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
from polyblur_torch.ops.cuda.polyblur_fused import (
    HALF, TileView, _split_tf32, _tf32, kernel_spectrum, spectral_poly,
    spectral_poly_plain, spectrum_plain, stage_tables, table_pieces,
    tile_estimate)
from polyblur_torch.ops.cuda.sep_poly_fused import (fused_polynomial,
                                                    fused_polynomial_plain)
from polyblur_torch.ops.sep_poly import gaussian_quadratic_coeffs
from polyblur_torch.pipeline import _mega_pack
from polyblur_torch.utils.imaging import replicate_pad

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from dot_mode_emulation import SMALL_FIRST, _mm  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
TILE = 448
BAND = slice(200, 216)           # 16 output rows of each product
PSNR_MIN_DB = 110.0
TOL_SPEC_F32 = 1e-4              # chip_smoke.py's
TOL_POLY_F32 = 1e-4
COEFFS = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)

# (A piece, B piece) of the five small products of an 8-deep slice, as
# mma_stage_hi issues them; A is the data (split in registers), B the
# table's pieces
KERNEL_ORDER = {
    "C": [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1)],      # modes 2, 4
    "C^T": [(0, 2), (2, 0), (1, 1), (0, 1), (1, 0)],    # modes 1, 3
}


def _db(got, exact) -> float:
    """PSNR of ``got`` against ``exact`` at the product's peak."""
    exact = np.asarray(exact, np.float64)
    mse = float(np.mean((np.asarray(got, np.float64) - exact) ** 2))
    peak = float(np.abs(exact).max())
    return 10.0 * math.log10(peak * peak / max(mse, 1e-300))


@pytest.fixture(scope="module")
def products():
    """The four products' f32 operands on a 448 px corpus tile, as the
    kernel reads them: (table, data) of modes 1 and 3 (C = table data^T),
    (data, table) of modes 2 and 4 (C = data table^T), each (rows, K)."""
    img = np.asarray(Image.open(os.path.join(
        DATA, "corpus_hr", "mosaic_mixed.png")).convert("RGB"))
    x = torch.tensor(img[:TILE, :TILE, 1].astype(np.float32) / 255.0)
    t = stage_tables(TILE, TILE, torch.float32, "cpu")
    h, wc = t.h, t.wc
    qa, qb, qc = gaussian_quadratic_coeffs(torch.tensor([1.3]),
                                           torch.tensor([0.7]),
                                           torch.tensor([0.4]))
    q2 = spectrum_plain(qa, qb, qc, torch.tensor([0.02, -0.3, 1.5, 0.5]),
                        t)[0]
    kp = q2.shape[-1] // 2
    xc = replicate_pad(x[None], (t.pad,) * 4)[0]                 # (h, wc)
    fwd = t.fwd_t[:, :wc]                                        # (2kp, wc)
    r = xc @ fwd.T                                               # (h, 2kp)
    rs = torch.cat([r[:, :kp], r[:, kp:]], 0).T.contiguous()     # (kp, 2h)
    t2, t3 = t.ydft[:, :2 * h], t.ydft_inv[:, :2 * h]
    ps = ((t2 @ rs.T) * q2[:, :kp].repeat(2, 1)).T.contiguous()  # (kp, 2h)
    z = t3 @ ps.T                                                # (2h, kp)
    zz = torch.cat([z[:h], z[h:]], -1)                           # (h, 2kp)
    g = t.inv_t[t.pad:t.pad + TILE]                              # (pw, 2kp)
    return {1: (fwd, xc), 2: (rs, t2), 3: (t3, ps),
            4: (zz[t.pad:t.pad + TILE].contiguous(), g)}


@pytest.mark.parametrize("mode", [1, 3])
def test_transposed_order_is_the_three_piece_order(products, mode):
    """Modes 1 and 3: C = table data^T as the three-piece design ran it,
    against the kernel's C^T = data table^T with the factors swapped."""
    table, data = (np.ascontiguousarray(m.numpy()) for m in products[mode])
    band = table[BAND]
    ref = _mm(band, data.T, "6_order")                # A = table, B = data
    got = _mm(data, band.T, "6_order", small=KERNEL_ORDER["C^T"]).T
    assert np.array_equal(got, ref)
    exact = band.astype(np.float64) @ data.T.astype(np.float64)
    assert _db(got, exact) >= PSNR_MIN_DB
    # the three-piece order on the swapped factors is another order
    assert not np.array_equal(
        _mm(data, band.T, "6_order", small=SMALL_FIRST).T, ref)


@pytest.mark.parametrize("mode", [2, 4])
def test_data_as_a_order_is_the_three_piece_order(products, mode):
    data, table = (np.ascontiguousarray(m.numpy()) for m in products[mode])
    band = data[BAND]
    ref = _mm(band, table.T, "6_order")
    got = _mm(band, table.T, "6_order", small=KERNEL_ORDER["C"])
    assert np.array_equal(got, ref)
    exact = band.astype(np.float64) @ table.T.astype(np.float64)
    assert _db(got, exact) >= PSNR_MIN_DB


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


def _split3(x: np.ndarray) -> np.ndarray:
    """The three pieces by definition: each the tf32 rounding of what the
    larger pieces leave, the remainder formed in f32."""
    out, r = [], np.ascontiguousarray(x, np.float32)
    for _ in range(3):
        p = _tf32_by_definition(r)
        out.append(p)
        r = (r - p).astype(np.float32)
    return np.stack(out)


def _fragment(stage: np.ndarray, warp: int, lane: int, kk: int):
    """The 4 A-fragment values lane ``lane`` of warp ``warp`` reads for
    8-deep slice ``kk`` from a 64-row x 128-byte stage (f32, as bytes) in
    the 128-byte swizzle: mma_stage_hi's addressing."""
    v = []
    for j in range(4):
        r = 16 * warp + (lane >> 2) + 8 * (j & 1)
        chunk = 2 * kk + (j >> 1)
        off = r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * (lane & 3)
        v.append(stage[off:off + 4].view(np.float32)[0])
    return np.array(v, np.float32)


def test_register_split_reads_the_fragment_and_rounds_as_the_tables():
    """The A fragment read from the swizzled stage holds A(16 w + l / 4 +
    8 (j % 2), 8 kk + l % 4 + 4 (j / 2)), and its split equals the host's
    split of the same values (the tables' rounding)."""
    rng = np.random.default_rng(19)
    a = (rng.standard_normal((64, 32)) * 10.0 ** rng.integers(
        -6, 3, (64, 32))).astype(np.float32)
    stage = np.zeros(64 * 128, np.uint8)       # TMA's 128-byte swizzle
    for r in range(64):
        for c in range(8):
            o = r * 128 + ((c ^ (r & 7)) << 4)
            stage[o:o + 16] = a[r, 4 * c:4 * c + 4].view(np.uint8)
    host = _split_tf32(a, 3)[..., :32]
    for warp in range(4):
        for lane in range(32):
            for kk in range(4):
                v = _fragment(stage, warp, lane, kk)
                rows = [16 * warp + (lane >> 2) + 8 * (j & 1)
                        for j in range(4)]
                cols = [8 * kk + (lane & 3) + 4 * (j >> 1)
                        for j in range(4)]
                assert np.array_equal(v, a[rows, cols])
                assert np.array_equal(_split3(v).view(np.uint32),
                                      host[:, rows, cols].view(np.uint32))


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(190)
    if kind == "random":
        return np.concatenate([
            rng.random(2048, dtype=np.float32) * 2 - 1,
            (rng.standard_normal(1024) * 10.0 ** rng.integers(-30, 30, 1024))
            .astype(np.float32)])
    if kind == "zeros":
        return np.array([0.0, -0.0, 1.0, -1.0], np.float32)
    if kind == "subnormals":
        s = rng.integers(1, 0x00800000, 256, dtype=np.uint32).view(np.float32)
        return np.concatenate([s, -s])
    t = ((rng.integers(0x00800000, 0x7F000000, 256, dtype=np.uint32)
          & np.uint32(0xFFFFE000)) | np.uint32(0x1000)).view(np.float32)
    return np.concatenate([t, -t, np.array([1.0 + 2.0 ** -11], np.float32)])


@pytest.mark.parametrize("kind", ["random", "zeros", "subnormals", "ties"])
def test_host_split_rounds_as_split3(kind):
    vals = _values(kind)
    got = _split_tf32(vals[None], 3)[:, 0, :vals.size]
    assert np.array_equal(got.view(np.uint32), _split3(vals).view(np.uint32))
    assert np.array_equal(_tf32(vals).view(np.uint32),
                          _tf32_by_definition(vals).view(np.uint32))


@pytest.mark.parametrize("name", ["fwd_t", "ydft", "ydft_inv", "inv_t"])
def test_table_pieces_are_split3_of_the_tables(name):
    """F^T, T2, T3 and G^T of the 12 MP path's canvas (h = wc = 472): the
    pieces the 'highest' kernel reads, bit-equal to split3 of the f32
    tables the other instantiations read, K zero-padded alike, and summing
    to them exactly."""
    whole = getattr(stage_tables(TILE, TILE, torch.float32, "cpu"),
                    name).numpy()
    pieces = getattr(table_pieces(TILE + 2 * HALF, TILE + 2 * HALF, "cpu"),
                     name).numpy()
    assert pieces.shape == (3,) + whole.shape
    assert np.array_equal(pieces.view(np.uint32),
                          _split3(whole).view(np.uint32))
    assert np.array_equal(pieces.astype(np.float64).sum(0),
                          whole.astype(np.float64))


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


def _launched(before, name):
    return pcuda.launches[name] - before.get(name, 0)


@pytest.mark.parametrize("n, ph, pw, pad", [(2, 448, 448, HALF),
                                             (1, 200, 328, HALF),
                                             (2, 280, 240, 0)])
def test_cuda_spectral_poly_highest_matches_plain(cuda_dev, n, ph, pw, pad):
    view = TileView.of_tiles(_tiles(cuda_dev, n, ph, pw, 1))
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    tabs = stage_tables(ph, pw, torch.float32, str(cuda_dev), pad)
    q2 = kernel_spectrum(tile_estimate(view, coeffs), coeffs, tabs)
    rng = np.random.default_rng(2)
    noise = torch.tensor(rng.standard_normal((n, 3, ph, pw)).astype(
        np.float32) * 0.01, device=cuda_dev)
    for kw in (dict(clip=True), dict(clip=False), dict(noise=noise)):
        want = spectral_poly_plain(view, q2, tabs, **kw)
        with f32_dot_mode_scope("highest"):
            before = dict(pcuda.launches)
            got = spectral_poly(view, q2, tabs, **kw)
            torch.cuda.synchronize()
            assert _launched(before, "spectral_gemm[highest]") == 4
        assert float((got - want).abs().max()) <= TOL_SPEC_F32, kw


def test_cuda_spectral_poly_highest_taper_matches_plain(cuda_dev):
    """The taper's applications: the tile padded onto the whole canvas and
    blended in mode 4's epilogue, then the canvas itself (pad 0)."""
    from polyblur_torch.ops.cuda.features import taper_weights
    from polyblur_torch.ops.cuda.polyblur_fused import taper_blend_plain
    from polyblur_torch.pipeline import _unit_horner

    view = TileView.of_tiles(_tiles(cuda_dev, 2, 448, 448, 3))
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    tabs = stage_tables(448, 448, torch.float32, str(cuda_dev))
    est = tile_estimate(view, coeffs)
    khat2 = kernel_spectrum(est, _unit_horner(str(cuda_dev)), tabs)
    h = wc = 448 + 2 * HALF
    av, ah = taper_weights(est, h, wc)
    xc = torch.empty((2, 3, h, wc), device=cuda_dev)
    ref = torch.empty_like(xc)
    u, u_ref, pad = view, view, HALF
    for _ in range(2):
        with f32_dot_mode_scope("highest"):
            before = dict(pcuda.launches)
            spectral_poly(u, khat2, tabs, xc, pad=pad, crop=0, clip=False,
                          out_dtype=torch.float32, taper=(av, ah))
            torch.cuda.synchronize()
            assert _launched(before, "spectral_gemm[highest]") == 4
        ku = spectral_poly_plain(u_ref, khat2, tabs, pad=pad, crop=0,
                                 clip=False, out_dtype=torch.float32)
        taper_blend_plain(u_ref, pad, av, ah, ku, ref)
        assert float((xc - ref).abs().max()) <= TOL_SPEC_F32
        u, u_ref, pad = TileView.of_tiles(xc), TileView.of_tiles(ref), 0


@pytest.mark.parametrize("replicate_pad, clip", [(False, False),
                                                 (True, True)])
def test_cuda_fused_polynomial_highest_matches_plain(cuda_dev, replicate_pad,
                                                     clip):
    x = _tiles(cuda_dev, 1, 280, 240, 4)[0]                 # (3, 280, 240)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    rng = np.random.default_rng(5)
    params = torch.tensor(np.stack([rng.uniform(0.2, 0.6, 3),
                                    rng.uniform(-0.1, 0.1, 3),
                                    rng.uniform(0.2, 0.6, 3)], -1)
                          .astype(np.float32), device=cuda_dev)
    want = fused_polynomial_plain(x, params, coeffs, replicate_pad, clip)
    with f32_dot_mode_scope("highest"):
        before = dict(pcuda.launches)
        got = fused_polynomial(x, params, coeffs, replicate_pad, clip)
        torch.cuda.synchronize()
        # the spectrum counts as fused_polynomial, the four products as
        # fused_polynomial[highest]
        assert _launched(before, "fused_polynomial[highest]") == 4
    assert float((got - want).abs().max()) <= TOL_POLY_F32
