"""The feed of ``spectral_gemm``'s first product (``csrc/spectral.cu``
mode 1, ``R^T = F^T pad(x)^T``): how the replicate-padded tiles reach the
shared-memory stages.

CPU: the choice (``polyblur_fused.mode1_feed``), a pure function of the
source's dtype, base address and strides: TMA for the sources of the
benchmark's cells (the 12 MP bf16 canvas and the iterate's planes; the
flags cells' f32 prefilter tiles and taper canvas), the producers' gather
for a row pitch, a base or a channel stride off a 16-byte block, and for
any source when the work dtype is f32.

CUDA (``test_cuda_*``, skipped without a card): the same application on
both feeds, the source once as given (TMA) and once as a copy one element
off a 16-byte block (the gather), byte-equal in every product's output:
the 12 MP path's tiles cut from its canvas at unaligned origins, the
iterate's planes, the f32 prefilter tiles, the taper's pad-0 f32 canvas
(and the taper's three applications as the pipeline runs them, the first
product reading the canvas's bf16 copy from the second on),
canvases whose rows and columns are no multiple of the 128-row tiles
(ragged N, and a bottom margin that starts in one row tile and ends in the
next), and ``fused_polynomial``'s overlap-save blocks; each launch counted
under its feed in ``_build.feeds``. Then a 12 MP ``deblur_patches`` call
in bf16 counts one TMA feed per iteration and no gather. This file imports
no JAX: ``python -m pytest --noconftest tests/test_torch_mode1_feed.py -k
cuda`` runs the card's tests on a machine without it.
"""

import numpy as np
import pytest
import torch

from polyblur_torch.ops import cuda as pcuda
from polyblur_torch.ops.cuda.polyblur_fused import (
    HALF, SHIFTS, TileView, fwd_shifts, kernel_spectrum, mode1_feed,
    spectral_poly, spectral_poly_plain, spectrum_plain, stage_tables,
    tile_estimate)
from polyblur_torch.pipeline import _mega_pack
from polyblur_torch.utils.imaging import replicate_pad

BF16, F32 = torch.bfloat16, torch.float32
BASE = 1 << 21                     # an allocator's base: 512-byte blocks
COEFFS = (0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
TOL_SPEC_BF16 = 2.0 ** -7          # chip_smoke.py's, bf16 application


def _feed(shape, dtype, work=BF16, base=BASE, strides=None):
    if strides is None:
        strides = torch.empty(shape, device="meta").stride()
    return mode1_feed(dtype, work, base, strides, shape)


# the sources mode 1 reads in the benchmark's cells: the 12 MP photo's
# canvas (3000 x 4000 on the 400 px grid at step 300) and the iterate's
# 130 tiles x 3 channels; the flags cells' prefilter tiles (smooth part,
# f32) and the taper's canvas (f32, pad 0), 20 tiles a photo, 8 photos a
# call in batch8
CELL_SOURCES = {
    "photo12mp_bf16 canvas": ((1, 3, 3100, 4000), BF16),
    "photo12mp_bf16 iterate": ((130, 3, 400, 400), BF16),
    "photo2mp_flags smooth": ((20, 3, 400, 400), F32),
    "photo2mp_flags taper canvas": ((20, 3, 424, 424), F32),
    "photo2mp_flags batch8 smooth": ((160, 3, 400, 400), F32),
    "photo2mp_flags batch8 taper canvas": ((160, 3, 424, 424), F32),
}


@pytest.mark.parametrize("name", list(CELL_SOURCES))
def test_mode1_feed_takes_tma_for_the_cells_sources(name):
    shape, dtype = CELL_SOURCES[name]
    assert _feed(shape, dtype) == "tma"


@pytest.mark.parametrize("shape, dtype, base, why", [
    ((1, 3, 500, 700), BF16, BASE, "pitch 1400 B"),
    ((1, 3, 700, 500), BF16, BASE, "pitch 1000 B: the 700 x 500 demo"),
    ((4, 3, 400, 402), F32, BASE, "pitch 1608 B"),
    ((1, 3, 3100, 4000), BF16, BASE + 2, "base one bf16 past a block"),
    ((20, 3, 400, 400), F32, BASE + 4, "base one f32 past a block"),
])
def test_mode1_feed_gathers_off_a_block(shape, dtype, base, why):
    assert _feed(shape, dtype, base=base) == "gather", why


def test_mode1_feed_gathers_for_a_channel_or_image_stride_off_a_block():
    """Planes 4 elements apart past their rows (8 bytes in bf16)."""
    plane = 101 * 104 + 4
    assert _feed((2, 3, 101, 104), BF16,
                 strides=(3 * plane, plane, 104, 1)) == "gather"
    assert _feed((2, 1, 101, 104), BF16,
                 strides=(plane, plane, 104, 1)) == "gather"
    assert _feed((2, 3, 101, 104), F32,
                 strides=(3 * plane, plane, 104, 1)) == "tma"


def test_mode1_feed_ignores_the_strides_it_never_steps():
    """A single image's or channel's stride is never stepped: any value
    leaves the feed to the rest."""
    assert _feed((1, 1, 400, 400), BF16, strides=(7, 5, 400, 1)) == "tma"
    assert _feed((2, 1, 400, 400), BF16,
                 strides=(160000, 3, 400, 1)) == "tma"
    assert _feed((2, 1, 400, 400), BF16, strides=(3, 3, 400, 1)) == "gather"


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_mode1_feed_gathers_for_an_f32_work_dtype(dtype):
    """The f32 work dtype's 3xTF32 kernel and 'highest' keep the gather."""
    assert _feed((130, 3, 400, 400), dtype, work=F32) == "gather"


def test_mode1_feed_gathers_for_other_dtypes():
    assert _feed((2, 3, 400, 400), torch.float16) == "gather"


def test_mode1_feed_of_a_view_follows_its_tensor():
    """The rule reads what a TileView's tensor shows: its storage offset
    moves the base, a slice of columns keeps the parent's pitch."""
    buf = torch.zeros(2 * 3 * 64 * 72 + 8, dtype=BF16)
    x = buf[:-8].view(2, 3, 64, 72)
    for data, want in [(x, "tma"), (x[..., 4:68], "gather"),
                       (x[..., 8:72], "tma"),
                       (buf[1:-7].view(x.shape), "gather")]:
        assert mode1_feed(data.dtype, BF16, data.data_ptr(), data.stride(),
                          data.shape) == want


def test_spectral_poly_plain_taper_fills_rounded():
    """On the CPU (the plain version) the taper's ``rounded`` canvas gets
    the output rounded to bf16, and ``view1`` is the same tiles: the
    output is unmoved."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 3, 40, 48), generator=g)
    tabs = stage_tables(40, 48, BF16, "cpu")
    q2 = _spectrum("cpu", 2, tabs, 4)
    h, wc = tabs.h, tabs.wc
    av = torch.rand((2, h), generator=g)
    ah = torch.rand((2, wc), generator=g)
    want = spectral_poly(TileView.of_tiles(x), q2, tabs, None, clip=False,
                         crop=0, out_dtype=F32, taper=(av, ah))
    xr = torch.empty((2, 3, h, wc), dtype=BF16)
    got = spectral_poly(TileView.of_tiles(x), q2, tabs, None, clip=False,
                        crop=0, out_dtype=F32, taper=(av, ah), rounded=xr,
                        view1=TileView.of_tiles(x.to(BF16)))
    assert torch.equal(got, want)
    assert torch.equal(xr, want.to(BF16))


@pytest.mark.parametrize("ph, pw, pad", [(400, 400, HALF), (280, 240, 0),
                                         (106, 104, HALF)])
def test_fwd_shifts_are_the_table_moved(ph, pw, pad):
    """Copy d of the TMA feed's A is ``fwd_t`` moved d columns right, with
    zeros around it: copy 0 is ``fwd_t`` as the gather reads it."""
    tabs = stage_tables(ph, pw, BF16, "cpu", pad)
    wc = tabs.wc
    shifts = fwd_shifts(wc, BF16, "cpu")
    assert shifts.shape[:2] == (SHIFTS, tabs.fwd_t.shape[0])
    assert shifts.shape[2] % 64 == 0 and shifts.shape[2] >= wc + SHIFTS - 1
    k = tabs.fwd_t.shape[1]
    assert torch.equal(shifts[0, :, :k], tabs.fwd_t)
    for d in range(SHIFTS):
        assert torch.equal(shifts[d, :, d:d + wc], tabs.fwd_t[:, :wc])
        assert not shifts[d, :, :d].any()
        assert not shifts[d, :, d + wc:].any()


@pytest.mark.parametrize("d", range(SHIFTS))
def test_shifted_product_sums_the_same_products(d):
    """The TMA feed's product: stage column k holds pad(x)'s column k - d
    (zeros left of 0 and from wc on, as the producer warp writes them), A
    copy d of the shifted table; in exact arithmetic the gather's R^T."""
    tabs = stage_tables(106, 104, BF16, "cpu", HALF)
    wc = tabs.wc
    g = torch.Generator().manual_seed(d)
    x = torch.rand((1, 3, 106, 104), generator=g).to(BF16).double()
    xp = replicate_pad(x[0], (HALF,) * 4)                 # (3, h, wc)
    ft = tabs.fwd_t.double()[:, :wc]
    want = torch.einsum("ik,cjk->cij", ft, xp)
    shifted = fwd_shifts(wc, BF16, "cpu")[d].double()
    stage = torch.zeros(xp.shape[:2] + (shifted.shape[1],),
                        dtype=torch.float64)
    stage[..., d:d + wc] = xp
    got = torch.einsum("ik,cjk->cij", shifted, stage)
    assert torch.allclose(got, want, rtol=0, atol=1e-9)


# ---------------------------------------------------------------- CUDA

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _off_block(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose base lies one element past a 16-byte block:
    the same values on the gather."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _photo(dev, shape, dtype, seed):
    """Smooth random planes in [0, 1] of ``shape`` (N, C, H, W)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n, c, h, w = shape
    x = torch.rand((n, c, h // 8 + 2, w // 8 + 2), generator=g)
    x = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                        align_corners=False)
    x = x + 0.02 * torch.rand(shape, generator=g)
    return x.clamp(0.0, 1.0).to(device=dev, dtype=dtype)


def _both_feeds(view: TileView, run):
    """``run(view)`` on the view as given and on its off-block copy, with
    the feeds each counted: ((out, feeds), (out, feeds))."""
    res = []
    for v in (view, view._replace(data=_off_block(view.data))):
        before = dict(pcuda.feeds)
        out = run(v)
        torch.cuda.synchronize()
        res.append((out, {k: pcuda.feeds[k] - before.get(k, 0)
                          for k in ("tma", "gather")}))
    return res


def _assert_byte_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


# (name, source (N, C, H, W) and dtype, TileView grid (batch, tiles_w,
# step) or None for the planes themselves, tile, pad)
APPLICATIONS = [
    ("12mp canvas tiles", (1, 3, 1000, 1600), BF16, (1, 5, (300, 300)),
     (400, 400), HALF),
    ("iterate planes", (6, 3, 400, 400), BF16, None, (400, 400), HALF),
    ("f32 prefilter tiles", (6, 3, 400, 400), F32, None, (400, 400), HALF),
    ("taper canvas pad 0", (4, 3, 424, 424), F32, None, (424, 424), 0),
    ("ragged N", (3, 3, 200, 328), BF16, None, (200, 328), HALF),
    ("margin across row tiles", (2, 3, 106, 104), BF16, None, (106, 104),
     HALF),
    ("margin across row tiles f32", (2, 3, 106, 104), F32, None, (106, 104),
     HALF),
]


# the sources whose every tile's padded origin lies on a 16-byte block
ALIGNED = ("f32 prefilter tiles", "taper canvas pad 0",
           "margin across row tiles f32")


def _shifts(view: TileView, pad: int) -> list:
    """Per tile, the columns its TMA boxes start left of its padded origin
    (the nearest 16-byte block of the source)."""
    per_block = 16 // view.data.element_size()
    out = []
    for n in range(view.n):
        t = view.tile0 + n // view.batch
        x = (t % view.tiles_w) * view.step[1] - pad
        out.append(x % per_block)
    return out


def _spectrum(dev, n, tabs, seed):
    """(n, h, 2 kp) f32 spectra of random per-tile blurs."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(np.stack([rng.uniform(0.2, 0.6, n),
                               rng.uniform(-0.1, 0.1, n),
                               rng.uniform(0.2, 0.6, n)], -1)
                     .astype(np.float32), device=dev)
    coeffs = _mega_pack(*COEFFS, device=dev)
    return spectrum_plain(q[:, 0], q[:, 1], q[:, 2], coeffs, tabs)


@pytest.mark.parametrize("name, shape, dtype, grid, tile, pad", APPLICATIONS,
                         ids=[a[0] for a in APPLICATIONS])
def test_cuda_mode1_feeds_byte_equal(cuda_dev, name, shape, dtype, grid,
                                     tile, pad):
    data = _photo(cuda_dev, shape, dtype, 7)
    if grid is None:
        view = TileView.of_tiles(data)
    else:
        b, tw, step = grid
        th = (shape[2] - tile[0]) // step[0] + 1
        view = TileView(data, b, 0, th * tw * b, tw, step, tile)
    # the canvas: the tiles padded by `pad` (pad 0: the tile itself)
    tabs = stage_tables(*tile, BF16, str(cuda_dev), pad)
    q2 = _spectrum(cuda_dev, view.n, tabs, 11)

    def run(v):
        return spectral_poly(v, q2, tabs, clip=False, out_dtype=F32)

    (a, fa), (b, fb) = _both_feeds(view, run)
    assert fa == {"tma": 1, "gather": 0}
    assert fb == {"tma": 0, "gather": 1}
    assert bool(torch.isfinite(a).all())
    want = spectral_poly_plain(view, q2, tabs, clip=False, out_dtype=F32)
    shifts = _shifts(view, pad)
    for i, d in enumerate(shifts):
        if d == 0:  # the same products in the same places: the same bits
            _assert_byte_equal(a[i], b[i])
        else:       # the same products d columns later in K
            assert float((a[i] - want[i]).abs().max()) <= TOL_SPEC_BF16
    assert float((b - want).abs().max()) <= TOL_SPEC_BF16
    if name in ALIGNED:
        assert set(shifts) == {0}


def test_cuda_mode1_feeds_byte_equal_in_the_taper(cuda_dev):
    """The taper's applications: the f32 tile padded onto the canvas, then
    the canvas itself at pad 0, blended in mode 4's epilogue."""
    from polyblur_torch.ops.cuda.features import taper_weights
    from polyblur_torch.pipeline import _unit_horner

    x = _photo(cuda_dev, (4, 3, 400, 400), F32, 8)
    h = wc = 400 + 2 * HALF
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    tabs = stage_tables(400, 400, BF16, str(cuda_dev))
    est = tile_estimate(TileView.of_tiles(x.to(BF16)), coeffs)
    khat2 = kernel_spectrum(est, _unit_horner(str(cuda_dev)), tabs)
    av, ah = taper_weights(est, h, wc)
    outs = []
    # the pipeline's way (TMA; from the second application on, the first
    # product reads the canvas's bf16 copy), and the gather's
    for src in (x, _off_block(x)):
        xc = torch.empty((4, 3, h, wc), device=cuda_dev)
        xr = torch.empty_like(xc, dtype=BF16) if src is x else None
        u, u1, pad = TileView.of_tiles(src), None, HALF
        for _ in range(3):
            before = dict(pcuda.feeds)
            spectral_poly(u, khat2, tabs, xc, pad=pad, crop=0, clip=False,
                          out_dtype=F32, taper=(av, ah), rounded=xr,
                          view1=u1)
            torch.cuda.synchronize()
            feed = "tma" if src is x else "gather"
            assert pcuda.feeds[feed] - before.get(feed, 0) == 1
            if xr is not None:
                _assert_byte_equal(xr, xc.to(BF16))
                u1 = TileView.of_tiles(xr)
            u, pad = TileView.of_tiles(xc if src is x else _off_block(xc)), 0
        outs.append(xc)
    _assert_byte_equal(outs[0], outs[1])


def test_cuda_mode1_feeds_byte_equal_in_fused_polynomial(cuda_dev):
    """``fused_polynomial`` on the overlap-save blocks of a bf16 photo
    (pad 0; the blocked route)."""
    from polyblur_torch.ops import sep_poly
    from polyblur_torch.ops.cuda.sep_poly_fused import fused_polynomial

    x = _photo(cuda_dev, (1, 3, 480, 640), BF16, 9)[0]
    view, _ = sep_poly._block_view(x, HALF)
    rng = np.random.default_rng(5)
    params = torch.tensor(np.stack([rng.uniform(0.2, 0.6, view.n),
                                    rng.uniform(-0.1, 0.1, view.n),
                                    rng.uniform(0.2, 0.6, view.n)], -1)
                          .astype(np.float32), device=cuda_dev)
    coeffs = _mega_pack(*COEFFS, device=cuda_dev)
    (a, fa), (b, fb) = _both_feeds(
        view, lambda v: fused_polynomial(v, params, coeffs))
    assert fa == {"tma": 1, "gather": 0}
    assert fb == {"tma": 0, "gather": 1}
    _assert_byte_equal(a, b)


def test_cuda_deblur_patches_12mp_feeds_by_tma(cuda_dev):
    """A 12 MP photo through the benchmark's main path: every mode-1
    launch (one an iteration) takes the TMA feed."""
    from polyblur_torch.patches import deblur_patches

    x = _photo(cuda_dev, (1, 3, 3000, 4000), F32, 10)
    pcuda.reset_launches()
    out = deblur_patches(x, patch_size=400, overlap=0.25,
                         window_type="kaiser", work_dtype=BF16,
                         out_dtype=F32, method="direct_separable", n_iter=3,
                         c=0.362, b=0.468, alpha=6.0, beta=1.0)
    torch.cuda.synchronize()
    assert dict(pcuda.feeds) == {"tma": 3}
    assert pcuda.launches["spectral_gemm"] == 12
    assert bool(torch.isfinite(out).all())
