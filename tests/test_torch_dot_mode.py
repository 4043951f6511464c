"""The f32 dot mode of polyblur_torch against the JAX package's, on the CPU.

``set_f32_dot_mode`` / ``f32_dot_mode`` / ``f32_dot_mode_scope`` select the
f32 instantiations of the port's tensor-core GEMMs (``spectral_gemm``, the
estimate's and the halo's derivative GEMM): ``'compensated'`` (3xTF32) or
``'highest'`` (a three-piece tf32 split, six products). The kernels run
only on the card (``chip_smoke.py`` phase (p) holds them to their plain
versions there); here:

* (i) the three names and their semantics, held to the JAX package's;
* (ii) the port's f32 tiles and patch routes (their plain versions) against
  JAX's mega kernel in interpret mode under each mode: atol 1e-4 and
  >= 60 dB under ``'highest'``, >= 60 dB under ``'compensated'`` (JAX's
  bf16x3 split against the port's exact f32);
* (iii) the dispatch: one instantiation for bf16 and for
  ``directional_maxima`` under both modes, two for f32, and the host
  tables split into as many pieces as the mode's case reads;
* (iv) a CPU emulation of the split (tf32 rounding by bit arithmetic, as
  tests/test_torch_estimate_precision.py does) at the DFT GEMM's and the
  derivative GEMM's shapes: each piece product is exact in f32 on the
  tensor cores, so the products are summed in float64 to isolate the
  split from the accumulation. Against float64, the six-product split's
  error is within 2x of a plain f32 matmul's; 3xTF32's is larger; and
  3xTF32 with lo lo added is no better than 3xTF32 (its lo already leaves
  ~2^-22).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.ops.pallas.polyblur_fused import polyblur_tiles_fused
from polyblur_tpu.patches import deblur_patches as jax_deblur

import polyblur_torch
import polyblur_torch.pipeline as tpipe
from polyblur_torch.ops.cuda import est_fused
from polyblur_torch.ops.cuda.polyblur_fused import (_split_tf32, _tf32,
                                                    estimate_tables,
                                                    stage_tables)
from polyblur_torch.ops.cuda.sep_poly_fused import dot_variant
from polyblur_torch.utils.imaging import replicate_pad

NAMES = ("set_f32_dot_mode", "f32_dot_mode", "f32_dot_mode_scope")
MODES = ("compensated", "highest")
BASE = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
            method="direct_separable")


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _scopes(mode):
    """Both packages' scopes for ``mode``, as one context."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(polyblur_tpu.f32_dot_mode_scope(mode))
    stack.enter_context(polyblur_torch.f32_dot_mode_scope(mode))
    return stack


# ------------------------------------------------------------------ (i)

@pytest.mark.parametrize("pkg", [polyblur_torch, polyblur_tpu],
                         ids=["torch", "jax"])
def test_names_and_semantics(pkg):
    assert set(NAMES) <= set(pkg.__all__)
    assert pkg.f32_dot_mode() == "compensated"          # the default
    pkg.set_f32_dot_mode("highest")
    try:
        assert pkg.f32_dot_mode() == "highest"
    finally:
        pkg.set_f32_dot_mode("compensated")
    with pytest.raises(ValueError, match="unknown f32 dot mode 'fast'; "
                                         "expected 'compensated' or "
                                         "'highest'"):
        pkg.set_f32_dot_mode("fast")
    assert pkg.f32_dot_mode() == "compensated"
    with pytest.raises(RuntimeError):
        with pkg.f32_dot_mode_scope("highest"):
            assert pkg.f32_dot_mode() == "highest"
            raise RuntimeError("inside the scope")
    assert pkg.f32_dot_mode() == "compensated"          # restored
    with pytest.raises(ValueError):
        with pkg.f32_dot_mode_scope("HIGHEST"):
            pass
    assert pkg.f32_dot_mode() == "compensated"


def test_every_jax_public_name_is_ported():
    assert set(polyblur_tpu.__all__) <= set(polyblur_torch.__all__)
    for name in NAMES:
        assert callable(getattr(polyblur_torch, name))


# ------------------------------------------------------------------ (ii)

@pytest.mark.parametrize("mode", MODES)
def test_tiles_route_vs_mega_interpret(mode):
    x = np.random.default_rng(50).uniform(
        size=(1, 3, 97, 141)).astype(np.float32)
    coeffs = jpipe._mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    with _scopes(mode):
        got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu",
                                  **BASE).numpy()
        mega = np.asarray(polyblur_tiles_fused(jnp.asarray(x), coeffs, 2,
                                               interpret=True))
    assert _psnr(got, mega) >= 60.0
    if mode == "highest":
        np.testing.assert_allclose(got, mega, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_patch_route_vs_mega_interpret(mode):
    img = np.random.default_rng(30).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    grid = dict(patch_size=160, overlap=32.0 / 160.0)
    with _scopes(mode):
        got = polyblur_torch.deblur_patches(
            torch.as_tensor(img), device="cpu", out_dtype=torch.float32,
            **grid, **BASE).numpy()
        mega = np.asarray(jax_deblur(jnp.asarray(img), _mega_interpret=True,
                                     out_dtype=jnp.float32, **grid, **BASE))
    assert got.shape == mega.shape == img.shape
    assert _psnr(got, mega) >= 60.0
    if mode == "highest":
        np.testing.assert_allclose(got, mega, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ (iii)

def test_dispatch_codes_by_dtype_and_mode():
    codes = {}
    for mode in MODES:
        with polyblur_torch.f32_dot_mode_scope(mode):
            codes[mode] = (dot_variant(torch.bfloat16),
                           dot_variant(torch.float32),
                           dot_variant(torch.float32, mode_free=True))
    assert codes["compensated"][0] == codes["highest"][0]   # bf16: one
    assert codes["compensated"][1] != codes["highest"][1]   # f32: two
    assert codes["compensated"][2] == codes["highest"][2]   # mode-free
    assert codes["compensated"] == (0, 0, 0)


def test_directional_maxima_is_mode_free(monkeypatch):
    """The wrapper asks for the mode-free instantiation (JAX's
    est_fused.py:52-56 does not read the mode): its launch, intercepted,
    gets the same code under both modes."""
    seen = []

    def launch(view, stages, name, coeffs=None, n_angles=6,
               mode_free=False):
        seen.append(dot_variant(view.data.dtype, mode_free))
        return torch.zeros(view.n, n_angles + 1), None

    monkeypatch.setattr(est_fused, "runs_plain", lambda t: False)
    monkeypatch.setattr(est_fused, "launch_estimate", launch)
    img = torch.rand(1, 3, 48, 64)
    for mode in MODES:
        with polyblur_torch.f32_dot_mode_scope(mode):
            est_fused.directional_maxima(img)
    assert seen == [0, 0]


def test_host_tables_split_by_the_mode():
    t2 = estimate_tables(48, 40, "cpu")
    t3 = estimate_tables(48, 40, "cpu", pieces=3)
    assert t2 is not estimate_tables(48, 40, "cpu", pieces=3)
    assert t2.dw2.shape == (2, 40, 64) and t3.dw2.shape == (3, 40, 64)
    assert t3.dh2.shape == (3, 48, 64)
    # the 3xTF32 tables are the two-piece split as before, and the first
    # two pieces of the three-piece one
    np.testing.assert_array_equal(t2.dw2.numpy(),
                                  _split_tf32(t2.dw.numpy()))
    np.testing.assert_array_equal(t3.dw2[:2].numpy(), t2.dw2.numpy())
    d = t3.dw.numpy().astype(np.float64)
    pieces = t3.dw2.numpy()[:, :, :40]
    for p in pieces:  # each piece is a tf32 value
        assert not (p.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.all(np.abs(pieces.astype(np.float64).sum(0) - d)
                  <= np.abs(d) * 2.0 ** -30)
    assert not t3.dw2[:, :, 40:].any()


# ------------------------------------------------------------------ (iv)

def _pieces(a: np.ndarray, n: int):
    out, r = [], np.asarray(a, np.float32)
    for _ in range(n):
        p = _tf32(r)
        out.append(p.astype(np.float64))
        r = r - p
    return out


def _split_product(a, b, n, terms):
    """sum of A_i B_j over ``terms`` (piece indices, 0 = hi), each product
    exact and the sum in float64."""
    ap, bp = _pieces(a, n), _pieces(b, n)
    return sum(ap[i] @ bp[j] for i, j in terms)


def _operands(shape: str):
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(448, 448)).astype(np.float32)
    if shape == "dft":
        # the first DFT GEMM of a 448 px tile: the 472^2 padded canvas
        # against the packed x-rDFT table (472 x 2 kp)
        t = stage_tables(448, 448, torch.float32, "cpu")
        xc = replicate_pad(torch.as_tensor(img)[None], (12,) * 4)[0]
        return xc.numpy(), t.fwd_t[:, :t.wc].numpy().T.copy()
    t = estimate_tables(448, 448, "cpu")
    return img, t.dw.numpy().T.copy()          # gx = g Dw^T


@pytest.mark.parametrize("shape", ["dft", "derivative"])
def test_six_product_split_is_f32_grade(shape):
    a, b = _operands(shape)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()

    def err(v):
        return float(np.abs(np.asarray(v, np.float64) - exact).max() / scale)

    plain = err(a @ b)                                   # f32 matmul
    x3 = err(_split_product(a, b, 2, [(0, 1), (1, 0), (0, 0)]))
    x3_lolo = err(_split_product(a, b, 2, [(1, 1), (0, 1), (1, 0), (0, 0)]))
    x6 = err(_split_product(a, b, 3, [(2, 0), (0, 2), (1, 1), (1, 0),
                                      (0, 1), (0, 0)]))
    assert x6 <= 2.0 * plain
    assert x3 > 100.0 * x6
    assert x3_lolo >= 0.5 * x3
