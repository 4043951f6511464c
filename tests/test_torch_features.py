"""polyblur_torch feature flags (prefilter, edgetaper, halo removal) vs the
JAX package on CPU.

The port's plain path (every kernel wrapper's plain PyTorch version, taken
for CPU tensors) against the JAX package's own functions, run as its tests
run them: Pallas kernels in interpret mode under full-f32 dots, or their
XLA references. Inputs are made with numpy from a seed or read from
tests/data. Tolerances, stated per test:

* single operators (bilateral, IIR, recursive filter, edgetaper, halo):
  atol 1e-5 (f32 round-off of the same arithmetic; the Hillis-Steele scan
  is the same algorithm as the Pallas kernel);
* the tiles route vs the mega kernel in interpret mode: atol 1e-4 and
  >= 60 dB (the parity policy; the stages agree to ~2e-6);
* the scan route vs the JAX ``polyblur_core``: >= 60 dB;
* the staged patch route vs ``deblur_patches(_mega_interpret=True)``:
  atol 3e-4 (as tests/test_patches.py:325-350), bf16 >= 40 dB.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.ops.pallas.polyblur_fused import polyblur_tiles_fused
from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope

import polyblur_torch.pipeline as tpipe
from polyblur_torch import PolyblurDeblurring, deblur_patches
from polyblur_torch.ops.cuda.polyblur_fused import TileView
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

BASE = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0)
FULL = dict(remove_halo=True, edgetaping=True, prefiltering=True)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _crop(peacock, y, x, h, w):
    return np.ascontiguousarray(
        peacock[y:y + h, x:x + w, :3].transpose(2, 0, 1)[None], np.float32)


# ------------------------------------------------------------- operators

def test_bilateral_plain_matches_pallas_and_xla(peacock):
    from polyblur_tpu.ops.bilateral import _bilateral_xla
    from polyblur_tpu.ops.pallas.bilateral import bilateral_pallas

    from polyblur_torch.ops.bilateral import bilateral_filter
    from polyblur_torch.ops.cuda.bilateral import bilateral

    x = np.concatenate([_crop(peacock, 50, 80, 40, 56),
                        _crop(peacock, 300, 400, 40, 56)])
    reset_dispatch_log()
    got = bilateral_filter(torch.as_tensor(x)).numpy()
    assert dispatch_log() == {("bilateral_filter", "cuda"): 1}
    pallas = np.asarray(bilateral_pallas(jnp.asarray(x), interpret=True))
    xla = np.asarray(_bilateral_xla(jnp.asarray(x), 5, 5.0, 0.1))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)
    # the tiles-route stage: f32 smooth and noise from a TileView
    smooth, noise = bilateral(TileView.of_tiles(torch.as_tensor(x)),
                              out_dtype=torch.float32, with_noise=True)
    np.testing.assert_allclose(smooth.numpy(), pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(noise.numpy(), x - pallas, atol=1e-5, rtol=0)


def test_iir_scan_rows_matches_jax_and_pallas():
    from polyblur_tpu.ops.domain_transform import iir_scan_rows as jscan
    from polyblur_tpu.ops.pallas.iir import iir_scan_rows_pallas

    from polyblur_torch.ops.cuda.iir import scan_cols
    from polyblur_torch.ops.domain_transform import iir_scan_rows

    rng = np.random.default_rng(60)
    x = rng.uniform(size=(2, 3, 16, 100)).astype(np.float32)
    v = rng.uniform(0.0, 0.95, size=x.shape).astype(np.float32)
    got = iir_scan_rows(torch.as_tensor(x), torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jscan(jnp.asarray(x),
                                                     jnp.asarray(v))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(iir_scan_rows_pallas(
        jnp.asarray(x), jnp.asarray(v), interpret=True)), atol=1e-5, rtol=0)
    # the column pass is the row scan of the transposed planes, one map
    # shared by a tile's channels
    vs = v[:, 0]
    cols = scan_cols(torch.as_tensor(x).clone(), torch.as_tensor(vs)).numpy()
    vb = jnp.broadcast_to(jnp.asarray(vs)[:, None], x.shape)
    want = np.swapaxes(np.asarray(jscan(
        jnp.swapaxes(jnp.asarray(x), -1, -2), jnp.swapaxes(vb, -1, -2))),
        -1, -2)
    np.testing.assert_allclose(cols, want, atol=1e-5, rtol=0)


def test_recursive_filter_matches_jax(peacock):
    from polyblur_tpu.ops import domain_transform as jdt

    from polyblur_torch.ops import domain_transform as tdt

    x = _crop(peacock, 120, 200, 48, 64)
    for kw in (dict(), dict(sigma_s=2.0, sigma_r=0.8, num_iterations=1)):
        got = tdt.recursive_filter(torch.as_tensor(x), **kw).numpy()
        want = np.asarray(jdt.recursive_filter(jnp.asarray(x), backend="xla",
                                               **kw))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    dh, dv = tdt._domain_transform_derivatives(torch.as_tensor(x), 2.0, 0.8)
    jh, jv = jdt._domain_transform_derivatives(jnp.asarray(x), 2.0, 0.8)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jh), rtol=1e-6)
    np.testing.assert_allclose(dv.transpose(-1, -2).numpy(), np.asarray(jv),
                               rtol=1e-6)
    assert tdt._sigma_schedule(60.0, 3) == jdt._sigma_schedule(60.0, 3)


def test_edgetaper_matches_reference_fixtures(ref):
    from polyblur_torch.edgetaper import edgetaper, edgetaper_alpha

    k = torch.as_tensor(ref["p2o_kernel"])
    alpha = edgetaper_alpha(k, (40, 56))
    np.testing.assert_allclose(alpha.numpy(), ref["edgetaper_alpha"],
                               atol=1e-5, rtol=0)
    out = edgetaper(torch.as_tensor(ref["grad_in"]), k, method="fft")
    np.testing.assert_allclose(out.numpy(), ref["edgetaper_out"], atol=1e-4,
                               rtol=0)


def test_edgetaper_batch2_global_max_matches_jax():
    """Two different kernels in one batch: both packages divide the
    autocorrelations by the batch-global maximum (the reference's quirk),
    for 2D kernels and for (sigma, rho, theta) parameters."""
    from polyblur_tpu import edgetaper as jet

    from polyblur_torch import edgetaper as tet

    rng = np.random.default_rng(61)
    x = rng.uniform(size=(2, 3, 64, 80)).astype(np.float32)
    sg = np.asarray([[2.5], [0.6]], np.float32)
    rh = np.asarray([[0.8], [0.5]], np.float32)
    th = np.asarray([[0.4], [2.0]], np.float32)
    jk = jet._kernels_from_params(*(jnp.asarray(v) for v in (sg, rh, th)), 25)
    tk = tet._kernels_from_params(*(torch.as_tensor(v) for v in (sg, rh, th)),
                                  25)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-7)
    a_t = tet.edgetaper_alpha(tk, (64, 80)).numpy()
    a_j = np.asarray(jet.edgetaper_alpha(jk, (64, 80)))
    np.testing.assert_allclose(a_t, a_j, atol=1e-5, rtol=0)
    # the global max is the narrow kernel's: the wide one is not
    # normalized by its own
    assert not np.allclose(a_t[0], tet.edgetaper_alpha(tk[:1], (64, 80))[0])
    np.testing.assert_allclose(
        tet.edgetaper(torch.as_tensor(x), tk, method="fft").numpy(),
        np.asarray(jet.edgetaper(jnp.asarray(x), jk, method="fft")),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tet.edgetaper(torch.as_tensor(x), tuple(torch.as_tensor(v)
                                                for v in (sg, rh, th))).numpy(),
        np.asarray(jet.edgetaper(jnp.asarray(x), tuple(jnp.asarray(v)
                                                       for v in (sg, rh, th)))),
        atol=1e-5, rtol=0)


def test_halo_masking_matches_jax(peacock):
    from polyblur_tpu.ops.fourier import spectral_gradients as jgrad
    from polyblur_tpu.restoration import halo_masking as jhalo

    from polyblur_torch.ops.fourier import spectral_gradients as tgrad
    from polyblur_torch.restoration import halo_masking as thalo

    x = _crop(peacock, 200, 300, 48, 64)
    rng = np.random.default_rng(62)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    got = thalo(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    want = np.asarray(jhalo(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    g = tgrad(torch.as_tensor(x))
    np.testing.assert_allclose(
        thalo(torch.as_tensor(x), torch.as_tensor(y), g).numpy(),
        np.asarray(jhalo(jnp.asarray(x), jnp.asarray(y), jgrad(jnp.asarray(x)))),
        atol=1e-5, rtol=0)


# ----------------------------------------------------------- tiles route

@pytest.mark.parametrize("flags", [
    dict(edgetaping=True),
    dict(remove_halo=True),
    dict(prefiltering=True, smoother="bilateral"),
    dict(prefiltering=True, smoother="domain_transform"),
    dict(FULL, smoother="domain_transform"),
    dict(FULL, smoother="bilateral"),
], ids=["taper", "halo", "bilateral", "dt", "full-dt", "full-bilateral"])
def test_tiles_route_flags_match_mega_interpret(peacock, flags):
    x = _crop(peacock, 0, 0, 96, 96)
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu",
                              method="direct_separable", **BASE,
                              **flags).numpy()
    assert dispatch_log()[("polyblur_core", "tiles")] == 1
    coeffs = jpipe._mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    prefilter = tpipe.prefilter_of(flags.get("prefiltering", False),
                                   flags.get("smoother", "bilateral"))
    with f32_dot_mode_scope("highest"):
        want = np.asarray(polyblur_tiles_fused(
            jnp.asarray(x), coeffs, 2, do_taper=flags.get("edgetaping", False),
            do_halo=flags.get("remove_halo", False), prefilter=prefilter,
            interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert _psnr(got, want) >= 60.0


# ------------------------------------------------------------ scan route

@pytest.mark.parametrize("method", ["fft", "direct_separable"])
@pytest.mark.parametrize("smoother", ["bilateral", "domain_transform"])
def test_scan_route_full_set_matches_jax(peacock, method, smoother):
    x = _crop(peacock, 100, 100, 120, 160)
    kw = dict(BASE, method=method, smoother=smoother, _disable_mega=True,
              **FULL)
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu", **kw).numpy()
    log = dispatch_log()
    assert log[("polyblur_core", f"scan/{method}")] == 1
    assert log[("inverse_filtering_rank3", f"generic/{method}")] == 2
    want = np.asarray(jpipe.polyblur_core(jnp.asarray(x), **kw))
    assert _psnr(got, want) >= 60.0


def test_scan_route_halo_fast_path_matches_jax(peacock):
    """``remove_halo`` without the taper keeps the fused prepadded
    polynomial and masks after it (restoration.py:146-157)."""
    x = _crop(peacock, 100, 100, 64, 90)
    kw = dict(BASE, method="direct_separable", remove_halo=True,
              _disable_mega=True)
    reset_dispatch_log()
    got = tpipe.polyblur_core(torch.as_tensor(x), device="cpu", **kw).numpy()
    assert dispatch_log()[("inverse_filtering_rank3", "separable_fast")] == 2
    want = np.asarray(jpipe.polyblur_core(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ----------------------------------------------------------- patch route

@pytest.mark.parametrize("smoother", ["bilateral", "domain_transform"])
def test_staged_patches_full_set_match_mega_interpret(smoother):
    import polyblur_tpu.patches as jpatch

    x = np.random.default_rng(30).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    kw = dict(BASE, method="direct_separable", smoother=smoother,
              patch_size=160, overlap=0.2, out_dtype=torch.float32, **FULL)
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(x), device="cpu", **kw).numpy()
    assert dispatch_log() == {("deblur_patches", "staged_tiles"): 1}
    jkw = dict(kw, out_dtype=jnp.float32)
    with f32_dot_mode_scope("highest"):
        want = np.asarray(jpatch.deblur_patches(jnp.asarray(x),
                                                _mega_interpret=True, **jkw))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)


def test_staged_patches_full_set_bf16_matches_mega_interpret():
    import polyblur_tpu.patches as jpatch

    x = np.random.default_rng(31).uniform(
        size=(1, 3, 200, 300)).astype(np.float32)
    kw = dict(BASE, method="direct_separable", smoother="domain_transform",
              patch_size=160, overlap=0.2, **FULL)
    got = deblur_patches(torch.as_tensor(x), device="cpu",
                         work_dtype=torch.bfloat16, out_dtype=torch.float32,
                         **kw).numpy()
    want = np.asarray(jpatch.deblur_patches(
        jnp.asarray(x), _mega_interpret=True, work_dtype=jnp.bfloat16,
        out_dtype=jnp.float32, **kw))
    assert _psnr(got, want) >= 40.0


def test_flags_past_the_tiles_cap_take_the_composed_route():
    """With the dt prefilter the tiles route stops at 512 px
    (``mega_tile_cap``): 520 px tiles take extract -> polyblur_core ->
    blend, as the JAX package does (its mega routes refuse them)."""
    import polyblur_tpu.patches as jpatch

    x = np.random.default_rng(32).uniform(
        size=(1, 3, 520, 520)).astype(np.float32)
    kw = dict(BASE, n_iter=1, method="direct_separable", patch_size=520,
              overlap=0.25, smoother="domain_transform", prefiltering=True,
              edgetaping=True)
    reset_dispatch_log()
    got = deblur_patches(torch.as_tensor(x), device="cpu", **kw).numpy()
    log = dispatch_log()
    assert log[("deblur_patches", "composed")] == 1
    assert log[("polyblur_core", "scan/direct_separable")] == 1
    want = np.asarray(jpatch.deblur_patches(jnp.asarray(x),
                                            _mega_interpret=True, **kw))
    assert _psnr(got, want) >= 60.0


def test_module_whole_image_bilateral_flags_match_jax(peacock):
    """``PolyblurDeblurring``'s defaults (smoother 'bilateral') with every
    flag, through the numpy adapter."""
    import polyblur_tpu.api as japi

    crop = np.ascontiguousarray(peacock[60:180, 100:260, :3])
    kw = dict(n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0, **FULL)
    reset_dispatch_log()
    got = PolyblurDeblurring(device="cpu")(crop, **kw)
    assert dispatch_log()[("polyblur_core", "tiles")] == 1
    want = japi.PolyblurDeblurring()(crop, **kw)
    assert isinstance(got, np.ndarray) and got.shape == crop.shape
    assert _psnr(got, want) >= 60.0


@pytest.mark.parametrize("smoother, error", [
    ("nc", None), ("gaussian", ValueError)])
@pytest.mark.parametrize("route", ["polyblur_core", "deblur_patches"])
def test_routes_validate_the_smoother_alike(route, smoother, error):
    """The scan, tiles and patch routes take the same smoothers: ``'nc'``
    (the normalized convolution, which no kernel route takes: both
    packages compose it) runs and holds the JAX package's output at
    >= 60 dB, any unknown name is an error."""
    call = tpipe.polyblur_core if route == "polyblur_core" else deblur_patches
    x = torch.rand(1, 3, 64, 96, generator=torch.Generator().manual_seed(5))
    kw = dict(method="direct_separable", prefiltering=True,
              smoother=smoother)
    if error is not None:
        with pytest.raises(error, match="unknown smoother"):
            call(x, device="cpu", **kw)
        return
    import polyblur_tpu.patches as jpatch

    got = call(x, device="cpu", **kw).numpy()
    jax_call = (jpipe.polyblur_core if route == "polyblur_core"
                else jpatch.deblur_patches)
    want = np.asarray(jax_call(jnp.asarray(x.numpy()), **kw))
    assert _psnr(got, want) >= 60.0
