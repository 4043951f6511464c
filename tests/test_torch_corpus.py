"""The North star's corpus budgets on polyblur_torch, held against the JAX
package on the CPU (the images, noise seeds and keywords of
tests/test_pipeline.py's corpus gates).

* f32: ``'fft'`` and ``'direct_separable'`` on the four 256 px fixtures
  (tiles route, and the scan route with the tiles route disabled) and
  the twelve 1024 px ``corpus_hr`` cases (blocked route): >= 60 dB from
  JAX's output and from the live reference's ``*_out_fft``, restoration
  strength (PSNR against sharp) within 0.05 dB of JAX's.
* bf16, route by route, against the JAX function of that route:

  - the f32-FFT composition (``remat=True``: the polynomial through
    ``rfft2``, as JAX's CPU route): within JAX's own budget, >= 40 dB from
    its f32 output and strength within 0.2 dB of it, and >= 40 dB from
    JAX's CPU bf16 output;
  - the tiles route (bf16 DFT operands, as the TPU kernel): strength
    within 0.02 dB of JAX's mega kernel in interpret mode, and each
    iteration from the mega kernel's state within one bf16 step of its
    next state (the witness for the one image that misses 0.02 dB);
  - the blocked route (bf16 DFT operands): against the 0.2 dB / 40 dB
    budget, beside JAX's ``fused_polynomial_pallas`` in interpret mode on
    the same overlap-save blocks, which loses as much.

Where a kernel route breaks a budget and JAX's kernel breaks it too, the
case is a strict xfail carrying its measured numbers (ROADMAP C.5: the
bf16 DFT operands against the North star's 0.2 dB).
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import polyblur_tpu.ops.sep_poly as jsep
from polyblur_tpu.pipeline import polyblur_core as jax_core
from test_pipeline import _HR_KW, _hr_corpus_case, _hr_corpus_names

from polyblur_torch.pipeline import polyblur_core
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

FIXTURES = ("edges", "texture", "saturation", "lowcontrast")
HR_PATH, HR_NAMES = _hr_corpus_names()
SEP = dict(_HR_KW, method="direct_separable")


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _strict(reason):
    return pytest.mark.xfail(strict=True, reason=reason)


@functools.lru_cache(maxsize=1)
def _fixtures():
    return dict(np.load(os.path.join(os.path.dirname(__file__), "data",
                                     "corpus_fixtures.npz")))


@functools.lru_cache(maxsize=1)
def _hr_cases():
    """(sharp (H, W, 3), blurred (1, 3, H, W)) per name, drawn in order from
    one generator as tests/test_pipeline.py draws them."""
    rng = np.random.default_rng(42)
    cases = {}
    for i, name in enumerate(HR_NAMES):
        sharp, blurred = _hr_corpus_case(HR_PATH, name, i, rng)
        cases[name] = (sharp, np.ascontiguousarray(
            blurred.transpose(2, 0, 1)[None]))
    return cases


def _case(name):
    """(x (1, C, H, W) f32, strength: array (1, C, H, W) -> dB, the live
    reference's fft output or None)."""
    if name in FIXTURES:
        fx = _fixtures()
        sharp = fx[f"{name}_sharp"]
        return (fx[f"{name}_in"][None, None].astype(np.float32),
                lambda o: _psnr(np.asarray(o)[0, 0], sharp),
                fx[f"{name}_out_fft"][None])
    sharp, x = _hr_cases()[name]
    return x, lambda o: _psnr(np.asarray(o)[0].transpose(1, 2, 0), sharp), None


def _port(x, dtype=torch.float32, **kw):
    """(output as f32 numpy, the set of dispatch records of the call)."""
    reset_dispatch_log()
    out = polyblur_core(torch.as_tensor(x).to(dtype), device="cpu", **kw)
    return out.float().numpy(), frozenset(dispatch_log())


def _jax(x, dtype=jnp.float32, **kw):
    return np.asarray(jax_core(jnp.asarray(x).astype(dtype), **kw)
                      .astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _port_route(name, method, disable_mega=False):
    """The port's f32 output and its dispatch records."""
    return _port(_case(name)[0], **dict(SEP, method=method),
                 _disable_mega=disable_mega)


def _port_f32(name, method, disable_mega=False):
    return _port_route(name, method, disable_mega)[0]


@functools.lru_cache(maxsize=None)
def _jax_f32(name, method):
    return _jax(_case(name)[0], **dict(SEP, method=method))


@functools.lru_cache(maxsize=None)
def _port_bf16_route(name, **kw):
    return _port(_case(name)[0], torch.bfloat16, **SEP, **kw)


def _port_bf16(name, **kw):
    return _port_bf16_route(name, **kw)[0]


def _jax_blocked_kernel(x, dtype):
    """JAX's scan route with its blocked route's kernel: the polynomial of
    every canvas through ``_blocked_polynomial`` — the overlap-save blocks
    of ``_plan_block_grid`` through ``fused_polynomial_pallas`` in
    interpret mode — where the CPU takes ``_spectral2d`` (the TPU's route
    for these 1048 px canvases)."""
    def blocked(canvas, a, b, c, horner, half):
        return jsep._blocked_polynomial(canvas, a, b, c, horner, half,
                                        interpret=True)

    plain = jsep._spectral2d
    jsep._spectral2d = blocked
    jax.clear_caches()
    try:
        return _jax(x, dtype, **SEP)
    finally:
        jsep._spectral2d = plain
        jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _jax_blocked(name):
    """(f32, bf16) outputs of :func:`_jax_blocked_kernel`."""
    x = _case(name)[0]
    return (_jax_blocked_kernel(x, jnp.float32),
            _jax_blocked_kernel(x, jnp.bfloat16))


# ----------------------------------------------------------------- f32

@pytest.mark.parametrize("route", ["fft", "tiles", "scan"])
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_f32_matches_jax_and_reference(name, route):
    x, strength, ref = _case(name)
    method = "fft" if route == "fft" else "direct_separable"
    got, log = _port_route(name, method, route == "scan")
    want = {"fft": "scan/fft", "tiles": "tiles",
            "scan": "scan/direct_separable"}[route]
    assert ("polyblur_core", want) in log
    jax_out = _jax_f32(name, method)
    assert _psnr(got, jax_out) >= 60.0
    assert _psnr(got, ref) >= 60.0
    assert abs(strength(got) - strength(jax_out)) < 0.05


@pytest.mark.parametrize("method", ["fft", "direct_separable"])
@pytest.mark.parametrize("name", HR_NAMES)
def test_hr_f32_matches_jax(name, method):
    _, strength, _ = _case(name)
    got, log = _port_route(name, method)
    if method == "direct_separable":
        assert ("compute_polynomial_separable", "blocked") in log
    jax_out = _jax_f32(name, method)
    assert _psnr(got, jax_out) >= 60.0
    assert abs(strength(got) - strength(jax_out)) < 0.05


# ------------------------------------------------- bf16: f32-FFT route

@pytest.mark.parametrize("name", FIXTURES + tuple(HR_NAMES))
def test_bf16_fft_composition_keeps_the_budget(name):
    """The route of JAX's CPU bf16 gates: the bf16 state, the polynomial
    through an f32 ``rfft2`` (the port's under ``remat``)."""
    x, strength, _ = _case(name)
    got, log = _port_bf16_route(name, remat=True)
    assert ("compute_polynomial_separable", "xla_sep") in log
    f32 = _port_f32(name, "direct_separable")
    assert _psnr(got, f32) >= 40.0
    assert abs(strength(got) - strength(f32)) < 0.2
    assert _psnr(got, _jax(x, jnp.bfloat16, **SEP)) >= 40.0


# -------------------------------------------------- bf16: tiles route

# measured on the CPU: the port's tiles route and JAX's mega kernel in
# interpret mode, bf16 against f32 (dB of strength, negative: bf16 is the
# stronger)
_TILES_LOSS = {"edges": (0.0341, 0.0416), "texture": (0.0103, 0.0045),
               "saturation": (-0.3307, -0.3352),
               "lowcontrast": (-0.1560, -0.1881)}


@functools.lru_cache(maxsize=None)
def _mega_interpret(name, dtype):
    return _jax(_case(name)[0], dtype, _mega_interpret=True, **SEP)


@pytest.mark.parametrize("name", [
    n if n != "lowcontrast" else pytest.param(n, marks=_strict(
        "lowcontrast: the port's bf16 strength 0.032 dB from the mega "
        "kernel's (losses -0.156 / -0.188 dB against each one's f32; the "
        "two bf16 outputs agree at 61.8 dB). Inherited: the first "
        "iteration rounds 10 near-tie pixels one bf16 step apart, which "
        "move the third iteration's "
        "directional maximum; the mega kernel started from the port's "
        "first state lands 0.004 dB from the port "
        "(test_tiles_route_bf16_gap_is_the_first_iterations_ties), "
        "ROADMAP C.5"))
    for n in FIXTURES])
def test_tiles_route_bf16_strength_matches_mega_kernel(name):
    _, strength, _ = _case(name)
    got, log = _port_bf16_route(name)
    assert ("polyblur_core", "tiles") in log
    mega = _mega_interpret(name, jnp.bfloat16)
    assert abs(strength(got) - strength(mega)) <= 0.02


def _tiles_bf16(x, n_iter, which):
    """``n_iter`` bf16 tiles-route iterations from the state ``x``: the
    port's (``which='port'``) or the mega kernel's in interpret mode."""
    kw = dict(SEP, n_iter=n_iter)
    if which == "port":
        return _port(np.array(x), torch.bfloat16, **kw)[0]
    return _jax(x, jnp.bfloat16, _mega_interpret=True, **kw)


@pytest.mark.parametrize("name", FIXTURES)
def test_tiles_route_bf16_gap_is_the_first_iterations_ties(name):
    """The witness that the tiles route's bf16 gap to the mega kernel is
    the kernel's own rounding, not another order of the port's: (1) one
    iteration from each of the mega kernel's states gives its next state
    at >= 65 dB, no pixel more than one bf16 step of [0.5, 1) (2^-8)
    apart (near-ties that the f32 sums, in another order, round the other
    way; measured 71.2-94.6 dB); (2) the mega kernel started from the
    port's first state ends within 0.02 dB of the port's run (measured
    4.0e-4 to 4.4e-3 dB), so whatever separates the two full runs was
    decided in the first iteration's ties."""
    x, strength, _ = _case(name)
    n = SEP["n_iter"]
    state = x
    for k in range(n):
        mega = _tiles_bf16(state, 1, "mega")
        port = _tiles_bf16(state, 1, "port")
        assert np.abs(port - mega).max() <= 2.0 ** -8, k
        assert _psnr(port, mega) >= 65.0, k
        state = mega
    mega_from_port = _tiles_bf16(_tiles_bf16(x, 1, "port"), n - 1, "mega")
    assert abs(strength(mega_from_port) - strength(_port_bf16(name))) <= 0.02


@pytest.mark.parametrize("name", [
    n if n != "saturation" else pytest.param(n, marks=_strict(
        "saturation: bf16 strength 0.331 dB from f32 (40.34 dB); JAX's mega "
        "kernel in interpret mode 0.335 dB (40.37 dB): the bf16 DFT "
        "operands, inherited, ROADMAP C.5"))
    for n in FIXTURES])
def test_tiles_route_bf16_budget(name):
    """The North star's bf16 budget on the tiles route, and JAX's mega
    kernel's own loss beside it."""
    _, strength, _ = _case(name)
    got = _port_bf16(name)
    f32 = _port_f32(name, "direct_separable")
    mega_loss = (strength(_mega_interpret(name, jnp.float32))
                 - strength(_mega_interpret(name, jnp.bfloat16)))
    assert abs(mega_loss - _TILES_LOSS[name][1]) < 2e-3
    assert _psnr(got, f32) >= 40.0
    assert abs(strength(got) - strength(f32)) < 0.2


# ------------------------------------------------- bf16: blocked route

# measured on the CPU, the port's blocked route in bf16 against its f32:
# (strength loss dB, agreement dB); JAX's kernel on the same blocks beside
_BLOCKED = {
    "deadleaves_coarse": ((0.331, 43.08), (0.330, 43.08)),
    "mosaic_coarse": ((0.095, 39.76), (0.095, 39.78)),
    "mosaic_mixed": ((0.144, 39.97), (0.240, 39.37)),
    "peacock_tiled": ((0.252, 42.70), (0.252, 42.70)),
    "spectrum_13f": ((0.518, 39.50), (0.506, 39.47)),
    "spectrum_1f": ((0.285, 40.68), (0.289, 40.70)),
}


def _blocked_case(name):
    if name not in _BLOCKED:
        return name
    (loss, agree), (kloss, kagree) = _BLOCKED[name]
    return pytest.param(name, marks=_strict(
        f"{name}: bf16 strength {loss} dB from f32, {agree} dB agreement; "
        f"JAX's fused_polynomial_pallas in interpret mode on the same "
        f"blocks {kloss} dB, {kagree} dB: the bf16 DFT operands, "
        f"inherited, ROADMAP C.5"))


@pytest.mark.parametrize("name", [_blocked_case(n) for n in HR_NAMES])
def test_blocked_route_bf16_budget(name):
    _, strength, _ = _case(name)
    got, log = _port_bf16_route(name)
    assert ("compute_polynomial_separable", "blocked") in log
    f32 = _port_f32(name, "direct_separable")
    assert _psnr(got, f32) >= 40.0
    assert abs(strength(got) - strength(f32)) < 0.2


@pytest.mark.parametrize("name", sorted(_BLOCKED) + ["deadleaves_fine"])
def test_blocked_route_bf16_loss_is_the_jax_kernels(name):
    """JAX's blocked kernel in interpret mode on the same photo — each
    photo where the port breaks the 0.2 dB / 40 dB budget, and one where
    it keeps it: its f32 output is the port's to >= 60 dB, its bf16 output
    within 40 dB of the port's, and where the port breaks the budget,
    JAX's kernel breaks it too."""
    _, strength, _ = _case(name)
    got32, got16 = _port_f32(name, "direct_separable"), _port_bf16(name)
    k32, k16 = _jax_blocked(name)
    assert _psnr(got32, k32) >= 60.0
    assert _psnr(got16, k16) >= 40.0

    def breaks(o16, o32):
        return (_psnr(o16, o32) < 40.0
                or abs(strength(o16) - strength(o32)) >= 0.2)

    assert breaks(k16, k32) or not breaks(got16, got32)
    assert breaks(got16, got32) == (name in _BLOCKED)
