"""polyblur_torch's training path against the JAX package, on the CPU.

Gradients with respect to the image and to (c, b, alpha, beta) through the
port (its autograd Functions: the wrappers' forward, autograd of their
plain versions backward) against ``jax.grad`` of the JAX package (its
custom VJPs; the mega kernel in interpret mode), on the three routes:

* the scan route (``polyblur_core``, method 'fft' and the separable route
  with the mega kernel disabled);
* the tiles route (``polyblur_core`` at most 640 px, against
  ``polyblur_tiles_fused`` in interpret mode);
* the patch route (the canvas Function and the blend's, for one image
  against the JAX package's blended route, for two against its DMA
  route with the blend; ``deblur_patches(_mega_interpret=True)``).

Tolerances: image gradients >= 40 dB relative to the peak of JAX's
(``_grad_db``), scalar gradients rtol 1e-3; with and without ``remat`` on
one route atol 1e-6 (as the JAX package's own test). The route taken with
and without ``remat`` matches the JAX package's (``dispatch_log``).
Measured on the CPU (image dB, largest scalar relative error): scan 'fft'
116.8, 9.6e-5; scan separable 109.9, 1.5e-4; tiles 115.2, 1.4e-4; patch
blended 130.0, 3.7e-4; patch DMA + blend 130.5, 3.8e-4; patch under
``remat`` 155.1, 8.6e-5; the tiles route against the scan route it takes
under ``remat`` 120.8, 6.4e-5; ``remat`` on the 'fft' scan route changes
no bit. The min/max normalization's clip passes half the gradient at its
bounds in both packages (``estimation.normalize_range``); with
``clamp``'s whole gradient the darkest and brightest pixels put the
separable scan route at 41-46 dB.

The feature flags (prefilter with either smoother, edgetaper, halo) on
every route: the tiles and canvas Functions, whose backward replays the
scan route on their tiles as one batch (``pipeline._ref_pipeline``), as
the JAX package's custom VJPs do; the scan route through the bilateral
and IIR Functions and, for the domain transform, in ``sigma_s`` /
``sigma_r``; ``remat`` with the flags. Each flag case's tolerance and
measured error are in its test.

Also: each Function's backward against autograd of its plain version
(bit-equal on the CPU), the bilateral and IIR Functions against
``jax.grad`` of the JAX package's XLA compositions, ``fit_layer`` on the
blurred-binary-image problem of the JAX package's training test, the JSON
params in both directions, and the ``torch.save`` checkpoint with Adam
state.

Inputs are crops of the peacock photo (a defocused photo: its estimated
blurs stay inside the model's clamps, so the gradients with respect to c
and b are not zero) and seeded noise.
"""

import contextlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import polyblur_tpu.patches as jpatches
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.utils import profiling as jprof
from polyblur_torch import PolyblurLayer, fit_layer, polyblur_apply
from polyblur_torch import training as ttrain
from polyblur_torch.convert import layer_params_from_jax
from polyblur_torch.ops.cuda.autograd import replay
from polyblur_torch.ops.cuda.overlap_add import (blend_overlap_add,
                                                 blend_overlap_add_plain)
from polyblur_torch.ops.cuda.pad_cast import edge_pad_cast, edge_pad_cast_plain
from polyblur_torch.ops.cuda import _build
from polyblur_torch.ops.bilateral import _bilateral_plain, bilateral_filter
from polyblur_torch.ops.cuda.iir import (scan_cols, scan_cols_plain,
                                         scan_rows, scan_rows_plain)
from polyblur_torch.ops.cuda.polyblur_fused import (TileView,
                                                    _ref_image_pipeline,
                                                    _restore_canvas,
                                                    polyblur_image_fused,
                                                    polyblur_tiles_fused)
from polyblur_torch.ops.cuda.sep_poly_fused import (fused_polynomial,
                                                    fused_polynomial_plain)
from polyblur_torch.patches import (_blend_constants, _grid_steps,
                                    deblur_patches, plan_patch_grid)
from polyblur_torch.pipeline import (_mega_pack, _ref_pipeline,
                                     polyblur_core, restore_tiles)
from polyblur_torch.utils.profiling import dispatch_log, reset_dispatch_log

DATA = os.path.join(os.path.dirname(__file__), "data")
SCALARS = (0.362, 0.468, 6.0, 1.0)          # c, b, alpha, beta
IMAGE_DB = 40.0
SCALAR_RTOL = 1e-3


def _peacock(h, w, channels=3, y=120, x=200, batch=1):
    """(batch, channels, h, w) crops of the photo, image i at row y + 60 i
    (gray: the channel mean)."""
    img = np.asarray(Image.open(os.path.join(DATA, "peacock_defocus.png")))
    img = (img[..., :3] / 255.0).astype(np.float32).transpose(2, 0, 1)
    out = np.stack([img[:, y + 60 * i:y + 60 * i + h, x:x + w]
                    for i in range(batch)])
    return np.ascontiguousarray(out if channels == 3
                                else out.mean(1, keepdims=True))


def _pair(h, w, channels=3, y=120, x=200, batch=1):
    """(input, target): the target is the same crop displaced by (3, 4)
    px, a structured image as a training target is. With a noise target
    the alpha and beta gradients are sums that cancel to ~1e-3 of their
    terms, and their relative agreement (0.3-3% measured) gauges that
    cancellation rather than the port; the image gradients agree to
    89-106 dB there too."""
    return (_peacock(h, w, channels, y, x, batch),
            _peacock(h, w, channels, y + 3, x + 4, batch))


def _grad_db(got, want) -> float:
    """Agreement of two gradient arrays in dB relative to the peak of
    ``want``: 10 log10(max |want|^2 / mean (got - want)^2)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mse = float(np.mean((got - want) ** 2))
    return 10.0 * math.log10(float(np.abs(want).max()) ** 2
                             / max(mse, 1e-300))


def _torch_grads(fn, x, tgt, scalars=SCALARS):
    """(loss, d loss / d image, d loss / d scalars) of the mean squared
    error of ``fn(x, *scalars)`` (c, b, alpha, beta[, sigma_s, sigma_r])
    against ``tgt``; a scalar the route does not read, as sigma_s under
    the bilateral smoother, gets 0."""
    xt = torch.tensor(x, requires_grad=True)
    ps = [torch.tensor(v, requires_grad=True) for v in scalars]
    loss = ((fn(xt, *ps) - torch.as_tensor(tgt)) ** 2).mean()
    g = torch.autograd.grad(loss, [xt] + ps, allow_unused=True)
    return (float(loss.detach()), g[0].numpy(),
            np.array([0.0 if v is None else float(v) for v in g[1:]]))


def _jax_grads(fn, x, tgt, scalars=SCALARS):
    def loss(xx, ps):
        return jnp.mean((fn(xx, *ps) - jnp.asarray(tgt)) ** 2)

    val, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(x), tuple(jnp.float32(v) for v in scalars))
    return float(val), np.asarray(gx), np.array([float(v) for v in gp])


def _assert_grads_match(got, want, image_db=IMAGE_DB, rtol=SCALAR_RTOL):
    (lt, gxt, gpt), (lj, gxj, gpj) = got, want
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert np.isfinite(gxt).all() and np.isfinite(gpt).all()
    assert _grad_db(gxt, gxj) >= image_db, _grad_db(gxt, gxj)
    np.testing.assert_allclose(gpt, gpj, rtol=rtol, atol=0)
    assert (gpj != 0).all(), gpj


def _core_kw(**kw):
    return dict(n_iter=3, **kw)


# ------------------------------------------------------------ the routes

@pytest.mark.parametrize("method, shape", [
    ("fft", (1, 1, 48, 64)),
    ("direct_separable", (1, 3, 40, 56)),
])
def test_scan_route_gradients_match_jax(method, shape):
    """The scan route: the fused maxima (B.1.6) and, for the separable
    method, the prepadded fused polynomial (B.1.5); 'fft' composes
    PyTorch's FFT."""
    x, tgt = _pair(*shape[2:], channels=shape[1])
    kw = _core_kw(method=method, _disable_mega=True)
    got = _torch_grads(lambda v, c, b, a, be: polyblur_core(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **kw), x, tgt)
    want = _jax_grads(lambda v, c, b, a, be: jpipe.polyblur_core(
        v, c=c, b=b, alpha=a, beta=be, **kw), x, tgt)
    _assert_grads_match(got, want)


def test_tiles_route_gradients_match_jax_interpret():
    """The tiles route (B.1.4) against ``polyblur_tiles_fused`` in
    interpret mode through its custom VJP."""
    x, tgt = _pair(48, 64)
    kw = _core_kw(method="direct_separable")
    reset_dispatch_log()
    got = _torch_grads(lambda v, c, b, a, be: polyblur_core(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **kw), x, tgt)
    assert dispatch_log() == {("polyblur_core", "tiles"): 1}
    jprof.reset_dispatch_log()
    want = _jax_grads(lambda v, c, b, a, be: jpipe.polyblur_core(
        v, c=c, b=b, alpha=a, beta=be, _mega_interpret=True, **kw), x, tgt)
    assert ("polyblur_core", "mega_pallas") in jprof.dispatch_log()
    _assert_grads_match(got, want)


@pytest.mark.parametrize("batch, jax_route", [
    (1, "mega_image_blended"), (2, "mega_image_dma")])
def test_patch_route_gradients_match_jax_interpret(batch, jax_route):
    """The staged patch route (the canvas Function and the blend's, for
    every batch size) against the JAX package's blended mega route for
    one image (B.1.2) and its DMA route with the blend for two (B.1.3),
    in interpret mode (tests/test_patches.py:399-415)."""
    x, tgt = _pair(200, 300, 1, y=40, x=100, batch=batch)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2,
              method="direct_separable")
    reset_dispatch_log()
    got = _torch_grads(lambda v, c, b, a, be: deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **kw), x, tgt)
    assert dispatch_log() == {("deblur_patches", "staged_tiles"): 1}
    jprof.reset_dispatch_log()
    want = _jax_grads(lambda v, c, b, a, be: jpatches.deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, _mega_interpret=True, **kw), x, tgt)
    assert ("deblur_patches", jax_route) in jprof.dispatch_log()
    _assert_grads_match(got, want)


# ------------------------------------------------------------ remat

def test_remat_gradients_equal_and_routes_match_jax():
    """``remat`` on the scan route changes no gradient (atol 1e-6, as
    tests/test_pipeline.py:138-153); on the separable route at most 640 px
    it moves the call from the tiles route to the scan route with the
    plain polynomial, as in the JAX package, and the gradients stay
    within the cross-route tolerance (>= 40 dB, rtol 1e-3)."""
    x, tgt = _pair(48, 64, channels=1)

    def port(remat, **kw):
        reset_dispatch_log()
        g = _torch_grads(lambda v, c, b, a, be: polyblur_core(
            v, c=c, b=b, alpha=a, beta=be, remat=remat, device="cpu",
            **_core_kw(**kw)), x, tgt)
        return g, set(dispatch_log())

    def jax_routes(remat, **kw):
        jprof.reset_dispatch_log()
        jpipe.polyblur_core(jnp.asarray(x), remat=remat,
                            _mega_interpret=True, **_core_kw(**kw))
        return set(jprof.dispatch_log())

    (l0, gx0, gp0), _ = port(False, method="fft")
    (l1, gx1, gp1), _ = port(True, method="fft")
    assert l0 == l1
    np.testing.assert_allclose(gx1, gx0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gp1, gp0, atol=1e-6, rtol=1e-6)

    tiles, r0 = port(False, method="direct_separable")
    scan, r1 = port(True, method="direct_separable")
    _assert_grads_match(scan, tiles)
    # the same routes as the JAX package's (its mega kernel in interpret
    # mode); the port's tiles route is the TPU's mega_pallas, and its fused
    # maxima stand where the JAX package runs its XLA chain off the TPU
    names = {("polyblur_core", "tiles"): ("polyblur_core", "mega_pallas"),
             ("directional_maxima", "fused"): ("directional_maxima", "xla")}
    assert {names.get(k, k) for k in r0} == jax_routes(
        False, method="direct_separable")
    assert {names.get(k, k) for k in r1} == jax_routes(
        True, method="direct_separable")
    assert ("compute_polynomial_separable", "xla_sep") in r1


def test_remat_patch_route_composes_as_jax():
    """``remat=True`` refuses the staged patch route (the JAX package's
    mega routes refuse it): extract, the checkpointed scan, blend; the
    gradients match the JAX package's."""
    x, tgt = _pair(160, 280, 1, y=40, x=100)
    kw = dict(patch_size=160, overlap=32.0 / 160.0, n_iter=2,
              method="direct_separable", remat=True)
    reset_dispatch_log()
    got = _torch_grads(lambda v, c, b, a, be: deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, device="cpu", **kw), x, tgt)
    log = dispatch_log()
    assert ("deblur_patches", "composed") in log
    assert ("polyblur_core", "scan/direct_separable") in log
    assert ("deblur_patches", "staged_tiles") not in log
    jprof.reset_dispatch_log()
    want = _jax_grads(lambda v, c, b, a, be: jpatches.deblur_patches(
        v, c=c, b=b, alpha=a, beta=be, _mega_interpret=True, **kw), x, tgt)
    jlog = jprof.dispatch_log()
    assert not any(k[0] == "deblur_patches" for k in jlog), jlog
    assert ("polyblur_core", "scan/direct_separable") in jlog
    _assert_grads_match(got, want)


# ------------------------------------------------------------ Functions

def _cotangent(shape, seed=11):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _function_vs_plain(fn, plain, *inputs, same_forward=True):
    """Gradients of ``fn`` (through its Function) and of ``plain``
    (native autograd) under the same seeded cotangent: equal bits; the
    outputs too, unless the Function's forward computes another function
    than the one its backward replays (``same_forward=False``)."""
    def grads(f):
        xs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
        out = f(*xs)
        g = _cotangent(out.shape).to(out.dtype)
        return out, torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], g)

    out_f, g_f = grads(fn)
    out_p, g_p = grads(plain)
    assert out_f.grad_fn.name() == "_ReplayBackward"
    assert torch.equal(out_f, out_p) or not same_forward
    for a, b in zip(g_f, g_p):
        assert torch.equal(a, b)


def test_each_function_backward_is_autograd_of_its_plain_version():
    """B.1 items 1-8 on the CPU: the Function's forward is the plain
    version there, its backward autograd of it; both bit-equal to native
    autograd of the plain version. The flagged tiles and canvas Functions
    run the per-tile stages forward and replay the scan route
    (``_ref_pipeline``): their gradients are bit-equal to its autograd."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor(_peacock(70, 90))
    coeffs = _mega_pack(*SCALARS, 2.0, 0.8)
    # B.1.1
    _function_vs_plain(lambda t: edge_pad_cast(t, (68, 90), (4, 6, 3, 5)),
                       lambda t: edge_pad_cast_plain(t, (68, 90),
                                                     (4, 6, 3, 5)), x)
    # B.1.2-4 and the blend, on a 2 x 2 grid of 48 px tiles (one image
    # takes the canvas Function and the blend's, as a batch does)
    grid = plan_patch_grid(68, 90, 48, 0.25)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, 48, 48)
    canvas = edge_pad_cast_plain(x, grid.orig_size, grid.pad)
    win, inv = _blend_constants(grid, "kaiser", torch.device("cpu"))
    crop = (grid.pad[0], grid.pad[2]) + grid.orig_size

    def stages(cv, co):
        flags = dict(do_taper=False, do_halo=False, prefilter=None)
        return _restore_canvas(cv, co, 2, gi, None, flags)

    _function_vs_plain(lambda cv, co: polyblur_image_fused(cv, co, 2, gi),
                       stages, canvas, coeffs)
    tiles = torch.as_tensor(rng.uniform(size=(th * tw, 3, 48, 48))
                            .astype(np.float32))
    _function_vs_plain(
        lambda t: blend_overlap_add(t, win, inv, gi, 1, crop),
        lambda t: blend_overlap_add_plain(t, win, inv, gi, 1, crop), tiles)
    _function_vs_plain(lambda t, co: polyblur_tiles_fused(t, co, 2),
                       lambda t, co: restore_tiles(t, co, 2),
                       x[..., :40, :50].contiguous(), coeffs)
    # B.1.5, with and without the replicate pad
    planes = x[0, :, :40, :52].contiguous()
    params = torch.tensor([[0.8, 0.1, 0.5], [0.3, -0.05, 0.9],
                           [1.2, 0.2, 0.4]])
    for pad in (False, True):
        _function_vs_plain(
            lambda t, p, co: fused_polynomial(t, p, co, pad, True),
            lambda t, p, co: fused_polynomial_plain(t, p, co, pad, True),
            planes, params, coeffs[:4].clone())
    # B.1.7-8: the bilateral filter and the two IIR passes
    v = torch.as_tensor(rng.uniform(0.1, 0.9, size=(1, 70, 90))
                        .astype(np.float32))
    _function_vs_plain(bilateral_filter,
                       lambda t: _bilateral_plain(t, 5, 5.0, 0.1), x)
    _function_vs_plain(lambda t, vv: scan_rows(TileView.of_tiles(t), vv),
                       lambda t, vv: scan_rows_plain(TileView.of_tiles(t),
                                                     vv), x, v)
    _function_vs_plain(scan_cols, scan_cols_plain, x, v)
    # the flagged tiles and canvas Functions: per-tile stages forward, the
    # scan route on all tiles as one batch backward (2 x 2 grid, taper)
    flags = dict(do_taper=True, do_halo=True, prefilter="dt")
    _function_vs_plain(
        lambda t, co: polyblur_tiles_fused(t, co, 2, **flags),
        lambda t, co: _ref_pipeline(t, co, 2, **flags),
        tiles[:2].contiguous(), coeffs, same_forward=False)
    _function_vs_plain(
        lambda cv, co: polyblur_image_fused(cv, co, 2, gi, **flags),
        lambda cv, co: _ref_image_pipeline(cv, co, 2, gi, flags),
        canvas, coeffs, same_forward=False)
    # B.1.6: the forward of the fused maxima, the backward of _mags_xla
    from polyblur_torch import estimation as test

    gray = x.mean(1, keepdim=True)
    xs = gray.clone().requires_grad_()
    m = test._mags_fast(xs, 6)
    assert m.grad_fn.name() == "_ReplayBackward"
    g = _cotangent(m.shape)
    got = torch.autograd.grad(m, xs, g)[0]
    xr = gray.clone().requires_grad_()
    want = torch.autograd.grad(test._mags_xla(xr, 6), xr, g)[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("grid_case", ["steps_of_8", "odd_steps"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_dtype", [torch.bfloat16, torch.float32])
def test_blend_function_backward_is_autograd_of_the_plain_blend(
        tile_dtype, out_dtype, batch, channels, grid_case):
    """The blend's Function on the CPU, whose backward closure is
    ``blend_overlap_add_backward`` (there autograd of the plain blend, the
    gradient the card's kernel is held to), against native autograd of
    ``blend_overlap_add_plain``, bit for bit. The tiles put the pre-clip
    value p below 0, above 1 and exactly at 0 and 1 (the clip's gradient
    passes at both ends); a fifth of the cotangent is -0. Grids: 32 px
    tiles at step 24 (steps and widths multiples of 8) and 30 px at step
    21."""
    h, w, p, overlap = {"steps_of_8": (50, 70, 32, 0.25),
                        "odd_steps": (47, 61, 30, 0.3)}[grid_case]
    grid = plan_patch_grid(h, w, p, overlap)
    th, tw, sh, sw = _grid_steps(grid)
    gi = (th, tw, sh, sw, p, p)
    crop = (grid.pad[0], grid.pad[2], h, w)
    win, inv = _blend_constants(grid, "kaiser", torch.device("cpu"))
    # each tile element by its canvas pixel: random in [-0.5, 1.5], 1 or 0
    rng = np.random.default_rng(26)
    yy, xx = np.mgrid[:grid.padded_size[0], :grid.padded_size[1]]
    kind = (xx + 2 * yy) % 3
    kinds = np.stack([kind[i * sh:i * sh + p, j * sw:j * sw + p]
                      for i in range(th) for j in range(tw)
                      for _ in range(batch)])[:, None]
    vals = rng.uniform(-0.5, 1.5, size=(th * tw * batch, channels, p, p))
    tiles = torch.as_tensor(np.where(kinds == 0, vals, kinds == 1)
                            .astype(np.float32)).to(tile_dtype)

    # p from the plain blend itself: a halved reciprocal window sum halves
    # p exactly, so p / 2 and -p / 2 (the tiles negated) pass the clip whole
    def half(t):
        return blend_overlap_add_plain(t, win, inv * 0.5, gi, batch, crop,
                                       torch.float32)

    pre = 2 * (half(tiles) - half(-tiles))
    assert all(bool(m.any()) for m in (pre < 0, pre > 1, pre == 0, pre == 1))
    x = tiles.clone().requires_grad_()
    out = blend_overlap_add_plain(x, win, inv, gi, batch, crop, out_dtype)
    assert torch.equal(pre.clamp(0.0, 1.0).to(out_dtype), out.detach())
    g = _cotangent(out.shape).to(out_dtype)
    g.view(-1)[::5] = -0.0
    want = torch.autograd.grad(out, x, g)[0]
    xf = tiles.clone().requires_grad_()
    out_f = blend_overlap_add(xf, win, inv, gi, batch, crop, out_dtype)
    assert out_f.grad_fn.name() == "_ReplayBackward"
    got = torch.autograd.grad(out_f, xf, g)[0]
    bits = torch.int16 if tile_dtype == torch.bfloat16 else torch.int32
    assert got.dtype == want.dtype == tile_dtype
    assert torch.equal(got.view(bits), want.view(bits))


def test_replay_without_graph_is_the_kernel_call():
    """Without a graph to record no Function is built: the wrapper's
    forward runs as it did, and under no_grad as well."""
    x = torch.as_tensor(_peacock(48, 64))
    coeffs = _mega_pack(*SCALARS, 2.0, 0.8)
    out = polyblur_tiles_fused(x, coeffs, 2)
    assert out.grad_fn is None
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert polyblur_tiles_fused(xg, coeffs, 2).grad_fn is None
    graph = polyblur_tiles_fused(xg, coeffs, 2)
    assert graph.grad_fn.name() == "_ReplayBackward"
    assert torch.equal(graph.detach(), out)
    calls = []
    y = replay(lambda t: calls.append("k") or t * 2,
               lambda t: calls.append("p") or t * 2, x)
    assert calls == ["k"] and torch.equal(y, x * 2)


def test_plain_mode_belongs_to_the_replaying_thread():
    """A Function's backward replays its plain version in a plain mode of
    its own thread: a forward another thread runs meanwhile keeps its
    kernels (``runs_plain`` of a tensor off the CPU stays False there)."""
    import threading

    off_cpu = torch.empty(0, device="meta")
    seen = {}

    def plain(t):
        seen["replay"] = _build.runs_plain(off_cpu)
        other = threading.Thread(
            target=lambda: seen.setdefault("other",
                                           _build.runs_plain(off_cpu)))
        other.start()
        other.join()
        return t * 2

    x = torch.ones(3, requires_grad=True)
    replay(lambda t: t * 2, plain, x).sum().backward()
    assert seen == {"replay": True, "other": False}
    assert not _build.runs_plain(off_cpu) and torch.equal(x.grad,
                                                         torch.full((3,), 2.))


# ------------------------------------------------------------ feature flags

FLAG_SCALARS = SCALARS + (2.0, 0.8)          # ... sigma_s, sigma_r
_DT = dict(prefiltering=True, smoother="domain_transform")
_SEP = dict(n_iter=2, method="direct_separable")
# case: (shape (B, C, H, W), route, keywords, gradients wrt sigma_s and
# sigma_r too, the port's route, the JAX package's)
FLAG_CASES = {
    # four 48 px tiles as one batch: the scan route the backward replays
    # divides the taper by the batch-global maximum
    "tiles_taper": ((4, 3, 48, 48), "core", dict(edgetaping=True), False,
                    ("polyblur_core", "tiles"),
                    ("polyblur_core", "mega_pallas")),
    "tiles_halo": ((1, 3, 48, 64), "core", dict(remove_halo=True), False,
                   ("polyblur_core", "tiles"),
                   ("polyblur_core", "mega_pallas")),
    "tiles_bilateral": ((1, 3, 48, 64), "core", dict(prefiltering=True),
                        False, ("polyblur_core", "tiles"),
                        ("polyblur_core", "mega_pallas")),
    "tiles_dt": ((1, 3, 48, 64), "core", _DT, True,
                 ("polyblur_core", "tiles"),
                 ("polyblur_core", "mega_pallas")),
    # 1 x 2 tiles of 160 px at step 128, padded by more than the overlap:
    # the JAX package's blended route
    "patch_dt": ((1, 1, 160, 200), "patch",
                 dict(patch_size=160, overlap=0.2, **_DT), True,
                 ("deblur_patches", "staged_tiles"),
                 ("deblur_patches", "mega_image_blended")),
    # a 2 x 2 grid of 48 px tiles per image, config 2's flags; one
    # iteration (the interpret-mode DMA route is the slowest case)
    "patch_all_flags_batch2": ((2, 1, 80, 80), "patch",
                               dict(patch_size=48, overlap=0.25,
                                    edgetaping=True, remove_halo=True,
                                    n_iter=1, **_DT), True,
                               ("deblur_patches", "staged_tiles"),
                               ("deblur_patches", "mega_image_dma")),
    "scan_bilateral": ((1, 3, 48, 64), "core",
                       dict(prefiltering=True, _disable_mega=True), False,
                       ("bilateral_filter", "cuda"),
                       ("bilateral_filter", "xla")),
    "scan_dt": ((1, 3, 48, 64), "core", dict(_disable_mega=True, **_DT),
                False, ("recursive_filter", "cuda"),
                ("polyblur_core", "scan/direct_separable")),
    "scan_sigma": ((1, 3, 48, 64), "core",
                   dict(_disable_mega=True, edgetaping=True,
                        remove_halo=True, **_DT), True,
                   ("recursive_filter", "cuda"),
                   ("polyblur_core", "scan/direct_separable")),
}


def _sharpened_pair(b, c, h, w, y, x):
    """(input, target) for the flag cases: the target is the input
    sharpened by an unsharp mask (sigma 1.5 px, gain 1), what a deblurring
    layer is fitted to. With the displaced crop of ``_pair`` the
    prefiltered routes' alpha and beta gradients cancel to ~2e-3 of c's
    (1.4e-7 against 9e-5 on the bilateral scan route), and their relative
    agreement (1.3e-3 to 2.9e-2 measured) gauges that cancellation: the
    image gradients agree to 84-123 dB there."""
    from scipy import ndimage

    if b > 1 and h == w and y == 120:
        # b tiles side by side, cut into a batch
        img = _peacock(h, w * b, c, y, x)
        img = np.concatenate(np.split(img, b, -1), 0)
    else:
        img = _peacock(h, w, c, y, x, b)
    blur = ndimage.gaussian_filter(img, (0, 0, 1.5, 1.5))
    return img, np.clip(2.0 * img - blur, 0.0, 1.0).astype(np.float32)


@contextlib.contextmanager
def _full_f32_dots():
    """The mega kernel's f32 dots at full precision, as the JAX package's
    interpret-mode tests run it (compensated, its forward is ~1e-5 off
    its own scan route); traced afresh inside and after, so no cached
    trace carries a mode across."""
    from polyblur_tpu.ops.pallas.sep_poly_fused import f32_dot_mode_scope

    try:
        with f32_dot_mode_scope("highest"):
            jax.clear_caches()
            yield
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_flagged_routes_gradients_match_jax(case):
    """Every feature-flag route trains (ROADMAP B.1 items 7-8): gradients
    with respect to the image and to (c, b, alpha, beta), and for the dt
    cases (sigma_s, sigma_r), against ``jax.grad`` of the JAX package,
    its mega kernel in interpret mode. The tiles and canvas Functions'
    backward replays the scan route on their tiles as one batch, as the
    JAX package's VJPs do; the scan route differentiates the bilateral
    Function, the IIR Functions and the sigmas in the graph. Tolerances:
    loss rtol 1e-4, image >= 40 dB, scalars rtol 1e-3. Measured (image
    dB, largest scalar relative error): tiles_taper 115.8, 2.1e-5;
    tiles_halo 106.6, 4.6e-5; tiles_bilateral 113.5, 8.2e-5; tiles_dt
    82.7, 2.9e-5; patch_dt 109.2, 1.1e-5; patch_all_flags_batch2 89.5,
    5.1e-5; scan_bilateral 112.8, 1.4e-4; scan_dt 82.7, 7.3e-6;
    scan_sigma 82.7, 2.4e-5. The dt cases' ~83 dB is the feedback's
    pow, in float64 here and in f32 in the JAX package. The clips of the
    scan route take ``jnp.clip``'s tie rule (half the gradient on a
    bound); no stage is left where a tie differs."""
    shape, kind, kw, sigmas, route, jax_route = FLAG_CASES[case]
    b, c, h, w = shape
    x, tgt = _sharpened_pair(b, c, h, w, 40 if kind == "patch" else 120,
                             100 if kind == "patch" else 200)
    scalars = FLAG_SCALARS if sigmas else SCALARS
    port_fn = polyblur_core if kind == "core" else deblur_patches
    jax_fn = (jpipe.polyblur_core if kind == "core"
              else jpatches.deblur_patches)

    kw = dict(_SEP, **kw)

    def port(v, c_, b_, a, be, *ss):
        return port_fn(v, c=c_, b=b_, alpha=a, beta=be, device="cpu",
                       **dict(zip(("sigma_s", "sigma_r"), ss)), **kw)

    def want(v, c_, b_, a, be, *ss):
        return jax_fn(v, c=c_, b=b_, alpha=a, beta=be, _mega_interpret=True,
                      **dict(zip(("sigma_s", "sigma_r"), ss)), **kw)

    reset_dispatch_log()
    got = _torch_grads(port, x, tgt, scalars)
    assert route in dispatch_log(), dispatch_log()
    jprof.reset_dispatch_log()
    with _full_f32_dots():
        ref = _jax_grads(want, x, tgt, scalars)
    assert jax_route in jprof.dispatch_log(), jprof.dispatch_log()
    _assert_grads_match(got, ref)


def test_flagged_remat_changes_no_gradient_and_routes_match_jax():
    """With every flag (the dt and the bilateral prefilter) ``remat`` on
    the 'fft' scan route checkpoints each iteration, the smoothers'
    kernels (here their plain versions) running again in the recompute:
    gradients equal without it within atol 1e-6 (measured: 0, bit-equal),
    and the routes taken are the JAX package's."""
    x, tgt = _sharpened_pair(1, 3, 40, 56, 120, 200)
    names = {("bilateral_filter", "cuda"): ("bilateral_filter", "xla"),
             ("directional_maxima", "fused"): ("directional_maxima", "xla")}
    for smoother in ("domain_transform", "bilateral"):
        kw = dict(n_iter=2, method="fft", edgetaping=True, remove_halo=True,
                  prefiltering=True, smoother=smoother)
        runs = {}
        for remat in (False, True):
            reset_dispatch_log()
            runs[remat] = _torch_grads(
                lambda v, c, b, a, be, ss, sr: polyblur_core(
                    v, c=c, b=b, alpha=a, beta=be, sigma_s=ss, sigma_r=sr,
                    remat=remat, device="cpu", **kw), x, tgt, FLAG_SCALARS)
            routes = {names.get(k, k) for k in dispatch_log()}
            routes.discard(("recursive_filter", "cuda"))
            jprof.reset_dispatch_log()
            jax.clear_caches()          # the log is written while tracing
            jpipe.polyblur_core(jnp.asarray(x), remat=remat, **kw)
            assert routes == set(jprof.dispatch_log()), (routes,
                                                        jprof.dispatch_log())
        (l0, gx0, gp0), (l1, gx1, gp1) = runs[False], runs[True]
        assert l0 == l1
        np.testing.assert_allclose(gx1, gx0, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gp1, gp0, atol=1e-6, rtol=1e-6)


def test_bilateral_function_gradient_matches_jax():
    """The bilateral Function (B.1.7) on the CPU against ``jax.grad`` of
    ``_bilateral_xla`` (tests/test_kernels.py:448-470's inputs), atol
    1e-5 (measured 1.5e-10)."""
    from polyblur_tpu.ops.bilateral import _bilateral_xla

    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, 3, 40, 56)).astype(np.float32)
    tgt = rng.uniform(size=x.shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = bilateral_filter(xt)
    assert out.grad_fn.name() == "_ReplayBackward"
    ((out - torch.as_tensor(tgt)) ** 2).mean().backward()
    want = jax.grad(lambda v: jnp.mean(
        (_bilateral_xla(v, 5, 5.0, 0.1) - tgt) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_iir_functions_gradients_match_jax(axis):
    """The IIR Functions (B.1.8), the row and the column pass, on the CPU
    against ``jax.grad`` of ``iir_scan_rows`` in (x, v)
    (tests/test_kernels.py:562-586's inputs; the column pass as the JAX
    code runs it, swapaxes around the row scan), atol 1e-5 (measured
    7.0e-10)."""
    from polyblur_tpu.ops.domain_transform import iir_scan_rows

    rng = np.random.default_rng(10)
    x = rng.uniform(size=(1, 2, 8, 32)).astype(np.float32)
    v = rng.uniform(0.1, 0.9, size=(1, 2, 8, 32)).astype(np.float32)
    tgt = rng.uniform(size=x.shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    if axis == "rows":
        out = scan_rows(TileView.of_tiles(xt), vt.reshape(2, 8, 32))
    else:
        out = scan_cols(xt, vt.reshape(2, 8, 32))
    assert out.grad_fn.name() == "_ReplayBackward"
    ((out - torch.as_tensor(tgt)) ** 2).mean().backward()

    def scan(x_, v_):
        if axis == "rows":
            return iir_scan_rows(x_, v_)
        return jnp.swapaxes(iir_scan_rows(jnp.swapaxes(x_, -1, -2),
                                          jnp.swapaxes(v_, -1, -2)), -1, -2)

    want = jax.grad(lambda x_, v_: jnp.mean((scan(x_, v_) - tgt) ** 2),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    for got, ref in zip((xt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------ the layer

def _binary_problem(n):
    """tests/test_runtime.py:150-180's problem at n x n: a thresholded
    smooth random field blurred by an anisotropic Gaussian (wrap)."""
    from scipy import ndimage

    from polyblur_tpu.ops.gaussian import gaussian_filter_np

    rng = np.random.default_rng(0)
    base = ndimage.gaussian_filter(rng.uniform(size=(n, n)), 1.0)
    sharp = (base > base.mean()).astype(np.float32)
    k = gaussian_filter_np((1.7, 0.9), 0.6, k_size=np.array([25, 25]))
    blurry = np.clip(ndimage.convolve(sharp, k, mode="wrap"), 0,
                     1).astype(np.float32)
    return blurry[None, None], sharp[None, None]


def test_fit_layer_loss_non_increasing_and_tracks_jax():
    """6 Adam steps at lr 5e-3 through ``PolyblurLayer(learnable=True,
    remat=True, method='fft')`` on a 128^2 version of the JAX package's
    training problem: every step improves (within 1e-6), and the losses
    and fitted scalars follow the JAX package's ``fit_layer`` (rtol
    1e-3)."""
    from polyblur_tpu.layers import PolyblurLayer as JaxLayer
    from polyblur_tpu.training import fit_layer as jax_fit

    blurry, sharp = _binary_problem(128)
    layer = PolyblurLayer(n_iter=2, learnable=True, remat=True,
                          method="fft", device="cpu")
    params, losses = fit_layer(layer, blurry, sharp, steps=6,
                               learning_rate=5e-3)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert all(b <= a + 1e-6 for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < losses[0]
    jparams, jlosses = jax_fit(JaxLayer(n_iter=2, learnable=True,
                                        remat=True, method="fft"),
                               jnp.asarray(blurry), jnp.asarray(sharp),
                               steps=6, learning_rate=5e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for k, v in params["params"].items():
        np.testing.assert_allclose(v, float(jparams["params"][k]),
                                   rtol=1e-3)


def test_layer_fields_and_polyblur_apply():
    """The JAX layer's fields; ``learnable`` makes the four scalars f32
    parameters; the patch route; ``polyblur_apply`` is ``polyblur_core``."""
    x = torch.as_tensor(_peacock(160, 200))
    fixed = PolyblurLayer(n_iter=1, device="cpu")
    assert list(fixed.parameters()) == [] and fixed.alpha == 6.0
    layer = PolyblurLayer(n_iter=1, learnable=True, device="cpu",
                          method="direct_separable", patch_size=96,
                          patch_overlap=0.25, extra=dict(
                              out_dtype=torch.float32))
    assert [n for n, _ in layer.named_parameters()] == ["c", "b", "alpha",
                                                         "beta"]
    assert all(p.dtype == torch.float32 for p in layer.parameters())
    reset_dispatch_log()
    out = layer(x)
    assert ("deblur_patches", "staged_tiles") in dispatch_log()
    want = deblur_patches(x, patch_size=96, overlap=0.25, n_iter=1,
                          method="direct_separable", c=0.362, b=0.468,
                          alpha=6.0, beta=1.0, device="cpu")
    assert torch.equal(out.detach(), want)
    np.testing.assert_array_equal(
        polyblur_apply(x, n_iter=1, alpha=6.0, beta=1.0, device="cpu"),
        polyblur_core(x, n_iter=1, c=0.362, b=0.468, alpha=6.0, beta=1.0,
                      device="cpu"))


def test_params_json_round_trips_with_the_jax_package(tmp_path):
    """``save_params`` / ``load_params`` write and read the JAX package's
    JSON: a file from either loads in the other; ``layer_params_from_jax``
    takes a flax params tree into the layer."""
    from polyblur_tpu.layers import PolyblurLayer as JaxLayer
    from polyblur_tpu.training import load_params as jload
    from polyblur_tpu.training import save_params as jsave

    layer = PolyblurLayer(learnable=True, c=0.3, b=0.5, alpha=5.5,
                          beta=1.25, device="cpu")
    p_torch = tmp_path / "torch.json"
    ttrain.save_params(layer, str(p_torch))
    back = jload(str(p_torch))
    assert set(back["params"]) == {"c", "b", "alpha", "beta"}
    for k, v in layer.state_dict().items():
        assert np.float32(back["params"][k]) == np.float32(v)

    jparams = JaxLayer(learnable=True, c=0.25, b=0.4, alpha=4.0,
                       beta=2.0).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 1, 16, 16)))
    p_jax = tmp_path / "jax.json"
    jsave(jparams, str(p_jax))
    # the same scalars written by the port: the same bytes
    p_again = tmp_path / "again.json"
    ttrain.save_params({k: float(v) for k, v in jparams["params"].items()},
                       str(p_again))
    assert p_jax.read_text() == p_again.read_text()
    fresh = PolyblurLayer(learnable=True, device="cpu")
    fresh.load_state_dict(ttrain.load_params(str(p_jax))["params"])
    state = layer_params_from_jax(jax.tree.map(np.asarray, jparams))
    for k in ("c", "b", "alpha", "beta"):
        assert torch.equal(fresh.state_dict()[k], state[k])
        assert float(state[k]) == float(np.float32(jparams["params"][k]))


def test_checkpoint_round_trips_adam_state_and_step(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint``: parameters, Adam's
    moments and the step come back, and a resumed run continues exactly
    as the uninterrupted one."""
    blurry, sharp = _binary_problem(48)

    def make():
        layer = PolyblurLayer(n_iter=1, learnable=True, method="fft",
                              device="cpu")
        return layer, torch.optim.Adam(layer.parameters(), lr=1e-2)

    layer, opt = make()
    step = ttrain.make_train_step(layer, opt)
    for _ in range(2):
        step(torch.as_tensor(blurry), torch.as_tensor(sharp))
    path = str(tmp_path / "ckpt.pt")
    ttrain.save_checkpoint(path, layer, opt, step=2)
    state = ttrain.load_checkpoint(path)
    assert state["step"] == 2
    layer2, opt2 = make()
    layer2.load_state_dict(state["params"])
    opt2.load_state_dict(state["opt_state"])
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    step2 = ttrain.make_train_step(layer2, opt2)
    l1 = step(torch.as_tensor(blurry), torch.as_tensor(sharp))
    l2 = step2(torch.as_tensor(blurry), torch.as_tensor(sharp))
    assert torch.equal(l1, l2)
    for a, b in zip(layer.parameters(), layer2.parameters()):
        assert torch.equal(a, b)
