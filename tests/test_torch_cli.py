"""polyblur_torch's user-facing tools vs the JAX package on CPU: image I/O,
the NumPy oracle's copy, the calibration CLI, the demo CLI and the
benchmark suite's configs (at tiny sizes, with ``device="cpu"``)."""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import polyblur_tpu.cli.calibrate as jcal
import polyblur_tpu.cli.main as jmain
import polyblur_tpu.oracle.numpy_ref as joracle
import polyblur_tpu.utils.imaging as jimaging
import polyblur_tpu.utils.io as jio

import polyblur_torch.cli.bench_suite as bench
import polyblur_torch.cli.calibrate as tcal
import polyblur_torch.cli.main as tmain
import polyblur_torch.oracle.numpy_ref as toracle
import polyblur_torch.utils.imaging as timaging
import polyblur_torch.utils.io as tio
from polyblur_torch import PolyblurDeblurring
from polyblur_torch.patches import plan_patch_grid

DATA = os.path.join(os.path.dirname(__file__), "data")
PEACOCK = os.path.join(DATA, "peacock_defocus.png")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's PyTorch CPU work on one thread: the suite runs
    files in parallel workers, and the plain path's many small operations
    slow down by an order of magnitude when every worker's thread pool
    spans all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def _png(path):
    return np.asarray(Image.open(path))


# ------------------------------------------------------------------ io

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "I;16"])
def test_imread_float_equals_jax(tmp_path, mode):
    src = np.asarray(Image.open(PEACOCK))
    if mode == "I;16":
        img = Image.fromarray(src[..., 0].astype(np.uint16) * 257)
    elif mode == "L":
        img = Image.fromarray(src[..., 1])
    else:
        img = Image.fromarray(src).convert(mode)
    path = str(tmp_path / f"x_{mode.replace(';', '')}.png")
    img.save(path)
    got, want = tio.imread_float(path), jio.imread_float(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_imsave_uint8_equals_jax(tmp_path):
    rng = np.random.default_rng(50)
    for shape in ((33, 47, 3), (21, 18)):
        img = rng.uniform(-0.2, 1.2, size=shape).astype(np.float32)
        tio.imsave_uint8(str(tmp_path / "t.png"), img)
        jio.imsave_uint8(str(tmp_path / "j.png"), img)
        np.testing.assert_array_equal(_png(tmp_path / "t.png"),
                                      _png(tmp_path / "j.png"))


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32", "float64",
                                   "float32"])
def test_to_float_and_to_uint_equal_jax(dtype):
    rng = np.random.default_rng(51)
    if dtype.startswith(("uint", "int")):
        hi = min(np.iinfo(dtype).max, 2 ** 20)
        img = rng.integers(0, hi, size=(17, 19, 3)).astype(dtype)
    else:
        img = rng.uniform(-0.5, 1.5, size=(17, 19, 3)).astype(dtype)
    for name in ("to_float", "to_uint"):
        got = getattr(timaging, name)(img)
        want = getattr(jimaging, name)(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ oracle

def test_oracle_copy_equals_jax_package_oracle():
    """Every function of the NumPy oracle's copy returns what the JAX
    package's returns, bit for bit, on seeded inputs."""
    assert toracle.__all__ == joracle.__all__
    rng = np.random.default_rng(52)
    img = rng.uniform(size=(40, 56))
    k = joracle.gaussian_filter((1.6, 0.7), 0.4, k_size=np.array([15, 15]))
    x = np.arange(7.0)
    cases = {
        "fourier_gradients": (img,),
        "gaussian_filter": ((1.6, 0.7), 0.4, np.array([0.3, -0.2]),
                            np.array([15, 15])),
        "directional_gradient_magnitudes": (*joracle.fourier_gradients(img),
                                            6),
        "keys_cubic_interp": (np.linspace(0, 6, 31), x, rng.uniform(size=7)),
        "estimate_gaussian_parameters": (img,),
        "polynomial_coefficients": (6.0, 1.0),
        "compute_polynomial_fft": (img, k, 6.0, 1.0),
        "p2o": (k, img.shape),
        "normalized_convolution": (rng.uniform(size=(2, 3, 24, 32)), 5.0,
                                   0.4, 2),
    }
    assert set(cases) == set(toracle.__all__)
    for name, args in cases.items():
        got = getattr(toracle, name)(*args)
        want = getattr(joracle, name)(*args)
        got, want = ((v if isinstance(v, tuple) else (v,))
                     for v in (got, want))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)


# ------------------------------------------------------------------ calibrate

def test_calibrate_main_gives_jax_c_b():
    """tests/test_runtime.py:101-107's arguments: the same seed, corpus
    and fit give the JAX package's (c, b) in both directions."""
    args = ["--n_kernels", "4", "--n_synthetic", "2", "--patch_size", "128"]
    got, want = tcal.main(args), jcal.main(args)
    assert set(got) == set(want) == {"normal", "orthogonal"}
    for d in ("normal", "orthogonal"):
        assert got[d]["n_samples"] == want[d]["n_samples"] == 8
        for key in ("c", "b", "slope", "intercept"):
            assert got[d][key] == pytest.approx(want[d][key], rel=1e-9,
                                                abs=0)
    assert got["normal"]["c"] > 0


def test_calibrate_corpora_equal_jax():
    for name in ("dead_leaves_images", "synthetic_sharp_images"):
        for g, w in zip(getattr(tcal, name)(2, 48), getattr(jcal, name)(2,
                                                                        48)):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ demo CLI

@pytest.mark.parametrize("extra", [
    ["--do_patch_decomposition", "true", "--patch_size", "256"],
    ["--do_patch_decomposition", "true", "--patch_size", "256",
     "--patch_overlap", "0.6"],
    ["--synthetic_degradation", "true", "--sigma", "2.0", "--rho", "0.8",
     "--theta", "30", "--sigma_n", "0"],
], ids=["patches", "irregular_patches", "synthetic"])
def test_cli_main_png_is_the_api_output_and_holds_jax(tmp_path, extra):
    """tests/test_runtime.py:92-117's runs with ``--device cpu``: the PNG
    is ``imsave_uint8`` of the port's API output on the same arguments,
    and >= 40 dB from the JAX package's CLI output (its 'fft' on the CPU;
    no noise, so the degradation is the same in both)."""
    args = ["--impath", PEACOCK, "--N", "1", "--alpha", "6", "--beta", "1"]
    args += extra
    out = tmain.main(args + ["--outdir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert os.path.exists(out) and out.endswith(
        "restored_alpha_6_beta_1.png")
    ns = tmain.build_parser().parse_args(args)
    img = tio.imread_float(PEACOCK)
    if ns.synthetic_degradation:
        img = tmain.degrade(img, ns)
    api = PolyblurDeblurring(
        patch_decomposition=ns.do_patch_decomposition,
        patch_size=ns.patch_size, patch_overlap=ns.patch_overlap,
        batch_size=20, device="cpu")(
        img, n_iter=1, c=0.362, b=0.468, alpha=6.0, beta=1.0, q=0.0,
        method="direct_separable")
    tio.imsave_uint8(str(tmp_path / "api.png"), api)
    np.testing.assert_array_equal(_png(out), _png(tmp_path / "api.png"))
    jax_out = jmain.main(args + ["--outdir", str(tmp_path / "j")])
    assert _psnr(tio.imread_float(out), tio.imread_float(jax_out)) >= 40.0


def test_cli_main_noise_is_seeded():
    """The synthetic degradation's noise comes from a seeded generator:
    two degradations of one image are equal, and noisy."""
    ns = tmain.build_parser().parse_args(
        ["--impath", PEACOCK, "--synthetic_degradation", "true"])
    img = tio.imread_float(PEACOCK)[:64, :96]
    a, b = tmain.degrade(img, ns), tmain.degrade(img, ns)
    np.testing.assert_array_equal(a, b)
    clean = tmain.degrade(img, tmain.build_parser().parse_args(
        ["--impath", PEACOCK, "--sigma_n", "0"]))
    assert a.dtype == np.float32 and 0.005 < np.std(a - clean) < 0.015


def test_cli_parsers_keep_the_jax_flags():
    ours = {a.dest for a in tmain.build_parser()._actions}
    theirs = {a.dest for a in jmain.build_parser()._actions}
    assert ours - theirs == {"device"} and theirs <= ours


# ------------------------------------------------------------------ bench

@pytest.fixture(scope="module")
def peacock_f32():
    return tio.imread_float(PEACOCK)


def _labels(rows):
    assert all(len(r) == 3 and r[1].endswith(" ms")
               and r[2].endswith(" MP/s") for r in rows)
    return [r[0] for r in rows]


def test_bench_config1_and_3(peacock_f32):
    gray = peacock_f32.mean(axis=-1).astype(np.float32)[:64, :96]
    assert _labels(bench.config1(gray, CPU, n=1)) == [
        "1. peacock gray N=3 (ref: ~10ms GPU)"]
    assert _labels(bench.config3(2, 32, CPU, n=1)) == [
        "3. batch=2 x 3 (c,b) settings"]


def test_bench_config2(peacock_f32):
    mp = 64 * 96 / 1e6
    assert _labels(bench.config2(bench.tiled(peacock_f32, 64, 96), CPU,
                                 n=1)) == [
        f"2. {mp:.1f}MP RGB full pipeline, bf16 tiled (serving)",
        f"2b. {mp:.1f}MP full pipeline, f32 tiled",
        f"2c. {mp:.1f}MP full pipeline, whole-image fft (oracle)"]


def test_bench_config4(peacock_f32):
    h, w = 300, 400
    mp = h * w / 1e6
    rows = bench.config4(bench.tiled(peacock_f32, h, w), CPU, n=1,
                         sweep_grids=True)
    sweep = []
    for ps, step in bench.SWEEP_GRIDS:
        n = len(plan_patch_grid(h, w, ps, (ps - step) / ps).coords)
        sweep.append(f"4s. {mp:.0f}MP device-kernel, {ps}/{step} grid "
                     f"({n} tiles, {n * ps * ps / (h * w):.2f}x)")
    assert _labels(rows) == [
        f"4. {mp:.0f}MP bf16 tiled per-tile est (headline)", *sweep,
        f"4b. {mp:.0f}MP everything-on-device, ref-default 400/25% grid",
        f"4b2. {mp:.0f}MP everything-on-device, 576/512 grid",
        f"4b3. {mp:.0f}MP everything-on-device, 448/384 grid + fused "
        f"pad-cast ingest (headline)"]


def test_bench_config4c_and_5(peacock_f32):
    """4c, 5 and 5b at tiny sizes (the JAX suite's labels, its optimizer
    name aside: ``torch.optim.Adam`` in place of optax's)."""
    assert _labels(bench.config4c(bench.tiled(peacock_f32, 96, 128), CPU,
                                  n=1)) == [
        "4c. 0MP everything-on-device, 576/512 grid"]
    assert _labels(bench.config5(32, CPU, n=1)) == [
        "5. Adam step, 3-iter remat sep layer (0MP)"]
    assert _labels(bench.config5b(bench.tiled(peacock_f32, 96, 128), CPU,
                                  n=1)) == [
        "5b. Adam step, 3-iter remat TILED (0MP bf16)"]


def test_bench_time_call_is_the_median():
    calls = []
    dt = bench.time_call(lambda: calls.append(1), CPU, n=3)
    assert len(calls) == 4 and dt >= 0.0
