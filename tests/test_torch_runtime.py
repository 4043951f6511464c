"""polyblur_torch's host runtime and burst CLI, on the CPU.

Mirrors tests/test_runtime.py's native-runtime, loader and burst cases
against the port: the native library (``runtime/native.py``, a g++ build of
``runtime/csrc/host_runtime.cpp``) builds into ``build/polyblur_torch/``
and not into the package; its decode matches PIL, its tiles are bit-equal
to the port's ``extract_patches`` and its overlap-add matches the port's
``overlap_add``; the fallbacks, with the library forced off, give the same
results; ``BurstLoader`` stages the tiles (pinned for a CUDA target: on
the card only, and ``chip_smoke.py`` phase (q) covers it); the burst CLI
on the CPU writes the JAX package's burst CLI's PNGs to within 1 LSB; and
neither module imports JAX.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from polyblur_torch.patches import extract_patches, overlap_add, plan_patch_grid
from polyblur_torch.runtime import native
from polyblur_torch.runtime.loader import BurstLoader
from polyblur_torch.utils.imaging import build_window_np
from polyblur_torch.utils.io import imread_float

DATA = os.path.join(os.path.dirname(__file__), "data")
PEACOCK = os.path.join(DATA, "peacock_defocus.png")
ROOT = Path(__file__).resolve().parents[1]


def test_native_builds_into_build_dir():
    status = native.native_available()
    assert status and status.available, status.reason
    lib = native._target(shutil.which("g++"))
    assert lib.exists() and lib.parent == ROOT / "build" / "polyblur_torch"
    pkg = ROOT / "polyblur_torch"
    assert not list(pkg.rglob("*.so")), "a library landed in the package"


def test_native_decode_matches_pil():
    a = native.decode_image(PEACOCK)
    b = imread_float(PEACOCK)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_native_tiles_match_port():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 3, 150, 210)).astype(np.float32)
    grid = plan_patch_grid(150, 210, 64, 0.25)
    t_native = native.extract_tiles(x, grid)
    t_port = extract_patches(torch.as_tensor(x), grid).numpy()
    np.testing.assert_array_equal(t_native, t_port)


def test_native_overlap_add_matches_port():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(1, 3, 150, 210)).astype(np.float32)
    grid = plan_patch_grid(150, 210, 64, 0.25)
    tiles = native.extract_tiles(x, grid)
    win = build_window_np(grid.patch_size, "kaiser").astype(np.float32)
    a = native.overlap_add_host(tiles, grid, 1, win)
    b = overlap_add(torch.as_tensor(tiles), grid, 1).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6)
    # tiling with no processing reconstructs the input
    np.testing.assert_allclose(a, x, atol=1e-5)


def test_fallbacks_give_the_same_results(monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, 3, 150, 210)).astype(np.float32)
    grid = plan_patch_grid(150, 210, 64, 0.25)
    win = build_window_np(grid.patch_size, "kaiser").astype(np.float32)
    assert native.native_available()
    tiles = native.extract_tiles(x, grid)
    blend = native.overlap_add_host(tiles, grid, 2, win)
    img = native.decode_image(PEACOCK)
    # the library forced off: the fallbacks
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_reason", "forced off")
    status = native.native_available()
    assert not status and status.reason == "forced off"
    np.testing.assert_array_equal(native.extract_tiles(x, grid), tiles)
    np.testing.assert_allclose(native.overlap_add_host(tiles, grid, 2, win),
                               blend, atol=1e-6)
    np.testing.assert_allclose(blend, x, atol=1e-5)
    np.testing.assert_allclose(native.decode_image(PEACOCK), img, atol=1e-6)


def test_burst_loader_yields_staged_tiles():
    loader = BurstLoader([PEACOCK, PEACOCK], patch_size=256, prefetch=1,
                         device="cpu")
    items = list(loader)
    assert len(items) == len(loader) == 2
    tiles, grid, meta = items[0]
    assert tiles.ndim == 4 and tiles.shape[1] == 3
    assert tiles.shape[-2:] == (256, 256)
    assert meta["path"] == PEACOCK
    assert isinstance(tiles, torch.Tensor) and tiles.dtype == torch.float32
    chw = native.decode_image(PEACOCK).transpose(2, 0, 1)[None]
    np.testing.assert_array_equal(tiles.numpy(),
                                  native.extract_tiles(chw, grid))


def test_burst_loader_raises_a_stage_error():
    with pytest.raises(IOError):
        list(BurstLoader([os.path.join(DATA, "no_such_image.png")],
                         device="cpu"))


def test_cuda_burst_loader_stages_pinned_tiles():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned host memory)")
    tiles, grid, _ = next(iter(BurstLoader([PEACOCK], patch_size=256)))
    assert tiles.is_pinned()
    chw = native.decode_image(PEACOCK).transpose(2, 0, 1)[None]
    np.testing.assert_array_equal(tiles.numpy(),
                                  native.extract_tiles(chw, grid))


def test_burst_cli_matches_jax(tmp_path, monkeypatch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from polyblur_tpu.cli.burst import main as jax_main
    from polyblur_tpu.runtime import native as jax_native

    # the JAX package builds its library beside its source, without an
    # atomic rename: its own tests' workers may be building it now, so
    # its burst runs on its fallbacks here (the same pixels)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)

    from polyblur_torch.cli.burst import main

    src = tmp_path / "in"
    src.mkdir()
    crop = np.asarray(Image.open(PEACOCK))[100:292, 150:450, :3]
    Image.fromarray(crop).save(src / "crop.png")
    args = ["--images", str(src / "*.png"), "--N", "1", "--patch_size",
            "256", "--dtype", "float32"]
    stats = []
    assert main(args + ["--device", "cpu", "--outdir",
                        str(tmp_path / "torch")], stats=stats) == 1
    assert jax_main(args + ["--outdir", str(tmp_path / "jax")]) == 1
    assert [s["path"] for s in stats] == [str(src / "crop.png")]
    got = np.asarray(Image.open(tmp_path / "torch" / "crop_restored.png"))
    want = np.asarray(Image.open(tmp_path / "jax" / "crop_restored.png"))
    assert got.shape == want.shape == crop.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_burst_and_loader_import_no_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import polyblur_torch.cli.burst, polyblur_torch.runtime.loader\n"
            "assert not any(m == 'polyblur_tpu' or m.startswith("
            "'polyblur_tpu.') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
