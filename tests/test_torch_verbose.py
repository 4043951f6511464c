"""``verbose=True`` and the tracing helpers of polyblur_torch vs the JAX
package on CPU.

The stage loop prints the JAX package's lines (api.py:109-175) in its
order and returns exactly the pixels of ``verbose=False``: the same scan
route stages, or ``polyblur_core``'s result where it takes the tiles route
(``pipeline._mega_static_ok``).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import polyblur_tpu as jp
from polyblur_tpu.utils import profiling as jprof

import polyblur_torch.api as tapi
from polyblur_torch import polyblur_deblurring
from polyblur_torch.utils import profiling as tprof

DEMO = dict(alpha=6.0, beta=1.0)
FLAGS = dict(prefiltering=True, remove_halo=True, edgetaping=True)


def _stages(out: str) -> list:
    """The stage labels of the printed ``-- label: seconds`` lines."""
    return [m.group(1).rstrip() for m in
            re.finditer(r"^-- (.+?):\s+[0-9.]+s?$", out, re.M)]


def _image(seed, h=48, w=48):
    return np.random.default_rng(seed).uniform(
        size=(h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name, kw", [
    ("fft", dict(n_iter=2, method="fft")),
    ("every_flag", dict(n_iter=2, method="fft", **FLAGS)),
    ("separable_scan", dict(n_iter=2, method="direct_separable", n_angles=4)),
    ("tiles_route", dict(n_iter=2, method="direct_separable")),
])
def test_stage_lines_match_jax_and_pixels_do_not_move(capsys, name, kw):
    """The labels and their count equal the JAX package's, and the pixels
    equal ``verbose=False`` bit for bit (tests/test_pipeline.py:208-361:
    'fft', with every flag, and the configuration the fused kernels serve,
    here the tiles route, whose result the stage loop returns)."""
    img = _image(len(name))
    quiet = polyblur_deblurring(img, device="cpu", **DEMO, **kw)
    capsys.readouterr()
    loud = polyblur_deblurring(img, device="cpu", verbose=True, **DEMO, **kw)
    got = _stages(capsys.readouterr().out)
    jp.polyblur_deblurring(img, verbose=True, **DEMO, **kw)
    want = _stages(capsys.readouterr().out)
    n = kw["n_iter"]
    assert got == want == ["init tensors"] + [
        f"{stage} {i}" for i in range(1, n + 1)
        for stage in ("blur estimation", "deblurring")]
    assert loud.dtype == quiet.dtype and np.array_equal(loud, quiet)


def test_tensor_batch_pixels_do_not_move(capsys):
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        size=(2, 3, 40, 56)).astype(np.float32))
    kw = dict(n_iter=2, method="fft", device="cpu", **DEMO, **FLAGS)
    loud = polyblur_deblurring(x, verbose=True, **kw)
    assert len(_stages(capsys.readouterr().out)) == 5
    assert torch.equal(loud, polyblur_deblurring(x, **kw))


def test_auto_tiled_route_prints_one_line(capsys, monkeypatch):
    """The auto-tiled route wraps the patch engine in one ``stage_timer``
    line (the JAX package's api.py:267-275); a plan is forced at a small
    size (the real one starts at 4 MP)."""
    monkeypatch.setattr(tapi, "_auto_tile_wanted", lambda h, w, cap: True)
    monkeypatch.setattr(tapi, "_auto_tile_plan",
                        lambda h, w, cap: (64, 16.0 / 64.0))
    img = _image(9, 96, 127)
    kw = dict(n_iter=1, device="cpu", **DEMO)
    quiet = polyblur_deblurring(img, **kw)
    capsys.readouterr()
    loud = polyblur_deblurring(img, verbose=True, **kw)
    assert _stages(capsys.readouterr().out) == [
        "polyblur_deblurring (auto-tiled, incl. any compile)"]
    assert loud.shape == img.shape and np.array_equal(loud, quiet)


def test_force_execution_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, size=(3, 5, 7)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(4,)).astype(np.float32)
    got = tprof.force_execution({"a": torch.as_tensor(a),
                                 "rest": (torch.as_tensor(b).bfloat16(), 3)})
    want = jprof.force_execution({"a": jnp.asarray(a),
                                  "rest": (jnp.asarray(b).astype(
                                      jnp.bfloat16), 3)})
    assert got == pytest.approx(want, rel=1e-6)


def test_stage_timer_records_and_prints(capsys):
    results = {}
    with tprof.stage_timer("stage", results):
        tprof.force_execution(torch.ones(3))
    assert results["stage"] >= 0.0
    assert capsys.readouterr().out.startswith("-- stage: ")
    with tprof.stage_timer("quiet", results, verbose=False):
        pass
    assert "quiet" in results and capsys.readouterr().out == ""


def test_trace_and_annotate_on_cpu(tmp_path):
    """``trace`` writes a Chrome trace holding the span ``annotate`` names
    and the call's operators."""
    @tprof.annotate("polyblur_span")
    def work(x):
        return (x * 2.0).sum()

    assert work.__name__ == "work"
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as prof:
        out = work(torch.ones(64, 64))
    assert float(out) == 8192.0
    names = {e.key for e in prof.key_averages()}
    assert "polyblur_span" in names
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "polyblur_span" for e in events)
