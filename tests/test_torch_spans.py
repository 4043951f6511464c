"""The port's spans at its layer boundaries (``utils.profiling.span``).

A staged ``deblur_patches`` call opens ``pb.*`` spans: the patch layer's
(``pb.deblur_patches`` around ``pb.plan``, ``pb.pad``, ``pb.blend``) and
the stage loop's (``pb.restore_tiles`` around the per-iteration stages).
They record only while a torch profiler runs, leave the output as it is,
and without a profiler enter nothing.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from polyblur_torch.patches import deblur_patches
from polyblur_torch.utils import profiling

CALL = "test.call"
#: the 12 MP cell's call and the flags cells' call, at a tiny size
BASE = dict(patch_size=64, overlap=0.25, method="direct_separable",
            n_iter=2, c=0.362, b=0.468, alpha=6.0, beta=1.0,
            work_dtype=torch.bfloat16, out_dtype=torch.float32)
FLAGS = dict(remove_halo=True, edgetaping=True, prefiltering=True,
             smoother="domain_transform")
CASES = {"no_flags": BASE, "every_flag": dict(BASE, **FLAGS)}

PATCHES = ("pb.plan", "pb.pad", "pb.restore_tiles", "pb.blend")
STAGES = ("pb.estimate", "pb.spectrum", "pb.prefilter", "pb.taper",
          "pb.polynomial", "pb.halo")


def _image():
    g = torch.Generator().manual_seed(22)
    return torch.rand((1, 3, 96, 128), generator=g)


def _spans(prof) -> list:
    """[(name, name of the nearest enclosing pb.* or call span)] of the
    trace's pb.* spans, in the order they opened."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("pb."):
            continue
        p = e.cpu_parent
        while p is not None and not (p.name.startswith("pb.")
                                     or p.name == CALL):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_at_the_layer_boundaries(case, monkeypatch):
    kw = CASES[case]
    x = _image()
    want = deblur_patches(x, device="cpu", **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            got = deblur_patches(x, device="cpu", **kw)
    assert torch.equal(got, want)

    spans = _spans(prof)
    parents = dict(spans)
    assert parents["pb.deblur_patches"] == CALL
    for name in PATCHES:
        assert parents[name] == "pb.deblur_patches", name
    count = {}
    for name, parent in spans:
        count[name] = count.get(name, 0) + 1
        if name in STAGES:
            assert parent == "pb.restore_tiles", name
    n = kw["n_iter"]
    flagged = case == "every_flag"
    assert count == {
        "pb.deblur_patches": 1, "pb.plan": 2, "pb.pad": 1, "pb.blend": 1,
        "pb.restore_tiles": 1, "pb.estimate": n, "pb.spectrum": n,
        "pb.polynomial": n,
        # the halo's gradients once, its mask each iteration
        **({"pb.prefilter": n, "pb.taper": n, "pb.halo": n + 1}
           if flagged else {})}

    # without a profiler no span is entered: a record_function that
    # raises is never reached
    def refuse(name):
        raise RuntimeError(f"span {name} entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert torch.equal(deblur_patches(x, device="cpu", **kw), want)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="pb.deblur_patches"):
            deblur_patches(x, device="cpu", **kw)


def test_span_is_one_shared_no_op_without_a_profiler():
    assert profiling.span("a") is profiling.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pb.test"):
            torch.ones(4).sum()
    assert "pb.test" in {e.name for e in prof.events()}
