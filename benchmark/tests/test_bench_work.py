"""The work counts against the bounds ``chip_smoke.py`` printed."""

import pytest

from benchmark.work import blend_pad, estimate, features, restore, shapes
from benchmark.work.counts import bound_ms, gradient_flops

CFG4 = {"photo": {"height": 3000, "width": 4000, "channels": 3},
        "call": {"patch_size": 448, "overlap": 64 / 448,
                 "work_dtype": "bfloat16", "n_iter": 3}}
CFG2 = {"photo": {"height": 1200, "width": 1600, "channels": 3},
        "call": dict(CFG4["call"], remove_halo=True, edgetaping=True,
                     prefiltering=True, smoother="domain_transform")}


def test_main_path_bound_is_chip_smokes():
    """chip_smoke's "main path bound: 0.6329 ms": each kernel row's bound
    (PERF.md's table: pad 0.0671, estimate 0.0443, spectrum 0.0254, one
    application 0.0887, blend 0.0907) times its calls."""
    s = shapes.of_cell(CFG4, {"batch": 1})
    assert (s.n, s.h, s.canvas) == (88, 472, (3136, 4288))
    assert blend_pad.pad_ms(s) == pytest.approx(0.0671, abs=5e-5)
    assert estimate.per_call_ms(s) / 3 == pytest.approx(0.0443, abs=5e-5)
    assert restore._spectrum_ms(s) == pytest.approx(0.0254, abs=5e-5)
    assert restore.per_call_ms(s) / 3 == pytest.approx(0.0254 + 0.0887,
                                                       abs=1e-4)
    assert blend_pad.blend_ms(s) == pytest.approx(0.0907, abs=5e-5)
    total = (blend_pad.pad_ms(s) + estimate.per_call_ms(s)
             + restore.per_call_ms(s) + blend_pad.blend_ms(s))
    assert round(total, 4) == 0.6329


def test_features_count_is_chip_smokes_at_one_iteration():
    """At one iteration the features count is chip_smoke's config 2 rows:
    the dt stage 0.0207 ms and the halo (gradients and one mask) 0.0337
    ms, both by bytes, beside the taper weights' few microseconds."""
    one = dict(CFG2, call=dict(CFG2["call"], n_iter=1))
    s = shapes.of_cell(one, {"batch": 1})
    dt = bound_ms(s.canvas_el * 2 + 2 * s.tile_el * 4,
                  26.0 * s.n * s.p * s.p + 13.0 * s.tile_el, "f32")
    halo = bound_ms(s.canvas_el * 2 + s.tile_el * 14,
                    s.planes * 2 * gradient_flops(448, 448)
                    + 20.0 * s.tile_el, "f32")
    assert dt == pytest.approx(0.0207, abs=5e-5)
    assert halo == pytest.approx(0.0337, abs=5e-5)
    assert features.per_call_ms(s) == pytest.approx(0.0207 + 0.0337,
                                                    abs=2e-4)


def test_counts_scale_with_the_cell():
    """Iterations, flags and the batch scale the counts; no flag, no
    features."""
    s4 = shapes.of_cell(CFG4, {"batch": 1})
    s2 = shapes.of_cell(CFG2, {"batch": 1})
    s8 = shapes.of_cell(CFG2, {"batch": 8})
    assert features.per_call_ms(s4) is None
    assert s2.n == 12 and s8.n == 96 and s8.megapixels == 8 * 1.92
    for layer in (estimate, restore, features):
        assert layer.per_call_ms(s8) == pytest.approx(
            8 * layer.per_call_ms(s2), rel=0.02)
    # the taper's three f32 blurs and its spectrum: over 3x the work of
    # the same photo without flags
    plain2 = shapes.of_cell(dict(CFG2, call=CFG4["call"]), {"batch": 1})
    assert restore.per_call_ms(s2) > 3 * restore.per_call_ms(plain2)
