"""Each cell end to end at a small size on the CPU, through the port's
plain path: the result line has the shape a run prints, in both modes."""

import json
import math
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import small

#: the routes one call of each cell takes, by the program's dispatch log:
#: the patch engine's staged tiles, or the whole photo through the scan
#: route, with the blocked polynomial and the plain directional maxima
#: (both past 640 px) in each of its 3 iterations
ROUTES = {
    "photo12mp_bf16.single": {"deblur_patches:staged_tiles": 1},
    "photo2mp_flags_bf16.single": {"deblur_patches:staged_tiles": 1},
    "photo2mp_flags_bf16.batch8": {"deblur_patches:staged_tiles": 1},
    "demo700k.single": {"polyblur_core:scan/direct_separable": 1,
                        "inverse_filtering_rank3:separable_fast": 3,
                        "compute_polynomial_separable:prepad": 3,
                        "compute_polynomial_separable:blocked": 3,
                        "directional_maxima:plain": 3}}
WORKLOADS = tuple(ROUTES)


def _line(result) -> dict:
    """The result as its printed line reads back."""
    return json.loads(json.dumps(result))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_reports(workload, trace, root):
    result, info = harness.run_cell(workload, 2 ** 31 + 7, 0.3, bool(trace),
                                    time.perf_counter(), root=root,
                                    device="cpu", shrink=small)
    line = _line(result)
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
    bench = harness.load_json(root / "BENCHMARK.json")
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
        assert math.isfinite(m["value"]) and m["value"] > 0
    if trace:
        # on the CPU no device operation runs: only the host's metric
        assert set(line["metrics"]) == {"host_ms_per_call"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        assert {"mp_per_s", "setup_s"} <= set(line["metrics"])
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # every call of the window took its cell's route
    assert info["route"] == {k: n * line["attempted"]
                             for k, n in ROUTES[workload].items()}


#: each tiled cell's check numbers at the tests' size on one seed, with a
#: window of one call and one CPU thread: what the harness read before a
#: traffic could state a training job, on the same tree otherwise. Stating
#: one changes neither the photos nor the check of the cells that state
#: none.
BEFORE_TRAINING = {
    "photo12mp_bf16.single": {"rms_err": 0.008285107734084573,
                              "block_rms_err": 0.010455295292088298,
                              "gain_err": 0.009355487778190619},
    "photo2mp_flags_bf16.single": {"rms_err": 0.005950881665835648,
                                     "block_rms_err": 0.007254409744731023,
                                     "gain_err": 0.012078634963390344},
    "photo2mp_flags_bf16.batch8": {"rms_err": 0.006237017389828232,
                                     "block_rms_err": 0.008072736494957147,
                                     "gain_err": 0.012630727359869587}}


@pytest.mark.parametrize("workload", sorted(BEFORE_TRAINING))
def test_check_numbers_as_before_training_cells(workload, one_thread):
    result, _ = harness.run_cell(workload, 2 ** 31 + 7, 0.0, False,
                                 time.perf_counter(), device="cpu",
                                 shrink=small)
    assert result["attempted"] == 1
    assert {k: c["value"] for k, c in result["checks"].items()} == \
        BEFORE_TRAINING[workload]
