"""The check fails where it must: the control (the reference in the
precision below the configuration's, in the program's place) and each
fault the cells can have, with the harness's look for a card skipped and
the rest of a run driven as the benchmark drives it."""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import small

WORKLOADS = ("photo12mp_bf16.single", "photo2mp_flags_bf16.single",
             "photo2mp_flags_bf16.batch8")


def _run(workload, sut, seed=11):
    result, _ = harness.run_cell(workload, seed, 0.2, False,
                                 time.perf_counter(), device="cpu",
                                 shrink=small, sut=sut)
    return result


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    result = _run(workload, "control")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def unchanged(program):
    """The restoration returns its input: no iteration changed the state."""
    return lambda x: x[..., :x.shape[-2] // 2 * 2, :x.shape[-1] // 2 * 2].clone()


def half_left_out(program):
    """Half of the batch's work left out: the second half of the photos
    (of the rows, for one photo) returned as they came in."""
    def call(x):
        out = program(x).clone()
        if x.shape[0] > 1:
            out[x.shape[0] // 2:] = x[x.shape[0] // 2:, :, :out.shape[-2],
                                      :out.shape[-1]]
        else:
            h = out.shape[-2] // 2
            out[..., h:, :] = x[..., h:out.shape[-2], :out.shape[-1]]
        return out
    return call


def tile_altered(program):
    """One answer altered where it is produced: one 128 x 128 region of
    the first photo scaled by 0.9."""
    def call(x):
        out = program(x).clone()
        out[0, :, 200:328, 300:428] *= 0.9
        return out
    return call


@pytest.mark.parametrize("fault", [unchanged, half_left_out, tile_altered])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    assert _run(workload, fault)["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_the_cells_size(workload, cuda):
    """The control at the cell's own size on the card."""
    result, _ = harness.run_cell(workload, 12345, 1.0, False,
                                 time.perf_counter(), sut="control")
    assert result["correct"] is False
