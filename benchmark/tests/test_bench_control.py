"""The check fails where it must: the control (the reference in the
precision below the configuration's, in the program's place) and each
fault the cells can have, with the harness's look for a card skipped and
the rest of a run driven as the benchmark drives it."""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import small

WORKLOADS = ("photo12mp_bf16.single", "photo2mp_flags_bf16.single",
             "photo2mp_flags_bf16.batch8", "demo700k.single")


def _run(workload, sut, root, seed=11):
    result, _ = harness.run_cell(workload, seed, 0.2, False,
                                 time.perf_counter(), root=root, device="cpu",
                                 shrink=small, sut=sut)
    return result


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, root):
    result = _run(workload, "control", root)
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


#: the faults the cells can have (``benchmark/readings.py`` reads them on
#: the card)
FAULTS = (unchanged, half_left_out, tile_altered)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault, root):
    assert _run(workload, fault, root)["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_the_cells_size(workload, cuda, root):
    """The control at the cell's own size on the card."""
    result, _ = harness.run_cell(workload, 12345, 1.0, False,
                                 time.perf_counter(), root=root,
                                 sut="control")
    assert result["correct"] is False
