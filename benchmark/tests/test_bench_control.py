"""The check fails where it must: the control (the reference in the
precision below the configuration's, in the program's place) and each
fault the cells can have, with the harness's look for a card skipped and
the rest of a run driven as the benchmark drives it."""

import time

import pytest

from benchmark import harness, photos, train
from benchmark.tests.conftest import small

WORKLOADS = ("photo12mp_bf16.single", "photo2mp_flags_bf16.single",
             "photo2mp_flags_bf16.batch8", "demo700k.single")
TRAIN = "photo12mp_bf16.train_step"
SCALARS = train.SCALARS


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


# ---------------------------------------------- faults of a training step
# Each takes the step object (``benchmark.train.Program``), plants its
# fault in the program's layer, optimizer or loss, and returns it.

def _hook(program, scale, names=SCALARS):
    for name in names:
        getattr(program.layer, name).register_hook(lambda g: g * scale)
    return program


def step_skipped(program):
    """A step that returns its state unchanged: ``optimizer.step`` left
    out."""
    program.opt.step = lambda *args, **kw: None
    return program


def grads_zeroed(program):
    """The backward left out: every gradient zero."""
    return _hook(program, 0.0)


def grads_halved(program):
    """Every gradient halved."""
    return _hook(program, 0.5)


def grads_negated(program):
    """A backward of the wrong sign: every gradient negated."""
    return _hook(program, -1.0)


def ascent(program):
    """Adam climbing the loss (``maximize``) on the right gradients."""
    for group in program.opt.param_groups:
        group["maximize"] = True
    return program


def _one_zeroed(name):
    def fault(program):
        return _hook(program, 0.0, (name,))
    fault.__name__ = f"grad_zeroed_{name}"
    fault.__doc__ = f"The gradient of {name} alone zero."
    return fault


def rows_left_out(program):
    """Half of the batch left out, the mean taken over the rest: the loss
    over the first half of the photo's rows."""
    def loss(out, sharp):
        h = out.shape[-2] // 2
        return train.mse(out[..., :h, :], sharp[..., :h, :])
    program.loss_of = loss
    return program


def output_altered(program):
    """An answer altered where it is produced: one 128 x 128 region of the
    layer's output scaled by 0.9, before the loss."""
    forward = program.layer.forward

    def altered(x):
        out = forward(x).clone()
        out[0, :, 200:328, 300:428] *= 0.9
        return out
    program.layer.forward = altered
    return program


#: the faults a training cell can have (``benchmark/readings.py`` reads
#: them on the card)
TRAIN_FAULTS = (step_skipped, grads_zeroed, grads_halved, grads_negated,
                ascent, *map(_one_zeroed, SCALARS), rows_left_out,
                output_altered)


def faults_of(traffic: dict) -> tuple:
    """The faults of a cell with the traffic ``traffic``."""
    return TRAIN_FAULTS if photos.training(traffic) else FAULTS


@pytest.mark.parametrize("sut", ("control",) + TRAIN_FAULTS,
                         ids=lambda f: getattr(f, "__name__", f))
def test_training_control_and_faults_are_not_correct(sut, root):
    result = _run(TRAIN, sut, root)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS + (TRAIN,))
def test_control_is_not_correct_at_the_cells_size(workload, cuda, root):
    """The control at the cell's own size on the card."""
    result, _ = harness.run_cell(workload, 12345, 1.0, False,
                                 time.perf_counter(), root=root,
                                 sut="control")
    assert result["correct"] is False
