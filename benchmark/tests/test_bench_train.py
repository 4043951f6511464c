"""A training cell: its pool, a run of it, and the reference's gradients,
on the CPU at the tests' size."""

import time

import pytest
import torch

from benchmark import harness, photos, train
from benchmark.reference import polyblur_ref
from benchmark.tests.conftest import small

TRAIN = "photo12mp_bf16.train_step"


def _cell(root, workload, shrink=small):
    _, _, config, traffic = harness.cell(root, workload)
    shrink(config, traffic)
    return config, traffic


def test_training_pool_pairs_the_single_cells_photos(root, one_thread):
    """The blurry photos are bit-equal to those of the same configuration's
    single cell on the same seed; each has its sharp photo in [0, 1]."""
    seed = 2 ** 31 + 99
    config, traffic = _cell(root, TRAIN)
    pairs = photos.make_pool(config, traffic, seed, "cpu")
    config, traffic = _cell(root, "photo12mp_bf16.single")
    singles = photos.make_pool(config, traffic, seed, "cpu")
    assert len(pairs) == len(singles) == 2
    for (blurry, sharp), single in zip(pairs, singles):
        assert torch.equal(blurry, single)
        assert sharp.shape == blurry.shape and sharp.dtype == torch.float32
        assert float(sharp.min()) >= 0.0 and float(sharp.max()) <= 1.0
        assert float((sharp - blurry).abs().mean()) > 0.005


@pytest.mark.parametrize("trace", [0, 1])
def test_a_training_run_is_correct(trace, root):
    result, info = harness.run_cell(TRAIN, 2 ** 31 + 5, 0.3, bool(trace),
                                    time.perf_counter(), root=root,
                                    device="cpu", shrink=small)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {
        "rms_err", "block_rms_err", "gain_err", "loss_rel_err",
        "loss_own_err", "grad_err", "change_err", "unmoved"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name
    assert result["checks"]["unmoved"]["value"] == 0
    if trace:
        # no device: only the host's time a step has a reading
        assert set(result["metrics"]) == {"host_ms_per_call"}
    else:
        assert {"mp_per_s", "setup_s"} <= set(result["metrics"])
    assert info["route"] == {"deblur_patches:staged_tiles":
                             result["attempted"]}


def test_checked_steps_may_run_into_the_window(root):
    """With one warm-up step the second checked step is the window's
    first, on the pool's first pair again: the reference follows the pairs
    the steps took."""
    def shrink(config, traffic):
        small(config, traffic)
        traffic.update(warmup_calls=1)

    result, _ = harness.run_cell(TRAIN, 2 ** 31 + 6, 0.3, False,
                                 time.perf_counter(), root=root,
                                 device="cpu", shrink=shrink)
    assert result["correct"] is True and result["attempted"] >= 1


def _pair(root, h=96, w=128, seed=3):
    config, traffic = _cell(root, TRAIN)
    config["photo"].update(height=h, width=w)
    config["call"].update(patch_size=64)
    return config, photos.make_pool(config, traffic, seed, "cpu")[0]


def test_blocked_gradients_equal_unblocked(root):
    config, (blurry, sharp) = _pair(root)
    start = {k: float(config["call"][k]) for k in train.SCALARS}
    tiles = len(polyblur_ref.plan(96, 128, 64, 0.25).origins())
    assert tiles > 2
    one = polyblur_ref.loss_and_grads(blurry, sharp, config, start, block=1)
    every = polyblur_ref.loss_and_grads(blurry, sharp, config, start,
                                        block=tiles)
    assert one[0] == every[0] and torch.equal(one[2], every[2])
    for k in train.SCALARS:
        assert one[1][k] == pytest.approx(every[1][k], rel=1e-12, abs=0)


def test_gradients_match_central_differences(root, monkeypatch):
    """With no storage rounding the reference's loss is float64 throughout:
    its autograd gradient in each scalar against central differences, at a
    size where no blur direction's argmin turns within a step."""
    monkeypatch.setattr(polyblur_ref, "_round", lambda x, dtype: x)
    config, (blurry, sharp) = _pair(root)
    start = {k: float(config["call"][k]) for k in train.SCALARS}
    _, grads, _, _ = polyblur_ref.loss_and_grads(blurry, sharp, config, start)
    for k in train.SCALARS:
        h = 1e-5 * abs(start[k])
        up, down = (polyblur_ref.loss_and_grads(
            blurry, sharp, config, dict(start, **{k: start[k] + d}))[0]
            for d in (h, -h))
        assert grads[k] == pytest.approx((up - down) / (2 * h), rel=1e-6), k
