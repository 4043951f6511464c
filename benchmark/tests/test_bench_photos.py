"""The seeded photo generator: deterministic, seed-dependent, sized as the
cells say."""

import pytest
import torch

from benchmark import harness, photos

CELLS = {"photo12mp_bf16.single": (4, 576e6),
         "photo2mp_flags_bf16.single": (12, 276.48e6),
         "photo2mp_flags_bf16.batch8": (4, 737.28e6),
         "demo700k.single": (65, 273e6),
         "photo12mp_bf16.train_step": (4, 576e6)}


def _small(workload, h=96, w=128):
    _, _, config, traffic = harness.cell(harness.ROOT, workload)
    config["photo"].update(height=h, width=w)
    return config, traffic


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_pool_sizes(workload, root):
    """Calls in the pool and bytes of the pool, worked out from the files
    alone (no full-size photo is made on the CPU): at least 4x the 50 MB
    L2 cache."""
    _, _, config, traffic = harness.cell(root, workload)
    n = photos.pool_calls(config, traffic)
    p = config["photo"]
    nbytes = n * traffic["batch"] * p["channels"] * p["height"] * p["width"] * 4
    assert (n, nbytes) == (CELLS[workload][0], pytest.approx(CELLS[workload][1]))
    assert nbytes >= 4 * 50e6


def test_same_seed_same_photos_other_seed_others():
    config, traffic = _small("photo2mp_flags_bf16.batch8")
    traffic.update(batch=2, pool_calls_min=2, pool_bytes_min=0)
    big = 2 ** 31 + 12345
    a = photos.make_pool(config, traffic, big, "cpu")
    b = photos.make_pool(config, traffic, big, "cpu")
    c = photos.make_pool(config, traffic, big + 1, "cpu")
    assert len(a) == 2 and a[0].shape == (2, 3, 96, 128)
    assert a[0].dtype == torch.float32
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(a, c):
        assert not torch.equal(x, y)
    # every photo of a pool has content of its own
    assert not torch.equal(a[0][0], a[0][1])
    assert not torch.equal(a[0][0], a[1][0])


def test_photos_in_range_with_texture():
    config, traffic = _small("photo12mp_bf16.single", 128, 160)
    x = photos.make_photo(photos.generator(7, "cpu"), config,
                          traffic["content"], "cpu")
    assert x.shape == (3, 128, 160)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert float(x.std()) > 0.05
