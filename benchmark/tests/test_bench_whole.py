"""A configuration restored whole: the program's entry called with the
configuration's own keywords, the reference without the tile grid held
against the program on the upstream demo's photo, and the sizes the work
counts get. The tiled configurations' calls are as they were."""

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import polyblur_ref
from benchmark.tests.conftest import ROOT
from benchmark.work import shapes

TILED = {
    "photo12mp_bf16.single": (torch.float32, {
        "patch_size": 400, "overlap": 0.25, "window_type": "kaiser",
        "work_dtype": torch.bfloat16, "out_dtype": torch.float32,
        "method": "direct_separable", "n_iter": 3, "c": 0.362, "b": 0.468,
        "alpha": 6.0, "beta": 1.0}),
    "photo2mp_flags_bf16.single": (torch.bfloat16, {
        "patch_size": 400, "overlap": 0.25, "window_type": "kaiser",
        "out_dtype": torch.float32, "method": "direct_separable",
        "n_iter": 3, "c": 0.362, "b": 0.468, "alpha": 6.0, "beta": 1.0,
        "remove_halo": True, "edgetaping": True, "prefiltering": True,
        "smoother": "domain_transform", "sigma_s": 2.0, "sigma_r": 0.8}),
}
TILED["photo2mp_flags_bf16.batch8"] = TILED["photo2mp_flags_bf16.single"]
WHOLE = (torch.float32, {"n_iter": 3, "c": 0.362, "b": 0.468, "alpha": 6.0,
                         "beta": 1.0, "method": "auto"})


@pytest.mark.parametrize("workload, want",
                         list(TILED.items()) + [("demo700k.single", WHOLE)])
def test_entry_gets_the_configurations_keywords(workload, want, monkeypatch,
                                                root):
    """What the entry receives: the tiled cells' dtypes as dtypes (the
    flags cell's batch cast to bf16 instead of a work dtype), the whole
    cell's call as its file states it; ``device`` in each."""
    seen = {}

    def entry(x, **kw):
        seen.update(dtype=x.dtype, kw=kw)

    _, _, config, _ = harness.cell(root, workload)
    module = type(harness)("probe")
    setattr(module, config["entry"].split(":")[1], entry)
    monkeypatch.setattr(harness.importlib, "import_module", lambda _: module)
    harness.entry_point(config, "cpu")(torch.zeros(1, 3, 4, 4))
    dtype, kw = want
    assert seen == {"dtype": dtype, "kw": dict(kw, device="cpu")}


def test_whole_reference_against_the_program_on_the_demo_photo(root):
    """The upstream demo (the 700 x 500 peacock, 3 iterations) through the
    program's plain path and the reference restoring it whole: every
    number far under the configuration's limits."""
    from PIL import Image

    from polyblur_torch import polyblur_deblurring

    _, _, config, _ = harness.cell(root, "demo700k.single")
    img = np.asarray(Image.open(ROOT / "tests" / "data"
                                / "peacock_defocus.png"))
    x = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    assert tuple(x.shape[-2:]) == (config["photo"]["height"],
                                   config["photo"]["width"])
    out = polyblur_deblurring(x, device="cpu", **config["call"])
    ref = polyblur_ref.restore(x, config)
    assert ref.shape == x.shape
    got = compare.worst([compare.errors(out, ref, x)])
    for name, limit in config["limits"].items():
        assert got[name] < limit / 5, (name, got[name], limit)


def test_tf32_rounds_ten_mantissa_bits_to_nearest_even():
    eps = 2.0 ** -10
    x = torch.tensor([1.0, 1 + eps / 2, 1 + 3 * eps / 2, 1 + eps + eps / 4,
                      -(1 + 3 * eps / 2), 0.75], dtype=torch.float64)
    want = [1.0, 1.0, 1 + 2 * eps, 1 + eps, -(1 + 2 * eps), 0.75]
    assert polyblur_ref.rounded(x, polyblur_ref.TF32).tolist() == want


def test_a_whole_photo_has_no_tiles(root):
    _, _, config, traffic = harness.cell(root, "demo700k.single")
    s = shapes.of_cell(config, traffic)
    assert s == shapes.Whole(1, 3, (500, 700))
    assert s.megapixels == pytest.approx(0.35)
    config["layout"] = "strips"
    with pytest.raises(ValueError, match="layout 'strips'"):
        shapes.of_cell(config, traffic)
