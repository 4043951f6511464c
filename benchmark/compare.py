"""The comparison that decides ``correct``.

Each sampled output of the timed calls is held against the reference's
restoration of the same photos (``reference.polyblur_ref``). Two numbers,
each against the limit its configuration file states:

* ``rms_err``: the worst photo's root-mean-square difference over all its
  pixels and channels;
* ``block_rms_err``: the worst 64 x 64 block's, over every photo checked,
  so that a fault in one tile (a wrong blur estimate, a tile left out or
  altered) shows although the photo's mean dilutes it;
* ``gain_err``: the worst photo's ``|1 - g|``, with ``g`` the share of the
  reference's change to the photo that the output makes, ``<out - x, ref
  - x> / <ref - x, ref - x>``: 1 for an output that restores as the
  reference does, 0 for one that returns its input. With every flag on
  the restoration changes a photo little, so that the two differences
  above tell a photo left as it came in from a restored one only narrowly;
* ``median_rms_err``: the median photo's ``rms_err`` over every photo
  checked. Where the program computes in float32 the worst photo is no
  measure of its precision: on a near-tie of the blur estimate's two
  smallest interpolated maxima (closer than float32 resolves) the program
  and the float64 reference pick neighbouring directions, 6 degrees
  apart, and that photo alone differs by ten times the others. The median
  passes over such a photo and still reads a precision lost on every
  photo.

A configuration's ``limits`` name the numbers it is judged by.
"""

from __future__ import annotations

import statistics

import torch

BLOCK = 64
#: the numbers of one sampled output, each the worst over its photos
WORST = ("rms_err", "block_rms_err", "gain_err")
NAMES = WORST + ("median_rms_err",)


def errors(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor) -> dict:
    """The numbers for (B, C, h, w) outputs ``out`` of the photos ``x``
    (cropped as the outputs are) against the reference's ``ref``."""
    if not out.shape == ref.shape == x.shape:
        raise ValueError(f"output {tuple(out.shape)} against reference "
                         f"{tuple(ref.shape)} of photos {tuple(x.shape)}")
    out, ref, x = (t.to(torch.float64) for t in (out, ref, x))
    e2 = (out - ref) ** 2
    if not bool(torch.isfinite(e2).all()):
        return dict(dict.fromkeys(WORST, float("inf")),
                    photo_rms=[float("inf")] * len(e2))
    rms = e2.mean((1, 2, 3)).sqrt()
    h, w = e2.shape[-2:]
    ph, pw = -h % BLOCK, -w % BLOCK
    s = torch.nn.functional.pad(e2.sum(1, keepdim=True), (0, pw, 0, ph))
    ones = torch.nn.functional.pad(torch.ones_like(e2[:, :1]), (0, pw, 0, ph))
    total = torch.nn.functional.avg_pool2d(s, BLOCK)
    count = torch.nn.functional.avg_pool2d(ones, BLOCK) * e2.shape[1]
    block = (total / count).sqrt()
    change = ref - x
    g = ((out - x) * change).sum((1, 2, 3)) / (change * change).sum((1, 2, 3))
    return {"rms_err": float(rms.max()), "block_rms_err": float(block.max()),
            "gain_err": float((1.0 - g).abs().max()),
            "photo_rms": rms.tolist()}


def worst(readings: list) -> dict:
    """Each number over several :func:`errors` readings: the largest of
    each worst case, the median of every photo's ``rms_err``."""
    numbers = {k: max(r[k] for r in readings) for k in WORST}
    numbers["median_rms_err"] = statistics.median(
        v for r in readings for v in r["photo_rms"])
    return numbers


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number the limits name
    at or under its limit."""
    unknown = set(limits) - set(NAMES)
    if unknown:
        raise ValueError(f"limits of no number: {sorted(unknown)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in NAMES if k in limits}
    return all(numbers[k] <= limits[k] for k in checks), checks
