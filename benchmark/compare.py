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

A training cell's first steps (``benchmark.train``) are judged on their
outputs by the numbers above, against the reference's at its own scalars,
and on four more, which its configuration's ``train_limits`` name:

* ``loss_rel_err``: the worst step's ``|loss - reference's| /
  reference's``;
* ``loss_own_err``: the worst step's ``|loss - L| / L``, ``L`` the
  float64 mean squared error of the step's own output against the sharp
  photos: the loss the step reports and descends is that of all of its
  output (a loss over part of it, such as half of the rows, reads some
  percent off; float32 summation some 1e-7);
* ``grad_err``: the first gradient as the optimizer holds it, by the
  worst steady scalar: the gap between the program's value and the
  reference's, sign and all, over the larger of the reference's magnitude
  and the median scalar's (one gradient can be 20 times another, so that
  a share of the largest would pass over a small one left out; a gradient
  of the wrong sign reads 2);
* ``change_err``: the same of each steady scalar's change over the steps
  (Adam moves a scalar by about its rate whatever the gradient's size, so
  that the change's sign is what tells a descent from an ascent);
* ``unmoved``: how many scalars whose reference gradient is not nought to
  rounding (at least a thousandth of the median's) the steps left exactly
  where they started (a skipped optimizer step, a gradient left out),
  against the limit 0.

A scalar is steady where its reference gradient is at least
:data:`RESIDUE` of its mass, the sum of the magnitudes of the tiles'
shares: where it is less, it is what is left of shares that cancel, and
the storage precision decides it. On 12 MP photos in bf16 c's and b's
gradients are mostly such residues and move by tens of percent, their
sign too (as does the reference's own when it stores in bf16), while
alpha's and beta's keep most of their mass and move by a few percent.
A residue is held only by ``unmoved``: an error in it that leaves it
non-zero and the outputs within their limits passes.
"""

from __future__ import annotations

import statistics

import torch

BLOCK = 64
#: the numbers of one sampled output, each the worst over its photos
WORST = ("rms_err", "block_rms_err", "gain_err")
#: the numbers of a training cell's steps (:func:`training_numbers`)
TRAINING = ("loss_rel_err", "loss_own_err", "grad_err", "change_err",
            "unmoved")
NAMES = WORST + ("median_rms_err",) + TRAINING
#: a scalar whose reference gradient is under this share of the median
#: scalar's moves by round-off alone under Adam
NOUGHT = 1e-3
#: the least share of its mass that a steady scalar's gradient keeps
RESIDUE = 0.8


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


def leaf_gap(got: dict, ref: dict, names) -> float:
    """The worst of ``names``: ``|got - ref|`` over the larger of ``|ref|``
    and the median of ``|ref|`` over every scalar."""
    med = statistics.median(abs(v) for v in ref.values())
    return max(abs(got[k] - ref[k]) / max(abs(ref[k]), med) for k in names)


def training_numbers(got, ref, own: list) -> dict:
    """The numbers of :data:`TRAINING` of the program's first steps
    ``got`` against the reference's ``ref`` (``benchmark.train.Recorder``
    each: the losses, the first gradients, the scalars at the start and
    after the steps; the reference's with the first gradients' ``mass``),
    ``own`` the losses of the program's own outputs."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    owns = [abs(a - b) / abs(b) for a, b in zip(got.losses, own)]
    g = ref.first_grads
    med = statistics.median(abs(v) for v in g.values())
    moving = [k for k in g if abs(g[k]) >= NOUGHT * med]
    share = {k: abs(g[k]) / ref.mass[k] if ref.mass[k] else 0.0 for k in g}
    steady = ([k for k in g if share[k] >= RESIDUE]
              or [max(share, key=share.get)])
    change = [{k: r.after[k] - r.start[k] for k in g} for r in (got, ref)]
    return {"loss_rel_err": max(losses), "loss_own_err": max(owns),
            "grad_err": leaf_gap(got.first_grads, g, steady),
            "change_err": leaf_gap(*change, steady),
            "unmoved": float(sum(got.after[k] == got.start[k]
                                 for k in moving))}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number the limits name
    at or under its limit."""
    unknown = set(limits) - set(NAMES)
    if unknown:
        raise ValueError(f"limits of no number: {sorted(unknown)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in NAMES if k in limits}
    return all(numbers[k] <= limits[k] for k in checks), checks
