"""A cell whose calls are training steps, and the check of its first steps.

A training traffic (``"job": "train"``) states Adam's hyperparameters
and whether the layer recomputes its iterations (``remat``); the
configuration states the call, whose four scalars (c, b, alpha, beta) are
the starting point of the learnable ones. One call of the cell is one
step of the program's own training path on the next (blurry, sharp) pair
of the pool:
``PolyblurLayer(learnable=True)`` on the configuration's tile grid and
dtypes, ``torch.optim.Adam`` over its parameters, and
``polyblur_torch.training.make_train_step`` with the float32 mean squared
error of the output against the sharp photos.

The step object is built once, and its first ``check_calls`` steps (in
``train_step.json`` the set-up's warm-up steps, on pairs that all differ)
record what the check reads: each step's pair, loss and output, the first
gradient as the optimizer holds it after one step (Adam's first moment
over ``1 - beta1``), and the parameters after the last of them. The same
object then runs the window. Once the window has closed the reference
(:class:`Reference`: ``reference.polyblur_ref.loss_and_grads``, float64
autograd of the same loss, storing in float32) follows the same steps from
the same start under its own float64 Adam, and
``compare.training_numbers`` holds the two apart.
"""

from __future__ import annotations

import torch

from . import compare
from .reference import polyblur_ref

SCALARS = polyblur_ref.SCALARS


def mse(out: torch.Tensor, sharp: torch.Tensor) -> torch.Tensor:
    """The float32 mean squared error of ``out`` against ``sharp`` cropped
    as ``out`` is."""
    h, w = out.shape[-2:]
    return torch.mean((out.float() - sharp[..., :h, :w]) ** 2)


def adam(params, traffic: dict) -> torch.optim.Adam:
    """Adam over ``params`` with the traffic's hyperparameters."""
    o = traffic["adam"]
    return torch.optim.Adam(params, lr=o["lr"], betas=tuple(o["betas"]),
                            eps=o["eps"])


class Recorder:
    """What the check reads of a step object's first ``n`` steps: the
    scalars at the start, each step's pair, loss and output, the first
    gradient as the optimizer holds it, the scalars after step ``n``; and,
    of the reference, the first gradient's mass."""

    def __init__(self, params: dict, opt, n: int):
        self.params, self.opt, self.n = params, opt, n
        self.start = self.scalars()
        self.pairs, self.losses, self.outputs = [], [], []
        self.first_grads = self.after = self.mass = None

    def scalars(self) -> dict:
        return {k: float(p.detach()) for k, p in self.params.items()}

    def pair(self, pair) -> None:
        if len(self.pairs) < self.n:
            self.pairs.append(pair)

    def output(self, out: torch.Tensor) -> None:
        if len(self.outputs) < self.n:
            self.outputs.append(out.detach().float())

    def stepped(self, loss: torch.Tensor) -> None:
        if len(self.losses) >= self.n:
            return
        self.losses.append(float(loss))
        if len(self.losses) == 1:
            beta1 = self.opt.defaults["betas"][0]
            self.first_grads = {
                k: (float(self.opt.state[p]["exp_avg"]) / (1.0 - beta1)
                    if "exp_avg" in self.opt.state.get(p, {}) else 0.0)
                for k, p in self.params.items()}
        if len(self.losses) == self.n:
            self.after = self.scalars()


class Program:
    """The program's training step: call it with a (blurry, sharp) pair.
    ``layer``, ``opt`` and ``loss_of`` are there to be planted with faults
    (``benchmark/tests/test_bench_control.py``)."""

    def __init__(self, config: dict, traffic: dict, device):
        from polyblur_torch import PolyblurLayer
        from polyblur_torch.training import make_train_step

        call = config["call"]
        extra = {"window_type": call["window_type"],
                 "work_dtype": polyblur_ref.DTYPES[call["work_dtype"]],
                 "out_dtype": polyblur_ref.DTYPES[call["out_dtype"]]}
        if call["cast_input"]:
            raise ValueError("a training cell takes its photos in float32")
        self.layer = PolyblurLayer(
            n_iter=call["n_iter"], **{k: call[k] for k in SCALARS},
            learnable=True, method=call["method"], remat=traffic["remat"],
            patch_size=call["patch_size"], patch_overlap=call["overlap"],
            extra=extra, device=device)
        params = {k: getattr(self.layer, k) for k in SCALARS}
        self.opt = adam(list(params.values()), traffic)
        self.loss_of = mse
        self.record = Recorder(params, self.opt, traffic["check_calls"])
        self.step = make_train_step(self.layer, self.opt, self._loss)

    def _loss(self, out, sharp):
        self.record.output(out)
        return self.loss_of(out, sharp)

    def __call__(self, pair):
        self.record.pair(pair)
        loss = self.step(*pair)
        self.record.stepped(loss)
        return loss


class Reference:
    """The reference's training step in the program's place: each step's
    loss, gradients, their mass (after the first step: ``record.mass``)
    and output from ``polyblur_ref.loss_and_grads`` storing in ``work``,
    under the traffic's Adam on parameters of ``dtype`` from ``start``.
    Storing in the configuration's ``control_dtype`` on float32
    parameters, it is the control."""

    def __init__(self, config: dict, traffic: dict, device, start: dict,
                 work=torch.float32, dtype=torch.float64):
        self.config, self.work = config, work
        self.params = {k: torch.nn.Parameter(torch.tensor(
            float(start[k]), dtype=dtype, device=device)) for k in SCALARS}
        self.opt = adam(list(self.params.values()), traffic)
        self.record = Recorder(self.params, self.opt, traffic["check_calls"])

    def __call__(self, pair):
        self.record.pair(pair)
        blurry, sharp = pair
        loss, grads, out, mass = polyblur_ref.loss_and_grads(
            blurry, sharp, self.config, self.record.scalars(), self.work)
        for k, p in self.params.items():
            p.grad = torch.tensor(grads[k], dtype=p.dtype, device=p.device)
        self.opt.step()
        if not self.record.losses:
            self.record.mass = mass
        self.record.output(out)
        loss = torch.tensor(loss)
        self.record.stepped(loss)
        return loss


def control(config: dict, traffic: dict, device) -> Reference:
    """The control: the reference storing in ``control_dtype``, from the
    call's scalars, on float32 parameters."""
    return Reference(config, traffic, device, config["call"],
                     polyblur_ref.DTYPES[config["control_dtype"]],
                     torch.float32)


def check(job, config: dict, traffic: dict) -> dict:
    """The numbers of the training check: the reference's steps from the
    program's start on the pairs the program's steps took, in their order,
    the steps' outputs against the reference's (``compare.errors``), and
    ``compare.training_numbers`` with the float64 loss of each step's own
    output."""
    got = job.record
    if got.after is None:
        raise RuntimeError("the step object ran fewer steps than it checks")
    ref = Reference(config, traffic, got.pairs[0][0].device, got.start)
    for pair in got.pairs:
        ref(pair)
    ref = ref.record
    readings, own = [], []
    for (blurry, sharp), o, r in zip(got.pairs, got.outputs, ref.outputs):
        h, w = r.shape[-2:]
        readings.append(compare.errors(o, r, blurry[..., :h, :w]))
        own.append(float(((o.double() - sharp[..., :h, :w]) ** 2).mean()))
    return dict(compare.worst(readings),
                **compare.training_numbers(got, ref, own))
