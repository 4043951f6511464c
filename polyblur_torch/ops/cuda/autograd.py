"""Kernel forward, plain-replay backward: the autograd half of the kernels.

The JAX package makes each Pallas wrapper differentiable with a custom VJP
whose backward replays the XLA composition of the same function on the
saved inputs (e.g. polyblur_tpu/ops/pallas/polyblur_fused.py:806-845,
pad_cast.py:147-157, estimation.py:143-175). :func:`replay` is the port's
counterpart: one ``torch.autograd.Function`` whose forward runs a
wrapper's kernels and whose backward runs autograd of the wrapper's plain
PyTorch version on the saved inputs (not the outputs), recomputed under
``torch.enable_grad()`` and :func:`plain_versions`. There are no backward
kernels: the backward is plain PyTorch on the tensors' device. The plain
mode is the autograd thread's own (``_build.plain_versions`` is
thread-local): a forward another thread runs meanwhile launches its
kernels.

Non-tensor arguments (tile geometry, tables, flags) are carried as
constants in the two closures. Without a graph to record (grad mode off,
or no input requiring grad) :func:`replay` calls the kernel closure
directly: a grad-free call launches exactly what it launched before and
builds no Function.
"""

from __future__ import annotations

import torch

from ._build import plain_versions

__all__ = ["replay", "records_graph", "refuse_graph", "TODO_BILATERAL",
           "TODO_IIR", "TODO_FLAGS"]

TODO_BILATERAL = "ROADMAP B.1 item 7 (the bilateral kernel's backward)"
TODO_IIR = "ROADMAP B.1 item 8 (the IIR kernel's backward)"
TODO_FLAGS = ("ROADMAP B.1 items 7-8 (the backward of the flag stages: "
              "prefilter, edgetaper, halo mask)")


def records_graph(*tensors) -> bool:
    """Whether autograd records a graph through these tensors."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_graph(what: str, todo: str, *tensors) -> None:
    """Raise ``NotImplementedError`` naming ``todo`` when autograd records
    a graph through ``tensors``: a route whose backward is not ported
    neither launches its kernels into a graph nor falls back to plain."""
    if records_graph(*tensors):
        raise NotImplementedError(f"{what}: gradients are not ported yet; "
                                  f"see {todo}")


class _Replay(torch.autograd.Function):
    """forward: ``kernel(*inputs)``; backward: autograd of
    ``plain(*inputs)`` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        # unpack first, outside the plain mode: under checkpointing this may
        # recompute a region's forward, which runs as its forward did
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad(), plain_versions():
            xs = [x.detach().requires_grad_(n) for x, n in zip(saved, need)]
            outs = ctx.plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None) + tuple(next(got) if n else None for n in need)


def replay(kernel, plain, *inputs):
    """``kernel(*inputs)``, differentiable through ``plain``.

    :param kernel: the wrapper's forward on these tensors (its kernels on
        CUDA tensors, its plain version on CPU ones)
    :param plain: the plain PyTorch version of the same function, built
        from differentiable operations only (no in-place writes into
        tensors it read)
    :param inputs: the tensors both closures take, in order; every other
        argument is a constant of the closures
    """
    if records_graph(*inputs):
        return _Replay.apply(kernel, plain, *inputs)
    return kernel(*inputs)
