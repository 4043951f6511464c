"""Kernel forward, plain-replay backward: the autograd half of the kernels.

The JAX package makes each Pallas wrapper differentiable with a custom VJP
whose backward replays the XLA composition of the same function on the
saved inputs (e.g. polyblur_tpu/ops/pallas/polyblur_fused.py:806-845,
pad_cast.py:147-157, estimation.py:143-175). :func:`replay` is the port's
counterpart: one ``torch.autograd.Function`` whose forward runs a
wrapper's kernels and whose backward runs autograd of the wrapper's plain
PyTorch version on the saved inputs (not the outputs), recomputed under
``torch.enable_grad()`` and :func:`plain_versions`: plain PyTorch on the
tensors' device. The plain mode is the autograd thread's own
(``_build.plain_versions`` is thread-local): a forward another thread runs
meanwhile launches its kernels. A wrapper may give a backward of its own
instead (the blend's kernel, ``overlap_add.blend_overlap_add_backward``);
such a wrapper records no Function inside :func:`plain_versions`, where it
is its plain version.

The plain closure need not be the kernel's own function: the tiles and
canvas Functions with a feature flag replay the scan route on the same
tiles (``pipeline._ref_pipeline``), as the JAX package's flagged VJPs do.
Every kernel route of the package is differentiable this way; a bare
kernel wrapper given a tensor autograd records raises
(``_build.check_cuda``) rather than cut the graph.

Non-tensor arguments (tile geometry, tables, flags) are carried as
constants in the two closures. Without a graph to record (grad mode off,
or no input requiring grad) :func:`replay` calls the kernel closure
directly: a grad-free call launches exactly what it launched before and
builds no Function.
"""

from __future__ import annotations

import torch

from ._build import plain_versions

__all__ = ["replay", "records_graph"]


def records_graph(*tensors) -> bool:
    """Whether autograd records a graph through these tensors."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _Replay(torch.autograd.Function):
    """forward: ``kernel(*inputs)``; backward: ``backward(*inputs,
    *grads)`` where given, else autograd of ``plain(*inputs)`` recomputed
    from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, backward, *inputs):
        ctx.plain = plain
        ctx.backward_fn = backward
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        # unpack first, outside the plain mode: under checkpointing this may
        # recompute a region's forward, which runs as its forward did
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        if ctx.backward_fn is not None:
            got = ctx.backward_fn(*saved, *grads)
            return (None,) * 3 + tuple(g if n else None
                                       for g, n in zip(got, need))
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
        return (None,) * 3 + tuple(next(got) if n else None for n in need)


def replay(kernel, plain, *inputs, backward=None):
    """``kernel(*inputs)``, differentiable through ``plain`` or
    ``backward``.

    :param kernel: the wrapper's forward on these tensors (its kernels on
        CUDA tensors, its plain version on CPU ones)
    :param plain: the plain PyTorch version of the same function, built
        from differentiable operations only (no in-place writes into
        tensors it read); None where ``backward`` is given
    :param inputs: the tensors both closures take, in order; every other
        argument is a constant of the closures
    :param backward: ``backward(*inputs, *grads)`` -> a tuple of the
        inputs' gradients (bit-equal to autograd of the wrapper's plain
        version), in place of the replay of ``plain``
    """
    if records_graph(*inputs):
        return _Replay.apply(kernel, plain, backward, *inputs)
    return kernel(*inputs)
