"""Tracing and timing helpers, and the dispatch bookkeeping.

The reference's observability is wall-clock prints behind a ``verbose``
flag (deblurring.py:59-90) plus a warm-up-then-measure protocol
(main.py:117-128). Here, as in the JAX package's module of the same name:

* :func:`force_execution` — wait for the device to finish the tensors'
  work and return a checksum of them;
* :func:`stage_timer` — wall-clock a stage (the caller forces its
  outputs before the context exits);
* :func:`trace` — a ``torch.profiler`` trace of the host and, on CUDA,
  the device, exported as a Chrome trace;
* :func:`span` / :func:`annotate` — a span of that trace around a block
  or every call of a function (``torch.profiler.record_function``),
  recorded only while a torch profiler runs: without one, a span costs
  one check of the profiler's state and enters nothing. The program's
  spans (``pb.*``) mark its layer boundaries: the patch layer's
  ``pb.deblur_patches`` around ``pb.plan``, ``pb.pad``, ``pb.blend`` and
  the stage loop's ``pb.restore_tiles``, which holds ``pb.estimate``,
  ``pb.spectrum``, ``pb.prefilter``, ``pb.taper``, ``pb.polynomial`` and
  ``pb.halo``;
* :func:`record_dispatch` / :func:`dispatch_log` — which route each
  dispatch site chose, so route tests can pin the path a call took
  without a profiler. Unlike the JAX package (which records once per
  compilation), PyTorch runs eagerly, so an entry is recorded on every
  call.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time

import torch

__all__ = ["stage_timer", "trace", "span", "annotate", "force_execution",
           "record_dispatch", "dispatch_log", "reset_dispatch_log"]

_DISPATCH_LOG: collections.Counter = collections.Counter()


def record_dispatch(site: str, backend: str) -> None:
    """Record that dispatch site ``site`` selected ``backend``."""
    _DISPATCH_LOG[(site, backend)] += 1


def dispatch_log() -> dict:
    """{(site, backend): n_calls} since the last reset."""
    return dict(_DISPATCH_LOG)


def reset_dispatch_log() -> None:
    _DISPATCH_LOG.clear()


def _tensors(tree):
    """The tensors of a tensor, or of a (nested) tuple, list or dict."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def force_execution(tree) -> float:
    """Wait for the work producing every tensor of ``tree``; returns the
    sum of their absolute values in f32 (each read back with ``.item()``,
    after synchronizing each CUDA tensor's device)."""
    total = 0.0
    for t in _tensors(tree):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        total += float(t.detach().float().abs().sum().item())
    return total


@contextlib.contextmanager
def stage_timer(name: str, results: dict | None = None, verbose: bool = True):
    """Wall-clock a stage; optionally records the seconds into
    ``results[name]`` and prints ``-- name: <s>s``.

    The caller forces the stage's outputs (:func:`force_execution`) before
    the context exits; otherwise the time is the launches' alone.
    """
    start = time.perf_counter()
    yield
    dt = time.perf_counter() - start
    if results is not None:
        results[name] = dt
    if verbose:
        print(f"-- {name}: {dt:.5f}s")


@contextlib.contextmanager
def trace(logdir: str = "results/polyblur_trace"):
    """``torch.profiler`` trace of the enclosed work: the host and, where
    a CUDA device is available, the device. On exit the trace is written
    to ``logdir/trace.json`` (open it in Perfetto or
    ``chrome://tracing``). Yields the profiler, whose ``key_averages()``
    tabulates the spans."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


#: what :func:`span` returns while no profiler runs: one shared context
#: that does nothing, so an untraced span allocates nothing
_NO_SPAN = contextlib.nullcontext()
#: whether a torch profiler records on this thread (``torch.autograd.
#: _profiler_enabled``: the profiler's own state, one C call)
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """Context manager naming the enclosed block as the span ``name`` in a
    running ``torch.profiler`` trace (``torch.profiler.record_function``);
    while none runs, a context that does nothing. The spans are kept by
    the profiler and exported by whoever runs it."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def annotate(name: str):
    """Decorator naming every call of a function as the span ``name`` in
    a :func:`trace` (:func:`span`: nothing is entered while no profiler
    runs)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco
