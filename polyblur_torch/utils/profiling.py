"""Dispatch bookkeeping: which route each dispatch site chose.

Route tests read :func:`dispatch_log` to pin the path a call took without a
profiler. Unlike the JAX package (which records once per compilation),
PyTorch runs eagerly, so an entry is recorded on every call.
"""

from __future__ import annotations

import collections

__all__ = ["record_dispatch", "dispatch_log", "reset_dispatch_log"]

_DISPATCH_LOG: collections.Counter = collections.Counter()


def record_dispatch(site: str, backend: str) -> None:
    """Record that dispatch site ``site`` selected ``backend``."""
    _DISPATCH_LOG[(site, backend)] += 1


def dispatch_log() -> dict:
    """{(site, backend): n_calls} since the last reset."""
    return dict(_DISPATCH_LOG)


def reset_dispatch_log() -> None:
    _DISPATCH_LOG.clear()
