"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
under ``build/polyblur_torch/`` at the repository root, keyed on a hash of
the sources and flags. The first call that needs a library builds it; the
sources are compiled in parallel, one ``nvcc`` each. Libraries are loaded
with ``ctypes``; every pointer and the stream are passed as ``c_void_p``.

Every C entry returns ``cudaGetLastError()`` after its launch and
:func:`check` raises on anything but 0, so a refused launch is never lost.

The wrappers run their plain PyTorch version for CPU tensors
(:func:`runs_plain`); for CUDA tensors they launch or raise, except inside
:func:`plain_versions`, the explicit reference mode the kernels are held
against on the card. That mode belongs to the thread that entered it: a
forward on another thread (or the autograd engine's) still launches. A
launch on a tensor autograd is recording raises (:func:`check_cuda`); the
differentiable wrappers launch inside ``autograd.replay``'s Function,
whose backward replays their plain versions, or runs the blend's backward
kernel (counted apart, :data:`backward_launches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "build", "library", "check", "check_cuda", "stream_of",
           "dtype_code", "count_launch", "launches", "count_feed", "feeds",
           "count_backward", "backward_launches", "reset_launches",
           "runs_plain", "plain_versions", "plain_mode"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "polyblur_torch"
SOURCES = ("pad_cast", "estimate", "spectral", "blend", "bilateral", "iir",
           "features")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Kernel launches since the last :func:`reset_launches`, by kernel name.
launches: collections.Counter = collections.Counter()

#: ``spectral_gemm``'s mode-1 launches since the last
#: :func:`reset_launches`, by the way their tiles reach the stages:
#: ``"tma"`` or ``"gather"`` (``polyblur_fused.mode1_feed``). Each is one of
#: :data:`launches` too.
feeds: collections.Counter = collections.Counter()

#: Launches of backward kernels since the last :func:`reset_launches`, by
#: the name of the wrapper whose gradient they compute; none is one of
#: :data:`launches`, which counts the forward's kernels.
backward_launches: collections.Counter = collections.Counter()

_LIBS: dict = {}
_LOCK = threading.Lock()


class _Mode(threading.local):
    plain = False         # each thread starts with its kernels


_MODE = _Mode()


def count_launch(name: str) -> None:
    launches[name] += 1


def count_feed(feed: str) -> None:
    feeds[feed] += 1


def count_backward(name: str) -> None:
    backward_launches[name] += 1


def reset_launches() -> None:
    launches.clear()
    feeds.clear()
    backward_launches.clear()


def plain_mode() -> bool:
    """Whether the calling thread is inside :func:`plain_versions`."""
    return _MODE.plain


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: for a CPU
    tensor, or on any device inside :func:`plain_versions` on this
    thread."""
    return t.device.type == "cpu" or plain_mode()


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """Within the block every kernel wrapper called from this thread runs
    its plain PyTorch version on any device (``on=False``: its kernels
    again): the reference a whole path's kernels are held against on the
    card (``chip_smoke.py``), and the replay of an autograd Function's
    backward. It launches nothing and counts nothing. Other threads keep
    their own mode."""
    prev, _MODE.plain = plain_mode(), bool(on)
    try:
        yield
    finally:
        _MODE.plain = prev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of polyblur_torch "
                           "are built on first use and need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes at once. Returns {name: compiler log} of what was built
    (the ``-Xptxas=-v`` register/spill report); raises on any failure."""
    jobs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never race
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            lib.pb_error_string.argtypes = [ctypes.c_int]
            lib.pb_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({msg})")


def check_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on a CUDA device, and unless no
    tensor is one autograd is recording (the launch would cut the
    graph)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; call it "
                           f"through a differentiable wrapper or under "
                           f"torch.no_grad()")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dt: torch.dtype) -> int:
    """The kernels' dtype code (csrc/common.cuh ``pb::DType``)."""
    try:
        return _DTYPE_CODES[dt]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {dt}") from None
