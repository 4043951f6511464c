"""ctypes bindings and build of the native host runtime
(``csrc/host_runtime.cpp``, the JAX package's host runtime).

The shared library is compiled with ``g++`` at first use (a plain C ABI,
no PyTorch headers) into ``build/polyblur_torch/`` at the repository root,
keyed on a hash of the source, the flags, the compiler's version and the
host (``-march=native`` code, linked against the host's libpng and
libjpeg), as ``ops/cuda/_build.py`` keys the kernels; nothing is written
into the package, and a cached library that does not load is built
again. Every entry point has a fallback with the same results — the
port's ``patches`` (``extract_patches``, ``overlap_add``) on CPU tensors
and PIL decoding — so the package works where no compiler or codec
headers are present: the native path is a host-throughput optimization,
not a correctness dependency, as in the JAX package
(polyblur_tpu/runtime/native.py).
:func:`native_available` says whether the library loaded and, if not, why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

__all__ = ["load_library", "native_available", "NativeStatus",
           "extract_tiles", "overlap_add_host", "decode_image",
           "batch_decode"]

_SRC = Path(__file__).resolve().parent / "csrc" / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "polyblur_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
LIBS = ("-lpng", "-ljpeg")

_lock = threading.Lock()
_lib = None
_reason = "not loaded yet"
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


class NativeStatus(NamedTuple):
    """Whether the native library is loaded, and why not when it is not;
    true exactly when it is available."""
    available: bool
    reason: str

    def __bool__(self) -> bool:
        return self.available


def _cxx_version(cxx: str) -> str:
    try:
        return subprocess.run([cxx, "-dumpfullversion"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _target(cxx: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_SRC.read_bytes())
    h.update(" ".join((_cxx_version(cxx), platform.node(),
                       platform.machine())).encode())
    return BUILD_DIR / f"libhost_runtime-{h.hexdigest()[:16]}.so"


def _build(cxx: str, out: Path) -> str | None:
    """Compile the library into ``out``; None on success, else why not."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ failed to run: {e}"
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
        return "g++ failed: " + " | ".join(tail)
    os.replace(tmp, out)  # atomic: processes building at once never race
    return None


def load_library():
    """Load (building if needed) the native library; None if unavailable
    (:func:`native_available` gives the reason)."""
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        cxx = shutil.which("g++")
        if cxx is None:
            _reason = "g++ not found"
            return None
        out = _target(cxx)
        lib = None
        for attempt in range(2):
            if attempt or not out.exists():
                err = _build(cxx, out)
                if err is not None:
                    _reason = err
                    return None
            try:
                lib = ctypes.CDLL(str(out))
                break
            except OSError as e:  # a cached library built elsewhere
                _reason = f"cannot load {out.name}: {e}"
        if lib is None:
            return None
        lib.extract_tiles_f32.argtypes = [_F32P, _F32P] + [ctypes.c_int64] * 8 \
            + [_I64P] + [ctypes.c_int64] * 3
        lib.extract_tiles_f32.restype = None
        lib.overlap_add_f32.argtypes = [_F32P, _F32P, _F32P] \
            + [ctypes.c_int64] * 8 + [_I64P] + [ctypes.c_int64] * 3
        lib.overlap_add_f32.restype = None
        lib.image_probe.argtypes = [ctypes.c_char_p, _I64P, _I64P, _I64P]
        lib.image_probe.restype = ctypes.c_int
        lib.image_decode.argtypes = [ctypes.c_char_p, _F32P] \
            + [ctypes.c_int64] * 3
        lib.image_decode.restype = ctypes.c_int
        lib.batch_decode.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int64, _F32P] \
            + [ctypes.c_int64] * 3
        lib.batch_decode.restype = ctypes.c_int
        lib.omp_max_threads.restype = ctypes.c_int
        _lib, _reason = lib, f"loaded {out.name}"
        return _lib


def native_available() -> NativeStatus:
    """Whether the native library is available, with the reason when it is
    not (no ``g++``, a failed build or load)."""
    lib = load_library()
    return NativeStatus(lib is not None, _reason)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def extract_tiles(img: np.ndarray, grid, out: np.ndarray | None = None
                  ) -> np.ndarray:
    """(B, C, H, W) f32 -> (T*B, C, ph, pw) tile batch for a PatchGrid:
    the native-threaded ``patches.extract_patches`` for host-side staging
    (identical output). ``out``: an optional C-contiguous f32 destination
    of that shape (a pinned tensor's memory, say)."""
    from ..patches import extract_patches

    lib = load_library()
    b, c, h, w = img.shape
    ph, pw = grid.patch_size
    hp, wp = grid.padded_size
    pt, _, pl_, _ = grid.pad
    coords = np.asarray(grid.coords, np.int64).reshape(-1, 2)
    n_tiles = len(coords)
    shape = (n_tiles * b, c, ph, pw)
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise ValueError(f"extract_tiles: out must be C-contiguous f32 "
                         f"{shape}, got {out.dtype} {out.shape}")
    if lib is None:
        import torch

        out[...] = extract_patches(torch.as_tensor(img), grid).numpy()
        return out
    img = np.ascontiguousarray(img, np.float32)
    lib.extract_tiles_f32(_f32p(img), _f32p(out), b, c, h, w, hp, wp,
                          pt, pl_, _i64p(coords), n_tiles, ph, pw)
    return out


def overlap_add_host(tiles: np.ndarray, grid, batch: int,
                     window: np.ndarray) -> np.ndarray:
    """(T*B, C, ph, pw) f32 -> (B, C, h, w) windowed overlap-add (the
    fallback, as the JAX package's, blends with the default Kaiser
    window)."""
    from ..patches import overlap_add

    lib = load_library()
    ph, pw = grid.patch_size
    hp, wp = grid.padded_size
    h, w = grid.orig_size
    pt, _, pl_, _ = grid.pad
    coords = np.asarray(grid.coords, np.int64).reshape(-1, 2)
    c = tiles.shape[1]
    if lib is None:
        import torch

        return overlap_add(torch.as_tensor(np.asarray(tiles, np.float32)),
                           grid, batch).numpy()
    tiles = np.ascontiguousarray(tiles, np.float32)
    window = np.ascontiguousarray(window, np.float32)
    out = np.empty((batch, c, h, w), np.float32)
    lib.overlap_add_f32(_f32p(tiles), _f32p(window), _f32p(out), batch, c,
                        h, w, hp, wp, pt, pl_, _i64p(coords),
                        len(coords), ph, pw)
    return out


def decode_image(path: str, gray: bool = False) -> np.ndarray:
    """PNG/JPEG -> float32 (H, W, C) in [0, 1]; native with PIL fallback."""
    lib = load_library()
    if lib is None:
        from ..utils.io import imread_float

        img = imread_float(path)
        if gray and img.ndim == 3:
            img = img.mean(axis=-1)
        return img
    h = ctypes.c_int64()
    w = ctypes.c_int64()
    c = ctypes.c_int64()
    rc = lib.image_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                         ctypes.byref(c))
    if rc != 0:
        raise IOError(f"cannot probe image {path!r} (rc={rc})")
    ch = 1 if gray else c.value
    out = np.empty((h.value, w.value, ch), np.float32)
    rc = lib.image_decode(path.encode(), _f32p(out), h.value, w.value, ch)
    if rc != 0:
        raise IOError(f"cannot decode image {path!r} (rc={rc})")
    return out[..., 0] if ch == 1 else out


def batch_decode(paths, h: int, w: int, c: int = 3) -> np.ndarray:
    """Decode n same-shaped images in parallel -> (n, h, w, c) f32."""
    lib = load_library()
    if lib is None:
        return np.stack([decode_image(p) for p in paths])
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    out = np.empty((len(paths), h, w, c), np.float32)
    failures = lib.batch_decode(arr, len(paths), _f32p(out), h, w, c)
    if failures:
        raise IOError(f"{failures} images failed to decode")
    return out
