"""The C++ host data plane: ctypes bindings to ``fedio.cpp``, built at
first use (the port's copy of ``commefficient_tpu/native``).

``lib()`` compiles ``fedio.cpp`` with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``_build/`` (listed in ``.gitignore``), the library named
by a hash of its source and flags so a stale build is never loaded; the
build writes a temporary file and renames it into place, so processes
that race to build it do no harm. A failed build raises with the
compiler's output: the data plane never falls back to numpy silently.
``COMMEFFICIENT_NO_NATIVE=1`` (read at every call) is the one way to the
numpy stages: ``lib()`` then returns None and the callers in
``data/transforms.py`` and ``data/imagenet.py`` take them.

Every entry point adds one to ``CALLS[name]`` where it calls into the
library, and nowhere else, so a run can show which path its data took.
Randomness stays with the callers (see ``fedio.cpp``). A pass runs on
``threads_for(output bytes)`` threads: one a ``BYTES_PER_THREAD`` of
output, at most ``default_threads()`` (the thread count changes no
result).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import Counter
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC = Path(__file__).resolve().with_name("fedio.cpp")
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
ABI = 1
OPT_OUT = "COMMEFFICIENT_NO_NATIVE"
#: the least output a pass hands each thread: waking the pool's threads
#: costs more than they save on a smaller share (one client's 32 CIFAR
#: images are 393 KB)
BYTES_PER_THREAD = 1 << 20

#: native calls per entry point (``rrc_batch``, ``pad_crop_batch``,
#: ``gather_rows``)
CALLS: Counter = Counter()

_lock = threading.Lock()
_handles: dict = {}     # (SRC, BUILD_DIR) -> the loaded library


def lib_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfedio-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native data plane: could not run "
                           f"{' '.join(cmd)}: {e} (set {OPT_OUT}=1 to use "
                           "the numpy stages)") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native data plane: {' '.join(cmd)} failed (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}(set "
            f"{OPT_OUT}=1 to use the numpy stages)")
    os.replace(tmp, so)


def _declare(h) -> None:
    i64, i32p, f32p, u8p = (ctypes.c_int64,
                            np.ctypeslib.ndpointer(np.int32, flags="C"),
                            np.ctypeslib.ndpointer(np.float32, flags="C"),
                            np.ctypeslib.ndpointer(np.uint8, flags="C"))
    h.fedio_rrc_batch.argtypes = [u8p, i64, i64, i64, i64, i32p, f32p, i64,
                                  f32p, f32p, ctypes.c_int]
    h.fedio_rrc_batch.restype = None
    h.fedio_pad_crop_batch.argtypes = [f32p, i64, i64, i64, i64, i32p, f32p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_int]
    h.fedio_pad_crop_batch.restype = None
    h.fedio_gather_rows.argtypes = [
        u8p, np.ctypeslib.ndpointer(np.int64, flags="C"), i64, i64, u8p,
        ctypes.c_int]
    h.fedio_gather_rows.restype = None
    h.fedio_abi_version.restype = ctypes.c_int


def lib():
    """The loaded library, built first if need be; None under
    ``COMMEFFICIENT_NO_NATIVE=1``. Raises if it does not build or load."""
    if os.environ.get(OPT_OUT) == "1":
        return None
    key = (SRC, BUILD_DIR)
    h = _handles.get(key)
    if h is not None:
        return h
    with _lock:
        if key not in _handles:
            so = lib_path()
            if not so.exists():
                _build(so)
            h = ctypes.CDLL(str(so))
            _declare(h)
            if h.fedio_abi_version() != ABI:
                raise RuntimeError(f"native data plane: {so} has ABI "
                                   f"{h.fedio_abi_version()}, expected {ABI}")
            _handles[key] = h
    return _handles[key]


def _loaded():
    h = lib()
    if h is None:
        raise RuntimeError(f"native data plane disabled by {OPT_OUT}=1")
    return h


def default_threads() -> int:
    return max(1, min(os.cpu_count() or 1, 16))


def threads_for(nbytes: int) -> int:
    """Threads for a pass that writes ``nbytes``."""
    return max(1, min(default_threads(), nbytes // BYTES_PER_THREAD))


def rrc_batch(src: np.ndarray, params: np.ndarray, size: int,
              scale: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """Fused crop + bilinear resize + flip + affine over a uint8 NHWC
    batch; ``params`` int32 (B, 5): top, left, crop_h, crop_w, flip."""
    h = _loaded()
    B, H, W, C = src.shape
    src = np.ascontiguousarray(src)
    params = np.ascontiguousarray(params, np.int32)
    out = np.empty((B, size, size, C), np.float32)
    CALLS["rrc_batch"] += 1
    h.fedio_rrc_batch(src, B, H, W, C, params, out, size,
                      np.ascontiguousarray(scale, np.float32),
                      np.ascontiguousarray(bias, np.float32),
                      threads_for(out.nbytes))
    return out


def pad_crop_batch(src: np.ndarray, params: np.ndarray, pad: int,
                   reflect: bool, fill: float) -> np.ndarray:
    """Fused pad + crop + flip over a float NHWC batch; ``params`` int32
    (B, 3): y, x (offsets into the padded image), flip."""
    h = _loaded()
    B, H, W, C = src.shape
    src = np.ascontiguousarray(src, np.float32)
    params = np.ascontiguousarray(params, np.int32)
    out = np.empty_like(src)
    CALLS["pad_crop_batch"] += 1
    h.fedio_pad_crop_batch(src, B, H, W, C, params, out, pad,
                           int(reflect), float(fill),
                           threads_for(out.nbytes))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` by a threaded memcpy (GIL released), memory-mapped
    sources included; rows must be C-contiguous and of one size. The
    indices are bounds-checked here: the C side is a raw memcpy."""
    h = _loaded()
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if len(idx) == 0 or src.size == 0:
        return src[idx]  # numpy raises on a bad index into an empty src
    if idx.min() < 0 or idx.max() >= src.shape[0]:
        raise IndexError(
            f"gather_rows: index out of range for {src.shape[0]} rows "
            f"(min {idx.min()}, max {idx.max()})")
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64)) * src.itemsize
    CALLS["gather_rows"] += 1
    h.fedio_gather_rows(
        src.reshape(src.shape[0], row_bytes // src.itemsize).view(np.uint8),
        idx, len(idx), row_bytes,
        out.reshape(len(idx), row_bytes // src.itemsize).view(np.uint8),
        threads_for(out.nbytes))
    return out
