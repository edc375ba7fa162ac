"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Pointers and the stream cross as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` and ``check`` raises if it is not 0. Libraries are
built at first use into ``_build/`` (listed in ``.gitignore``), named by
a hash of their sources so a stale build is never loaded; ``build_all``
starts one ``nvcc`` per source at once and waits for them all.
``start_builds`` starts them without waiting: ``load`` then waits for its
own library only, so a program can run on the libraries that are ready
while a slow one compiles (``BUILD_SECONDS`` records each build's
seconds). A build still running when the process exits is killed.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sketch", "estimates", "unsketch_topk", "unsketch_radix",
           "topk_stream", "topk_radix", "segment_sum", "flash_attention",
           "hw_dropout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper; each wrapper adds one where it launches
#: its kernel and nowhere else (the plain versions do not count)
LAUNCHES: Counter = Counter()

_libs: dict = {}
#: {name: (temporary output, nvcc process, start time)} of started builds
_pending: dict = {}
#: {name: seconds} of the builds this process finished
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_builds() -> list:
    """Start one ``nvcc`` for every source neither built nor building;
    returns their names."""
    todo = [n for n in SOURCES
            if n not in _pending and not _lib_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    if not _pending:
        atexit.register(_kill_pending)
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # the compiler's output goes to a file: a pipe nobody reads while
        # the build runs in the background could fill and stall it
        with open(BUILD_DIR / f"{name}.log", "w") as log:
            _pending[name] = (tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT),
                time.perf_counter())
    return todo


def _finish(name: str):
    """Wait for ``name``'s started build: None when it succeeded (the
    library in place, its seconds in ``BUILD_SECONDS``), else the
    compiler's output."""
    tmp, proc, t0 = _pending.pop(name)
    proc.wait()
    out = (BUILD_DIR / f"{name}.log").read_text()
    if proc.returncode != 0:
        return f"--- nvcc {name}.cu (exit {proc.returncode})\n{out}"
    os.replace(tmp, _lib_path(name))
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return None


def _kill_pending() -> None:
    for _, proc, _ in _pending.values():
        proc.kill()
        proc.wait()
    _pending.clear()


def wait_build(name: str) -> None:
    """``name``'s library built: when it is neither built nor building,
    every missing source's build is started (at once); then its own is
    waited for. Raises on a failure, with the compiler's output."""
    if name not in _pending and not _lib_path(name).exists():
        start_builds()
    if name in _pending:
        err = _finish(name)
        if err:
            raise RuntimeError(f"CUDA kernel build failed:\n{err}")


def build_all() -> dict:
    """Compile every source not built yet, all ``nvcc`` processes at once
    (with any started before), and wait for them. Returns ``{name:
    seconds}`` for what it built; raises on a failure, with the
    compiler's output."""
    start_builds()
    names = list(_pending)
    failed = [err for err in map(_finish, names) if err]
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library ``name`` with ``signatures`` ({function:
    argtypes}) declared; every function returns an int error code."""
    if name not in _libs:
        wait_build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a pointer, read on every
    launch (a caller may change it). ``torch.cuda.current_stream(device)
    .cuda_stream`` gives the same pointer but builds a ``Stream`` object
    on every call, host time that a small kernel's call cannot hide."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
