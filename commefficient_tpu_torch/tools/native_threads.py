"""Host time of the C++ data plane's passes by thread count, beside the
numpy stages, at the batch sizes the entry points call them with.

    python -m commefficient_tpu_torch.tools.native_threads

For each case (the CIFAR train transform on one client's 32 images and on
a round's 256, RandomResizedCrop on 8 and 64 ImageNet images, a 64-row
gather from a memory map), prints the median ms of ``REPS`` calls of the
whole transform with the native pass at 1, 2, 4, ... threads up to
``native.default_threads()``, at the count ``native.threads_for`` picks,
and of the numpy stages. Needs no GPU.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from commefficient_tpu_torch import native
from commefficient_tpu_torch.data import transforms as T

REPS = 50


def _ms(fn, reps=REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _numpy(fn):
    os.environ[native.OPT_OUT] = "1"
    try:
        return fn()
    finally:
        os.environ.pop(native.OPT_OUT)


def main() -> int:
    rng = np.random.RandomState(0)
    most = native.default_threads()
    counts = sorted({1 << i for i in range(most.bit_length())} | {most})
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rows.npy")
        np.save(path, rng.randint(0, 256, (512, 256, 256, 3), np.uint8))
        rows = np.load(path, mmap_mode="r")
        order = np.sort(rng.choice(512, 64, replace=False))
        cases = {}
        for b in (32, 256):
            imgs = rng.randint(0, 256, (b, 32, 32, 3), np.uint8)
            cases[f"cifar train transform, {b} images"] = (
                lambda imgs=imgs: T.cifar10_train_transforms(
                    [imgs], np.random.RandomState(1)), 10)
        for b in (8, 64):
            imgs = rng.randint(0, 256, (b, 256, 256, 3), np.uint8)
            cases[f"imagenet train transform, {b} images"] = (
                lambda imgs=imgs: T.imagenet_train_transforms(
                    [imgs], np.random.RandomState(1)), 3)
        cases["gather of 64 memmap rows"] = (
            lambda: (native.gather_rows(rows, order)
                     if native.lib() is not None
                     else np.asarray(rows[order])), REPS)
        policy = native.threads_for
        try:
            for name, (fn, numpy_reps) in cases.items():
                line = []
                for n in counts:
                    native.threads_for = lambda nbytes, n=n: n
                    line.append(f"{n}: {_ms(fn):.3f}")
                native.threads_for = policy
                picked = _ms(fn)
                numpy_ms = _numpy(lambda: _ms(fn, numpy_reps))
                print(f"{name}: native ms by threads {{{', '.join(line)}}}, "
                      f"{picked:.3f} at threads_for's count, numpy "
                      f"{numpy_ms:.3f} ms", flush=True)
        finally:
            native.threads_for = policy
        del rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
