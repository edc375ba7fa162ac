"""Console/TSV loggers, scalar export, wall-clock timer and the training
profiler (a copy of ``commefficient_tpu/utils/logging.py``, whose package
imports jax).

``--tensorboard``: ``ScalarWriter`` under ``make_logdir(args)``;
``--profile DIR``: ``profile_ctx(DIR)``, a ``torch.profiler`` trace of the
training loop over the CPU and, where there is one, the CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime


class Logger:
    def __init__(self, verbose: bool = True):
        self.verbose = verbose

    def debug(self, *args, **kwargs):
        if self.verbose:
            print(*args, **kwargs)

    def info(self, *args, **kwargs):
        print(*args, **kwargs)


class TableLogger:
    """Fixed-width column table; header printed on first append."""

    def __init__(self):
        self.keys = None

    def append(self, output: dict):
        if self.keys is None:
            self.keys = list(output.keys())
            print(*(f"{k:>12s}" for k in self.keys))
        filtered = [output.get(k, "") for k in self.keys]
        print(*(f"{v:12.4f}" if isinstance(v, float) else f"{str(v):>12s}"
                for v in filtered))


class TSVLogger:
    def __init__(self):
        self.log = ["epoch\thours\ttop1Accuracy"]

    def append(self, output: dict):
        epoch = output.get("epoch", -1)
        hours = output.get("total_time", 0) / 3600
        acc = output.get("test_acc", 0) * 100
        self.log.append(f"{epoch}\t{hours:.8f}\t{acc:.2f}")

    def __str__(self):
        return "\n".join(self.log)


class ScalarWriter:
    """Scalar export for ``--tensorboard``: torch's ``SummaryWriter`` where
    the tensorboard package imports, else an append-only ``scalars.tsv``
    of (step, tag, value) lines in the same log dir; the data are the same,
    only the container differs."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._tb = None
        self._file = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except ImportError:
            self._file = open(os.path.join(logdir, "scalars.tsv"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._file.write(f"{step}\t{tag}\t{float(value)}\n")
            self._file.flush()  # scalars trickle in; survive a killed run

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        else:
            self._file.close()


class Timer:
    def __init__(self, synch=None):
        self.synch = synch or (lambda: None)
        self.times = [time.perf_counter()]
        self.total_time = 0.0

    def __call__(self, include_in_total: bool = True):
        self.synch()
        self.times.append(time.perf_counter())
        delta_t = self.times[-1] - self.times[-2]
        if include_in_total:
            self.total_time += delta_t
        return delta_t


#: file name of the Chrome trace ``profile_ctx`` writes into its dir
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def _profiled(trace_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def profile_ctx(trace_dir):
    """A ``torch.profiler`` context that writes a Chrome trace of what runs
    inside it to ``trace_dir/trace.json``, or a null context when
    ``trace_dir`` is falsy."""
    if not trace_dir:
        return contextlib.nullcontext()
    return _profiled(trace_dir)


def make_logdir(cfg) -> str:
    """runs/<timestamp>_<workers>/<clients>_<mode>, relative to the working
    directory."""
    current_time = datetime.now().strftime("%b%d_%H-%M-%S")
    run_name = f"{current_time}_{cfg.num_workers}"
    detail = f"{cfg.num_clients}_{cfg.mode}"
    return os.path.join("runs", run_name, detail)
