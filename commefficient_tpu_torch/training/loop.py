"""The entry points' round loop: the rounds of an epoch go through the
learner's one-round ``RoundPipeline``, or through a ``ScanWindow`` under
``--scan_rounds K > 1``, and come back as finalized per-round metrics.

``RoundFeed.push`` dispatches a round and returns the rounds whose
metrics were read by then (the previous one on the pipeline, K of them
when a window ran, else none); ``flush`` returns the rest at the epoch's
end. Each returned round carries ``round_s``: the host seconds between
its metrics' read and the previous read, the loop's round period, split
evenly over the rounds of one read. ``FeedClock`` counts the host
seconds spent making the batches (sampling, gathering, transforms).
``finish_run`` is the buffered server's end-of-training barrier.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List

from commefficient_tpu_torch.parallel import distributed


class RoundFeed:
    def __init__(self, learner, scan_k: int = 1):
        self.learner = learner
        self.window = learner.scan_window(scan_k) if scan_k > 1 else None
        self.pipe = None if self.window is not None else learner.pipeline()
        self._t = time.perf_counter()

    def push(self, ids, cols, mask, epoch_frac, next_client_ids=None
             ) -> List[dict]:
        if self.window is not None:
            return self._stamp(self.window.push(ids, cols, mask,
                                                epoch_frac))
        raw = self.learner.train_round_async(
            ids, cols, mask, epoch_frac=epoch_frac,
            next_client_ids=next_client_ids)
        return self._stamp([self.pipe.push(raw)])

    def flush(self) -> List[dict]:
        if self.window is not None:
            return self._stamp(self.window.flush())
        return self._stamp([self.pipe.flush()])

    def _stamp(self, outs) -> List[dict]:
        outs = [o for o in outs or () if o is not None]
        if outs:
            now = time.perf_counter()
            for o in outs:
                o["round_s"] = (now - self._t) / len(outs)
            self._t = now
        return outs


def first_abort(outs):
    """The first round of ``outs`` whose device guard tripped, or None.
    The rounds after a breach are frozen and may report a healthy loss,
    so the sticky flag is the signal."""
    return next((o for o in outs if o["aborted"]), None)


class RoundAborted(Exception):
    """A round's device guard tripped: the entry point's loop ends the run
    with that round's metrics (``metrics``)."""

    def __init__(self, metrics: dict):
        super().__init__(f"NaN/divergent loss ({metrics['loss']})")
        self.metrics = metrics


def raise_on_abort(outs) -> None:
    """Raise ``RoundAborted`` for the first aborted round of ``outs``."""
    bad = first_abort(outs)
    if bad is not None:
        raise RoundAborted(bad)


def end_aborted(learner, bad: dict, history: list, nan_threshold: float):
    """An entry point's result after the aborted round ``bad``: the host
    rows settled first. On a mesh rank 0 alone says so."""
    if distributed.is_main():
        print(f"NaN/divergent loss ({bad['loss']}); aborting "
              f"(threshold {nan_threshold})")
    learner.flush_offload()
    return learner, {"aborted": True, "loss": bad["loss"],
                     "rounds": history}


class FeedClock:
    """Host seconds and batches spent in the iterators it wraps."""

    def __init__(self):
        self.seconds = 0.0
        self.batches = 0

    def wrap(self, items: Iterable) -> Iterator:
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self.seconds += time.perf_counter() - t0
            self.batches += 1
            yield item


def finish_run(learner, row: dict, log: bool = True) -> None:
    """The buffered server's end of training: every contribution in flight
    is delivered and a partial buffer applied, so the final weights and
    byte totals count all dispatched work; ``row`` gets ``sim_time`` and
    the new byte totals. No-op for the sync server."""
    if not hasattr(learner, "flush_faults"):
        return
    learner.flush_faults()
    row["sim_time"] = learner.sim_time
    row["down (MiB)"] = learner.total_download_bytes / 2**20
    row["up (MiB)"] = learner.total_upload_bytes / 2**20
    if log:
        print(f"buffered server: {learner.applies_done} applies over "
              f"{learner.cohorts_done} cohorts, sim_time="
              f"{learner.sim_time:.1f} units, faults="
              f"{learner.fault_stats}")
