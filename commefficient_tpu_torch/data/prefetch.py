"""Device prefetch and one-item lookahead over the round batches (port of
``commefficient_tpu/data/prefetch.py``).

``device_prefetch`` keeps the next rounds' batches in flight to the
device while the current round computes; ``with_lookahead`` hands the
offload pipeline's gather-ahead the next round's client ids. A loop
composes them, ``with_lookahead(device_prefetch(batcher.epoch()))``, and
feeds the learner's one-round ``RoundPipeline`` or ``ScanWindow``.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch


class _CudaCopier:
    """Host arrays to the device through pinned memory on a side stream.

    Each array goes into a pinned host tensor and is copied with
    ``non_blocking=True`` on the copy stream. The compute stream waits for
    the copy's event before it reads the result, which is
    ``record_stream``-ed there, so that the caching allocator does not
    hand its memory out early. The pinned buffer stays referenced until
    the copy's event has completed (``_held``): the host must not reuse
    it while the DMA may still read it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._held = deque()   # (event, pinned tensors)

    def put(self, arrays):
        pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in arrays]
        with torch.cuda.stream(self.stream):
            out = [p.to(self.device, non_blocking=True) for p in pinned]
            done = torch.cuda.Event()
            done.record(self.stream)
        self._held.append((done, pinned))
        return out, done

    def hand_over(self, tensors, done):
        """Make the compute stream wait for ``done`` before it reads
        ``tensors``, and release the pinned buffers whose copies ended."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        for t in tensors:
            t.record_stream(compute)
        while self._held and self._held[0][0].query():
            self._held.popleft()

    def drain(self):
        while self._held:
            done, _ = self._held.popleft()
            done.synchronize()


def device_prefetch(batches: Iterable, size: int = 2,
                    device="cuda", workers: slice = slice(None),
                    seq_cut=None) -> Iterator:
    """Yield the ``(client_ids, cols, mask)`` items of ``batches`` in order,
    with the columns of up to ``size`` of them already on their way to
    ``device``.

    Each column of ``cols`` becomes a tensor on ``device``. The client ids
    and the (W, B) mask stay host numpy arrays, because the host reads
    them: the offload pipeline's gather and writeback (the ids, and the
    slots the mask marks valid) and the per-worker seeds (the ids); a read
    of a device copy would wait for the rounds queued before it. The
    learner copies them (a few hundred bytes) from pinned memory without
    blocking. ``workers``: the columns' worker slots to move (a mesh
    rank's ``worker_block``; the ids and mask stay whole). ``seq_cut``: on
    a seq mesh axis, the learner's ``parallel.seq.SeqCut``, which also cuts
    each column with a sequence dimension to the rank's block of it. On a
    CUDA device the columns' copies run from pinned memory on a side
    stream (``_CudaCopier``); on the CPU the tensors share the arrays'
    memory."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    copier = _CudaCopier(device) if device.type == "cuda" else None

    def put(item):
        ids, cols, mask = item
        cols = [np.asarray(a)[workers] for a in cols]
        if seq_cut is not None:
            cols = [seq_cut.apply(i, a) for i, a in enumerate(cols)]
        if copier is None:
            tensors = [torch.as_tensor(np.asarray(a)) for a in cols]
            return ids, tensors, mask, None
        tensors, done = copier.put(cols)
        return ids, tensors, mask, done

    def take(entry):
        ids, tensors, mask, done = entry
        if copier is not None:
            copier.hand_over(tensors, done)
        return np.asarray(ids), tuple(tensors), np.asarray(mask)

    buf = deque()
    try:
        for item in batches:
            buf.append(put(item))
            if len(buf) > size:
                yield take(buf.popleft())
        while buf:
            yield take(buf.popleft())
    finally:
        if copier is not None:
            copier.drain()


def with_lookahead(items: Iterable) -> Iterator:
    """Yield ``(item, next_item_or_None)`` pairs; the last item pairs with
    None."""
    it = iter(items)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        yield cur, nxt
        cur = nxt
    yield cur, None
