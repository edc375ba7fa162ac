"""Fixed-shape round batches from ragged per-client samples (numpy copy of
``commefficient_tpu/data/batching.py``): (num_workers, pad_size, ...)
arrays plus a validity mask; every sum in the round weights by the mask.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.sampler import FedSampler


class FedBatcher:
    """Iterates federated rounds as (client_ids, batch_arrays, mask)."""

    def __init__(self, dataset, num_workers: int, local_batch_size: int,
                 seed: int = 0, pad_size: Optional[int] = None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.sampler = FedSampler(dataset, num_workers, local_batch_size,
                                  seed=seed)
        if pad_size is None:
            if local_batch_size == -1:
                pad_size = int(np.max(dataset.data_per_client))
            else:
                pad_size = local_batch_size
        self.pad_size = pad_size

    def epoch(self) -> Iterator[Tuple[np.ndarray, tuple, np.ndarray]]:
        W, B = self.num_workers, self.pad_size
        for round_batches in self.sampler.epoch():
            ids = np.zeros(W, np.int32)
            mask = np.zeros((W, B), np.float32)
            cols = None
            for w, (client_id, flat_idxs) in enumerate(round_batches):
                data = self.dataset.get_flat_batch(flat_idxs)
                if cols is None:
                    cols = [np.zeros((W, B) + d.shape[1:], d.dtype)
                            for d in data]
                n = min(len(flat_idxs), B)
                ids[w] = client_id
                mask[w, :n] = 1.0
                for c, d in zip(cols, data):
                    c[w, :n] = d[:n]
            if cols is None:
                continue
            # epoch-tail rounds can carry fewer than W clients: padded
            # workers have all-zero masks and contribute nothing
            yield ids, tuple(cols), mask

    def steps_per_epoch(self) -> int:
        return self.sampler.steps_per_epoch()


def val_batches(dataset, batch_size: int):
    """Centralized validation batches: ((inputs...,), mask) pairs, padded
    to a fixed batch size."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        idxs = np.arange(start, min(start + batch_size, n))
        data = dataset.get_val_batch(idxs)
        b = len(idxs)
        mask = np.zeros(batch_size, np.float32)
        mask[:b] = 1.0
        cols = []
        for d in data:
            pad = np.zeros((batch_size,) + d.shape[1:], d.dtype)
            pad[:b] = d
            cols.append(pad)
        yield tuple(cols), mask
