"""Federated client sampler (numpy copy of
``commefficient_tpu/data/sampler.py``, same draw order): shuffle within
each client, then per round pick ``num_workers`` non-exhausted clients
uniformly without replacement and take up to ``local_batch_size`` items
from each (-1 = the client's whole remaining data). The preemption cursor
is ROADMAP.md A10.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


class FedSampler:
    def __init__(self, dataset, num_workers: int, local_batch_size: int,
                 seed: int = 0):
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch_size = local_batch_size
        self.rng = np.random.RandomState(seed)

    def epoch(self) -> Iterator[List[Tuple[int, np.ndarray]]]:
        """One epoch of rounds, each a list of (client_id, flat indices)."""
        data_per_client = self.dataset.data_per_client
        cumsum = np.hstack([[0], np.cumsum(data_per_client)])
        permuted = np.hstack([
            s + self.rng.permutation(n)
            for s, n in zip(cumsum[:-1], data_per_client)
        ]) if len(data_per_client) else np.array([], dtype=int)
        cur = np.zeros(self.dataset.num_clients, dtype=int)

        while True:
            alive = np.where(cur < data_per_client)[0]
            if len(alive) == 0:
                return
            n_workers = min(self.num_workers, len(alive))
            workers = self.rng.choice(alive, n_workers, replace=False)
            remaining = data_per_client[workers] - cur[workers]
            if self.local_batch_size == -1:
                take = remaining
            else:
                take = np.clip(remaining, 0, self.local_batch_size)
            round_batches = []
            for w, t in zip(workers, take):
                s = cumsum[w] + cur[w]
                round_batches.append((int(w), permuted[s:s + t]))
            yield round_batches
            cur[workers] += take

    def steps_per_epoch(self) -> int:
        if self.local_batch_size == -1:
            return max(1, self.dataset.num_clients // self.num_workers)
        return int(np.ceil(len(self.dataset) /
                           (self.local_batch_size * self.num_workers)))
