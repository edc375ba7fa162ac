"""Federated client sampler (numpy copy of
``commefficient_tpu/data/sampler.py``, same draw order): shuffle within
each client, then per round pick ``num_workers`` non-exhausted clients
uniformly without replacement and take up to ``local_batch_size`` items
from each (-1 = the client's whole remaining data).

For a resume, ``epoch(skip=k)`` replays the first k rounds' draws and
exhaustion bookkeeping without yielding them, and ``cursor`` /
``restore_cursor`` carry the generator's state.
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
        # the state the latest epoch started from: a mid-epoch cursor
        # records it (the live generator is ahead by the prefetched rounds)
        self._epoch_start_state = self.rng.get_state()
        self.epochs_started = 0

    def epoch(self, skip: int = 0) -> Iterator[List[Tuple[int, np.ndarray]]]:
        """One epoch of rounds, each a list of (client_id, flat indices);
        the first ``skip`` rounds are drawn and not yielded."""
        self._epoch_start_state = self.rng.get_state()
        self.epochs_started += 1
        return self._epoch_iter(skip)

    def _epoch_iter(self, skip: int):
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
            if skip > 0:
                skip -= 1
            else:
                round_batches = []
                for w, t in zip(workers, take):
                    s = cumsum[w] + cur[w]
                    round_batches.append((int(w), permuted[s:s + t]))
                yield round_batches
            cur[workers] += take

    def cursor(self, in_epoch: bool) -> dict:
        """The generator's position: the state the current epoch started
        from (``in_epoch``: the resume replays that epoch with ``skip``),
        or the live state at an epoch boundary."""
        state = (self._epoch_start_state if in_epoch
                 else self.rng.get_state())
        kind, keys, pos, has_gauss, cached = state
        return {"rng": [kind, [int(x) for x in keys], int(pos),
                        int(has_gauss), float(cached)],
                "epochs_started": self.epochs_started}

    def restore_cursor(self, cur: dict, in_epoch: bool) -> None:
        kind, keys, pos, has_gauss, cached = cur["rng"]
        self.rng.set_state((kind, np.asarray(keys, np.uint32), pos,
                            has_gauss, cached))
        # an in-epoch resume calls epoch() again, which counts it again
        self.epochs_started = cur["epochs_started"] - (1 if in_epoch else 0)

    def steps_per_epoch(self) -> int:
        if self.local_batch_size == -1:
            return max(1, self.dataset.num_clients // self.num_workers)
        return int(np.ceil(len(self.dataset) /
                           (self.local_batch_size * self.num_workers)))
