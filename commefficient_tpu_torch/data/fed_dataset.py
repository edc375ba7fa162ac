"""Client-partitioned dataset base (numpy copy of
``commefficient_tpu/data/fed_dataset.py``, same seeds and draw order).

* the train set is a list of per-client arrays; ``images_per_client``
  gives the natural (non-iid) partition sizes;
* ``do_iid`` overlays a global permutation so each client sees an iid
  slice;
* metadata is cached in ``stats.json`` in the dataset dir;
* validation data is centralized.

The reference's per-dataset transforms are ROADMAP.md A7: Synthetic, the
one ported dataset, has none.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np


class FedDataset:
    def __init__(self, dataset_dir: str = "./dataset", do_iid: bool = False,
                 num_clients: Optional[int] = None, train: bool = True,
                 seed: int = 0):
        self.dataset_dir = dataset_dir
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.train = train
        self.rng = np.random.RandomState(seed)

        if not do_iid and num_clients == 1:
            raise ValueError("can't have 1 client when non-iid")

        if not os.path.exists(self.stats_fn()):
            self.prepare_datasets()
        self._load_meta()

        if self.do_iid and self.train:
            self.iid_shuffle = self.rng.permutation(len(self))

    # --- to implement per dataset ----------------------------------------
    def prepare_datasets(self):
        raise NotImplementedError

    def _get_train_batch(self, client_id: int,
                         idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Return (inputs..., targets) arrays for rows of a *natural* client."""
        raise NotImplementedError

    def _get_val_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        raise NotImplementedError

    # --- shared machinery -------------------------------------------------
    def stats_fn(self) -> str:
        return os.path.join(self.dataset_dir, "stats.json")

    def _load_meta(self):
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        self.images_per_client = np.array(stats["images_per_client"])
        self.num_val_images = stats["num_val_images"]

    @property
    def num_clients(self) -> int:
        return (self._num_clients if self._num_clients is not None
                else len(self.images_per_client))

    @property
    def data_per_client(self) -> np.ndarray:
        """Partition sizes after the iid/num_clients overlay."""
        if self.do_iid:
            n = len(self)
            per = np.full(self.num_clients, n // self.num_clients, dtype=int)
            per[self.num_clients - (n % self.num_clients):] += 1 \
                if n % self.num_clients else 0
            return per
        n_nat = len(self.images_per_client)
        if self.num_clients % n_nat != 0:
            raise ValueError(
                f"num_clients ({self.num_clients}) must be a multiple of the "
                f"natural partition count ({n_nat}) for non-iid splits")
        per_class = self.num_clients // n_nat
        out = []
        for num_images in self.images_per_client:
            sizes = [num_images // per_class] * per_class
            sizes[-1] += num_images % per_class
            out.extend(sizes)
        return np.array(out)

    def __len__(self) -> int:
        if self.train:
            return int(np.sum(self.images_per_client))
        return self.num_val_images

    def _flat_to_natural(self, flat_idxs: np.ndarray):
        """Map global flat indices to (natural_client, idx_within) pairs."""
        if self.do_iid:
            flat_idxs = self.iid_shuffle[flat_idxs]
        cumsum = np.cumsum(self.images_per_client)
        client = np.searchsorted(cumsum, flat_idxs, side="right")
        starts = np.hstack([[0], cumsum[:-1]])
        return client, flat_idxs - starts[client]

    def get_flat_batch(self, flat_idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Fetch arbitrary flat train indices (crossing natural clients)."""
        clients, within = self._flat_to_natural(np.asarray(flat_idxs))
        parts = []
        order = np.argsort(clients, kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        for c in np.unique(clients):
            rows = within[clients == c]
            parts.append(self._get_train_batch(int(c), rows))
        cols = [np.concatenate([p[i] for p in parts])
                for i in range(len(parts[0]))]
        return tuple(c[inv] for c in cols)  # restore request order

    def get_val_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        return tuple(self._get_val_batch(np.asarray(idxs)))
