"""Client-partitioned dataset base (numpy copy of
``commefficient_tpu/data/fed_dataset.py``, same seeds and draw order).

* the train set is a list of per-client arrays; ``images_per_client``
  gives the natural (non-iid) partition sizes;
* ``do_iid`` overlays a global permutation so each client sees an iid
  slice;
* metadata is cached in ``stats.json`` in the dataset dir;
* validation data is centralized;
* ``transform`` (``data/transforms.py``, ``fn(cols, rng) -> cols``) runs
  on every train and validation batch with the dataset's own
  ``RandomState`` (``self.rng``), after the iid permutation's draw;
* ``PreparedArrayDataset``: one ``.npy`` of images per natural client and
  a centralized ``test.npz``, built once from a subclass's ``_make_xy``
  (CIFAR10/100, ``data/cifar.py``; the offline Digits and Patches32 sets,
  ``data/offline.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np


class FedDataset:
    def __init__(self, dataset_dir: str = "./dataset", do_iid: bool = False,
                 num_clients: Optional[int] = None, train: bool = True,
                 transform=None, seed: int = 0):
        self.dataset_dir = dataset_dir
        self.do_iid = do_iid
        self._num_clients = num_clients
        self.train = train
        self.transform = transform
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
        cols = [c[inv] for c in cols]  # restore request order
        if self.transform is not None:
            cols = self.transform(cols, self.rng)
        return tuple(cols)

    def get_val_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, ...]:
        cols = list(self._get_val_batch(np.asarray(idxs)))
        if self.transform is not None:
            cols = self.transform(cols, self.rng)
        return tuple(cols)

    def client_slices(self) -> List[Tuple[int, int]]:
        """[start, end) flat range of each (overlay) client."""
        cumsum = np.cumsum(self.data_per_client)
        starts = np.hstack([[0], cumsum[:-1]])
        return list(zip(starts.tolist(), cumsum.tolist()))


class PreparedArrayDataset(FedDataset):
    """The shared materialized layout (reference ``fed_dataset.py:140``):
    one ``client<c>.npy`` of images per natural client (class-split) and a
    centralized ``test.npz``. A subclass implements ``_make_xy``; the
    cache, the per-client files and the batch fetch are common."""

    name = "prepared"
    #: bump in a subclass whenever its ``_make_xy`` changes what it returns;
    #: a cache written by another version is deleted and rebuilt (caches
    #: without the key count as version 1)
    version = 1

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.train:
            self.client_datasets = [
                np.load(self.client_fn(c))
                for c in range(len(self.images_per_client))]
        else:
            with np.load(self.test_fn()) as t:
                self.test_images = t["test_images"]
                self.test_targets = t["test_targets"]

    def client_fn(self, client_id: int) -> str:
        return os.path.join(self.dataset_dir, f"client{client_id}.npy")

    def test_fn(self) -> str:
        return os.path.join(self.dataset_dir, "test.npz")

    def _make_xy(self):
        """-> (train_x, train_y, test_x, test_y, num_classes)"""
        raise NotImplementedError

    def _load_meta(self):
        with open(self.stats_fn()) as f:
            stats = json.load(f)
        if stats.get("version", 1) != self.version:
            for c in range(len(stats["images_per_client"])):
                if os.path.exists(self.client_fn(c)):
                    os.remove(self.client_fn(c))
            for fn in (self.test_fn(), self.stats_fn()):
                if os.path.exists(fn):
                    os.remove(fn)
            self.prepare_datasets()
        super()._load_meta()

    def prepare_datasets(self):
        os.makedirs(self.dataset_dir, exist_ok=True)
        train_x, train_y, test_x, test_y, n_cls = self._make_xy()
        images_per_client = []
        # stats.json is written last: it marks the cache valid, so an
        # interrupted build is rebuilt on the next construction
        for c in range(n_cls):
            rows = train_x[train_y == c]
            images_per_client.append(len(rows))
            np.save(self.client_fn(c), rows)
        np.savez(self.test_fn(), test_images=test_x, test_targets=test_y)
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": images_per_client,
                       "num_val_images": len(test_y),
                       "version": self.version}, f)

    def _get_train_batch(self, client_id: int, idxs: np.ndarray):
        imgs = self.client_datasets[client_id][idxs]
        # the target is the natural client id, which is the class
        return imgs, np.full(len(idxs), client_id, np.int32)

    def _get_val_batch(self, idxs: np.ndarray):
        return (self.test_images[idxs],
                self.test_targets[idxs].astype(np.int32))
