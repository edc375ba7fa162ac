"""Procedurally generated federated CV dataset (numpy copy of
``commefficient_tpu/data/synthetic.py``, same generator seeds).

Class-clustered Gaussian images, one class per natural client: client
i's data is all class i, the maximally non-iid regime FetchSGD targets.
"""

from __future__ import annotations

import json
import os

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset


class SyntheticCV(FedDataset):
    def __init__(self, dataset_dir: str = "./dataset/synthetic",
                 num_classes: int = 10, per_class: int = 512,
                 num_val: int = 1024, image_size: int = 32, channels: int = 3,
                 gen_seed: int = 1234, **kw):
        self.num_classes = num_classes
        self.per_class = per_class
        self.num_val = num_val
        self.image_size = image_size
        self.channels = channels
        self.gen_seed = gen_seed
        super().__init__(dataset_dir=dataset_dir, **kw)
        rng = np.random.RandomState(gen_seed)
        shape = (num_classes, image_size, image_size, channels)
        # one smooth template per class + noise: learnable but not trivial
        self.templates = rng.randn(*shape).astype(np.float32)

    def prepare_datasets(self):
        os.makedirs(self.dataset_dir, exist_ok=True)
        stats = {"images_per_client": [self.per_class] * self.num_classes,
                 "num_val_images": self.num_val}
        with open(self.stats_fn(), "w") as f:
            json.dump(stats, f)

    def _make(self, classes: np.ndarray, idxs: np.ndarray):
        # deterministic per-example noise keyed by (class, idx)
        imgs = self.templates[classes].copy()
        for i, (c, j) in enumerate(zip(classes, idxs)):
            r = np.random.RandomState(self.gen_seed + 7919 * int(c) + int(j))
            imgs[i] += 0.5 * r.randn(self.image_size, self.image_size,
                                     self.channels).astype(np.float32)
        return imgs

    def _get_train_batch(self, client_id: int, idxs: np.ndarray):
        classes = np.full(len(idxs), client_id)
        return (self._make(classes, idxs),
                classes.astype(np.int32))

    def _get_val_batch(self, idxs: np.ndarray):
        classes = (idxs % self.num_classes).astype(np.int32)
        return self._make(classes, idxs + 10_000_000), classes
