"""Federated EMNIST from LEAF json shards (numpy copy of
``commefficient_tpu/data/emnist.py``).

Natural partition: one LEAF writer per client. Preparation packs every
client into ``train.npz`` (images concatenated, with a client-offsets
vector) and the test split into ``test.npz``. Expects the standard LEAF
layout ``<dir>/{train,test}/*.json`` with ``user_data[user] = {"x":
[784-float lists], "y": [labels]}``.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import FedDataset


def _read_leaf_dir(d):
    users, data = [], {}
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            blob = json.load(f)
        for u in blob["users"]:
            users.append(u)
            data[u] = blob["user_data"][u]
    return users, data


class FedEMNIST(FedDataset):
    def train_fn(self):
        return os.path.join(self.dataset_dir, "train.npz")

    def test_fn(self):
        return os.path.join(self.dataset_dir, "test.npz")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.train:
            with np.load(self.train_fn()) as t:
                self.client_images = t["x"]
                self.client_targets = t["y"]
                self.client_offsets = t["offsets"]
        else:
            with np.load(self.test_fn()) as t:
                self.test_images = t["x"]
                self.test_targets = t["y"]

    def prepare_datasets(self):
        train_dir = os.path.join(self.dataset_dir, "train")
        test_dir = os.path.join(self.dataset_dir, "test")
        if not os.path.isdir(train_dir):
            raise FileNotFoundError(
                f"LEAF EMNIST json shards not found under {train_dir} "
                f"(offline environment — place LEAF femnist train/test json "
                f"dirs there, or use --dataset_name Synthetic)")
        users, data = _read_leaf_dir(train_dir)
        images, targets, offsets, per_client = [], [], [0], []
        for u in users:
            x = np.asarray(data[u]["x"], np.float32).reshape(-1, 28, 28, 1)
            y = np.asarray(data[u]["y"], np.int32)
            images.append(x)
            targets.append(y)
            offsets.append(offsets[-1] + len(y))
            per_client.append(len(y))
        np.savez(self.train_fn(), x=np.concatenate(images),
                 y=np.concatenate(targets),
                 offsets=np.asarray(offsets, np.int64))
        _, tdata = _read_leaf_dir(test_dir)
        tx = np.concatenate([np.asarray(v["x"], np.float32)
                             .reshape(-1, 28, 28, 1) for v in tdata.values()])
        ty = np.concatenate([np.asarray(v["y"], np.int32)
                             for v in tdata.values()])
        np.savez(self.test_fn(), x=tx, y=ty)
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": per_client,
                       "num_val_images": int(len(ty))}, f)

    def _get_train_batch(self, client_id: int, idxs: np.ndarray):
        start = self.client_offsets[client_id]
        return (self.client_images[start + idxs],
                self.client_targets[start + idxs])

    def _get_val_batch(self, idxs: np.ndarray):
        return self.test_images[idxs], self.test_targets[idxs]
