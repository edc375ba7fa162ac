"""Federated CIFAR10/100 (numpy copy of ``commefficient_tpu/data/cifar.py``).

Natural partition: one class per client; the train images are split by
label into ``client<c>.npy`` files (``PreparedArrayDataset``). Ingestion
reads the standard CIFAR python-pickle batches (``cifar-10-batches-py`` /
``cifar-100-python``) already under ``dataset_dir``; there is no
downloader, and a missing file raises with where to put them.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import PreparedArrayDataset


def _nhwc(rows) -> np.ndarray:
    """CIFAR's (N, 3072) uint8 rows (channel planes of 32 x 32) as NHWC."""
    return np.asarray(rows).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def _load_cifar10_raw(root):
    batches = [f"data_batch_{i}" for i in range(1, 6)]
    d = os.path.join(root, "cifar-10-batches-py")
    xs, ys = [], []
    for b in batches:
        with open(os.path.join(d, b), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(entry["data"])
        ys.extend(entry["labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        t = pickle.load(f, encoding="latin1")
    train_x = _nhwc(np.vstack(xs))
    test_x = _nhwc(t["data"])
    return (train_x, np.asarray(ys), test_x, np.asarray(t["labels"]), 10)


def _load_cifar100_raw(root):
    d = os.path.join(root, "cifar-100-python")
    with open(os.path.join(d, "train"), "rb") as f:
        tr = pickle.load(f, encoding="latin1")
    with open(os.path.join(d, "test"), "rb") as f:
        te = pickle.load(f, encoding="latin1")
    train_x = _nhwc(tr["data"])
    test_x = _nhwc(te["data"])
    return (train_x, np.asarray(tr["fine_labels"]), test_x,
            np.asarray(te["fine_labels"]), 100)


class FedCIFAR10(PreparedArrayDataset):
    _loader = staticmethod(_load_cifar10_raw)
    name = "CIFAR10"

    def _make_xy(self):
        try:
            return self._loader(self.dataset_dir)
        except FileNotFoundError as e:
            raise FileNotFoundError(
                f"{self.name} raw files not found under {self.dataset_dir} "
                f"(no downloader in this offline environment — place the "
                f"python-pickle batches there, or use --dataset_name "
                f"Synthetic): {e}") from None


class FedCIFAR100(FedCIFAR10):
    _loader = staticmethod(_load_cifar100_raw)
    name = "CIFAR100"
