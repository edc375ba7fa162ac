"""Real-data federated datasets with no download (numpy copy of
``commefficient_tpu/data/offline.py``): both build from scikit-learn's
bundled data, imported inside ``_make_xy`` so that the package imports
where scikit-learn is absent (the card's machine).

* ``FedDigits``: scikit-learn's 1,797 8x8 grayscale digit scans, 10
  classes, one class per natural client;
* ``FedPatches32``: 32x32x3 patches cut from scikit-learn's two bundled
  photographs, labelled (photo, vertical band) in a 2 x 5 grid: 10
  classes at CIFAR's input shape, so ResNet9 runs at its full d.
"""

from __future__ import annotations

import numpy as np

from commefficient_tpu_torch.data.fed_dataset import PreparedArrayDataset


class FedDigits(PreparedArrayDataset):
    """1,797 8x8 digit scans; ~150 train and ~30 validation a class."""

    name = "Digits"
    num_classes = 10

    def _make_xy(self):
        from sklearn.datasets import load_digits
        d = load_digits()
        x = (d.images.astype(np.float32) / 16.0)[..., None]  # (N, 8, 8, 1)
        y = d.target.astype(np.int32)
        # every 6th example of each class validates: no RNG, one split
        val_mask = np.zeros(len(y), bool)
        for c in range(10):
            rows = np.nonzero(y == c)[0]
            val_mask[rows[::6]] = True
        return x[~val_mask], y[~val_mask], x[val_mask], y[val_mask], 10


class FedPatches32(PreparedArrayDataset):
    """32x32x3 patches of two photos; 10 (photo, band) classes.

    Train and validation are spatially disjoint (version 2): validation
    patches start at column ``VAL_X0`` or later, training patches end at
    least ``GAP`` pixels before it, and the patches between are dropped.
    """

    name = "Patches32"
    num_classes = 10
    stride = 8
    bands = 5
    version = 2    # v1 was an interleaved split; its caches rebuild
    VAL_X0 = 496   # the validation strip starts here
    GAP = 32       # training patches end >= GAP px before VAL_X0

    @classmethod
    def _split_for_x0(cls, x0: int, P: int = 32):
        """'val' | 'train' | None (guard band) for a patch at column x0."""
        if x0 >= cls.VAL_X0:
            return "val"
        if x0 + P <= cls.VAL_X0 - cls.GAP:
            return "train"
        return None

    def _make_xy(self):
        from sklearn.datasets import load_sample_images
        photos = load_sample_images().images  # two (427, 640, 3) uint8
        xs, ys, in_val = [], [], []
        P, S = 32, self.stride
        for img_idx, img in enumerate(photos):
            H, W, _ = img.shape
            band_h = (H - P + 1) / float(self.bands)
            for y0 in range(0, H - P + 1, S):
                band = min(int(y0 / band_h), self.bands - 1)
                label = img_idx * self.bands + band
                for x0 in range(0, W - P + 1, S):
                    split = self._split_for_x0(x0, P)
                    if split is None:
                        continue
                    xs.append(img[y0:y0 + P, x0:x0 + P])
                    ys.append(label)
                    in_val.append(split == "val")
        x = np.asarray(xs, np.float32) / 255.0
        y = np.asarray(ys, np.int32)
        val_mask = np.asarray(in_val, bool)
        # standardized per channel with the training split's statistics
        mean = x[~val_mask].mean(axis=(0, 1, 2), keepdims=True)
        std = x[~val_mask].std(axis=(0, 1, 2), keepdims=True)
        x = (x - mean) / np.maximum(std, 1e-6)
        return x[~val_mask], y[~val_mask], x[val_mask], y[val_mask], 10
