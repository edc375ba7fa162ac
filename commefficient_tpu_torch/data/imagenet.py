"""Federated ImageNet: each wnid class directory is one client (numpy copy
of ``commefficient_tpu/data/imagenet.py``).

Expects the standard extracted layout ``<dir>/{train,val}/<wnid>/*.JPEG``.

* ``prepare_datasets`` decodes every JPEG once with a thread pool (PIL,
  imported there) into per-client uint8 arrays at ``storage_size``
  (shorter side, aspect kept, centre crop): ``train_client_xxxxx.npy``
  per wnid, plus the validation arrays. Training never touches a JPEG:
  batches are rows of memory-mapped uint8 arrays, copied out by the
  native threaded gather (``commefficient_tpu_torch.native``).
* augmentation is ``data/transforms.py``: RandomResizedCrop(224) + flip +
  normalize for train (one native pass), resize(256) + centre crop(224)
  + normalize for validation (numpy), batched on the uint8 rows. Crops
  are sampled from the stored 256 x 256 centre crop, not the full
  original image.
"""

from __future__ import annotations

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from commefficient_tpu_torch import native
from commefficient_tpu_torch.data.fed_dataset import FedDataset


def _decode_one(path: str, storage: int) -> np.ndarray:
    """uint8 (storage, storage, 3): shorter side -> storage, centre crop."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = storage / min(w, h)
    img = img.resize((max(storage, round(w * scale)),
                      max(storage, round(h * scale))), Image.BILINEAR)
    w, h = img.size
    left, top = (w - storage) // 2, (h - storage) // 2
    img = img.crop((left, top, left + storage, top + storage))
    return np.asarray(img, np.uint8)


class FedImageNet(FedDataset):
    image_size = 224    # crop fed to the model
    storage_size = 256  # stored shorter-side resolution (= val resize)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._mmap_cache = {}
        self._val_targets = None
        # client files are written in order and stats.json last, so the
        # last client file (and the validation arrays) marks a complete
        # build; an interrupted one is rebuilt
        n_nat = len(self.images_per_client)
        if (self.train and n_nat
                and not os.path.exists(self._client_fn(n_nat - 1))):
            self.prepare_datasets()
        if (not self.train and self.num_val_images
                and not (os.path.exists(os.path.join(self.dataset_dir,
                                                     "val_images.npy"))
                         and os.path.exists(os.path.join(
                             self.dataset_dir, "val_targets.npy")))):
            self.prepare_datasets()

    # --- preprocess once --------------------------------------------------
    def _client_fn(self, i: int) -> str:
        return os.path.join(self.dataset_dir, f"train_client_{i:05d}.npy")

    def prepare_datasets(self):
        train_dir = os.path.join(self.dataset_dir, "train")
        if not os.path.isdir(train_dir):
            raise FileNotFoundError(
                f"ImageNet not found under {self.dataset_dir} (can't "
                f"download ImageNet; extract it there or use Synthetic)")
        try:
            from PIL import Image  # noqa: F401
        except ImportError:
            raise ImportError("PIL is required to decode ImageNet JPEGs "
                              "in this environment") from None
        wnids = sorted(os.listdir(train_dir))
        s = self.storage_size
        per_client = []
        val_dir = os.path.join(self.dataset_dir, "val")
        val_wnids = (sorted(os.listdir(val_dir))
                     if os.path.isdir(val_dir) else [])
        val_paths = [(p, i) for i, w in enumerate(val_wnids)
                     for p in sorted(glob.glob(os.path.join(val_dir, w,
                                                            "*")))]
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
            for i, w in enumerate(wnids):
                paths = sorted(glob.glob(os.path.join(train_dir, w, "*")))
                # a complete client file (right count and resolution) from
                # an interrupted build is kept, not decoded again
                if os.path.exists(self._client_fn(i)):
                    try:
                        arr = np.load(self._client_fn(i), mmap_mode="r")
                        complete = arr.shape == (len(paths), s, s, 3)
                    except (ValueError, OSError):
                        complete = False  # a truncated file
                    if complete:
                        per_client.append(len(paths))
                        continue
                imgs = list(pool.map(lambda p: _decode_one(p, s), paths))
                tmp = self._client_fn(i) + ".tmp.npy"
                np.save(tmp, np.stack(imgs) if imgs
                        else np.zeros((0, s, s, 3), np.uint8))
                os.replace(tmp, self._client_fn(i))
                per_client.append(len(imgs))
            # validation streams into a memmap (50k x 256^2 x 3 uint8 is
            # ~10 GB)
            val_mm = np.lib.format.open_memmap(
                os.path.join(self.dataset_dir, "val_images.npy"), mode="w+",
                dtype=np.uint8, shape=(len(val_paths), s, s, 3))
            for j, img in enumerate(pool.map(
                    lambda pi: _decode_one(pi[0], s), val_paths)):
                val_mm[j] = img
            val_mm.flush()
            del val_mm
        np.save(os.path.join(self.dataset_dir, "val_targets.npy"),
                np.asarray([t for _, t in val_paths], np.int32))
        with open(self.stats_fn(), "w") as f:
            json.dump({"images_per_client": per_client,
                       "num_val_images": len(val_paths)}, f)

    # --- mmap-backed batch fetch ------------------------------------------
    _MMAP_CACHE_MAX = 64  # open files are finite; 1000 wnids would not fit

    def _mmap(self, fn: str):
        """The memory map of ``fn`` from an LRU cache of at most
        ``_MMAP_CACHE_MAX`` (insertion order; a hit moves to the end)."""
        cache = self._mmap_cache
        if fn not in cache:
            if len(cache) >= self._MMAP_CACHE_MAX:
                cache.pop(next(iter(cache)))  # evict the oldest
            try:
                cache[fn] = np.load(fn, mmap_mode="r")
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"{fn} missing — the preprocessed arrays were not "
                    f"built; delete {self.stats_fn()} to re-run "
                    "prepare_datasets") from None
        else:
            cache[fn] = cache.pop(fn)  # refresh the LRU position
        return cache[fn]

    @staticmethod
    def _gather(arr, idxs: np.ndarray) -> np.ndarray:
        """Rows ``arr[idxs]``, read in sorted order (mmap locality), then
        put back in request order; a C-contiguous source (a memory map
        included) by the native threaded copy."""
        order = np.sort(np.asarray(idxs))
        inv = np.argsort(np.argsort(idxs))
        if native.lib() is not None and arr.flags["C_CONTIGUOUS"]:
            return native.gather_rows(arr, order)[inv]
        return np.asarray(arr[order])[inv]

    def _get_train_batch(self, client_id: int, idxs: np.ndarray):
        arr = self._mmap(self._client_fn(client_id))
        # sampler indices are unique within a client
        return (self._gather(arr, idxs),
                np.full(len(idxs), client_id, np.int32))

    def _get_val_batch(self, idxs: np.ndarray):
        imgs = self._mmap(os.path.join(self.dataset_dir, "val_images.npy"))
        if self._val_targets is None:
            self._val_targets = np.load(
                os.path.join(self.dataset_dir, "val_targets.npy"))
        return self._gather(imgs, idxs), self._val_targets[idxs]
