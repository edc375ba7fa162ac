"""The port's file-backed datasets and transforms against the JAX
package's numpy readers on the CPU.

* every ``get_transforms`` pipeline against the reference's own
  pipelines (its C++ host path where that builds, as the port's) from
  one ``RandomState`` seed, bitwise, the generator left
  at the same draw; and against the reference's numpy stages: bitwise,
  but within the reference's ``atol=2e-4`` (``tests/test_native.py``)
  for the RandomResizedCrop, which the C++ pass fuses with the affine;
* ``FedCIFAR10``/``FedCIFAR100`` on tiny python-pickle batches written
  here, ``FedEMNIST`` on the LEAF json shards of the reference's test,
  ``FedImageNet`` on its JPEG tree: partitions and batches (the
  reference's own transforms included) bitwise the reference's, and the
  missing-file errors;
* the CV entry point on tiny CIFAR-10 pickles at ``--scan_rounds 2`` for
  2 rounds against the reference's ``training.cv.train`` from the same
  narrow ResNet9 weights: per-round loss rtol 1e-5, bytes exact.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu import data as jax_data
from commefficient_tpu.data import transforms as JT
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.training import cv as jax_cv
from commefficient_tpu.training.args import build_parser as jax_parser
from commefficient_tpu_torch.data import fed_datasets
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.data.imagenet import FedImageNet
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.utils.params import params_from_jax

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tests' tensors are small: one intra-op thread keeps each
    operation from waiting on threads that the suite's other workers
    hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(name, train):
    rng = np.random.RandomState(1)
    if name == "EMNIST":
        return rng.rand(5, 28, 28, 1).astype(np.float32)
    if name == "ImageNet":
        return rng.randint(0, 256, (3, 40, 56, 3), np.uint8)
    return rng.randint(0, 256, (5, 32, 32, 3), np.uint8)


# the reference's numpy stages of each pipeline, as its transforms.py
# composes them when its C++ path is absent
NUMPY_STAGES = {
    ("CIFAR10", True): JT.compose(
        JT.normalize(JT.CIFAR10_MEAN, JT.CIFAR10_STD),
        JT.random_crop(32, 4, "reflect"), JT.random_hflip(0.5)),
    ("CIFAR10", False): JT.normalize(JT.CIFAR10_MEAN, JT.CIFAR10_STD),
    ("CIFAR100", True): JT.compose(
        JT.normalize(JT.CIFAR100_MEAN, JT.CIFAR100_STD),
        JT.random_crop(32, 4, "reflect"), JT.random_hflip(0.5)),
    ("CIFAR100", False): JT.normalize(JT.CIFAR100_MEAN, JT.CIFAR100_STD),
    ("EMNIST", True): JT.compose(
        JT.normalize(JT.FEMNIST_MEAN, JT.FEMNIST_STD),
        JT.random_crop(28, 2, "constant", fill=1.0)),
    ("EMNIST", False): JT.normalize(JT.FEMNIST_MEAN, JT.FEMNIST_STD),
    ("ImageNet", True): JT.compose(
        JT.random_resized_crop(224), JT.random_hflip(0.5),
        JT.normalize(JT.IMAGENET_MEAN, JT.IMAGENET_STD)),
    ("ImageNet", False): JT.imagenet_val_transforms,
}


@pytest.mark.parametrize("name,train", sorted(NUMPY_STAGES))
def test_transforms_bitwise_the_references_numpy_stages(name, train):
    imgs = _images(name, train)
    labels = np.arange(len(imgs), dtype=np.int32)
    rngs = [np.random.RandomState(7) for _ in range(3)]
    got = T.get_transforms(name, train)([imgs.copy(), labels], rngs[0])
    ref = NUMPY_STAGES[name, train]([imgs.copy(), labels], rngs[1])
    assert got[0].dtype == ref[0].dtype == np.float32
    if (name, train) == ("ImageNet", True):
        # the C++ RandomResizedCrop fuses the resize with the affine
        np.testing.assert_allclose(got[0], ref[0], atol=2e-4)
    else:
        np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], labels)
    # the reference's own pipeline (its C++ host path where that builds)
    own = JT.get_transforms(name, train)([imgs.copy(), labels], rngs[2])
    np.testing.assert_array_equal(got[0], own[0])
    # every pipeline leaves the generator at the same draw
    assert len({r.randint(1 << 30) for r in rngs}) == 1
    assert T.get_transforms("Synthetic", train) is None


def test_transform_stages_bitwise():
    rng_img = np.random.RandomState(3)
    imgs = rng_img.randint(0, 256, (4, 21, 33, 3), np.uint8)
    for stage, ref_stage in (
            (T.random_resized_crop(16), JT.random_resized_crop(16)),
            (T.resize_center_crop(12, 18), JT.resize_center_crop(12, 18)),
            (T.random_crop(21, 3, "constant", 0.5),
             JT.random_crop(21, 3, "constant", 0.5)),
            (T.random_hflip(0.3), JT.random_hflip(0.3))):
        a, b = np.random.RandomState(2), np.random.RandomState(2)
        x = imgs[:, :, :21] if stage.__qualname__.startswith(
            "random_crop") else imgs
        np.testing.assert_array_equal(stage([x.copy()], a)[0],
                                      ref_stage([x.copy()], b)[0])
    for h, w in ((40, 40), (10, 90), (90, 10)):
        a, b = np.random.RandomState(h), np.random.RandomState(h)
        for _ in range(20):
            assert T.rrc_crop_params(h, w, a) == JT.rrc_crop_params(h, w, b)
    np.testing.assert_array_equal(T._bilinear_resize(imgs[0], 7, 50),
                                  JT._bilinear_resize(imgs[0], 7, 50))


def write_cifar(root, which="cifar10", per_batch=40, n_test=20, seed=0):
    """Tiny CIFAR pickles in the real layout, balanced labels."""
    rng = np.random.RandomState(seed)
    if which == "cifar10":
        d = os.path.join(root, "cifar-10-batches-py")
        files = [(f"data_batch_{i}", per_batch, "labels")
                 for i in range(1, 6)] + [("test_batch", n_test, "labels")]
        n_cls = 10
    else:
        d = os.path.join(root, "cifar-100-python")
        files = [("train", 5 * per_batch, "fine_labels"),
                 ("test", n_test, "fine_labels")]
        n_cls = 100
    os.makedirs(d, exist_ok=True)
    for name, n, key in files:
        labels = np.arange(n) % n_cls
        rng.shuffle(labels)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         key: labels.tolist()}, f)


def _assert_same_batches(got, ref, idx):
    assert got.num_clients == ref.num_clients
    np.testing.assert_array_equal(got.images_per_client,
                                  ref.images_per_client)
    np.testing.assert_array_equal(got.data_per_client, ref.data_per_client)
    assert len(got) == len(ref)
    fetch = "get_flat_batch" if got.train else "get_val_batch"
    for _ in range(2):   # the transforms' draws advance alike
        for a, b in zip(getattr(got, fetch)(idx), getattr(ref, fetch)(idx)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,which,clients", [
    ("CIFAR10", "cifar10", 20), ("CIFAR100", "cifar100", None)])
def test_cifar_bitwise_matches_jax(tmp_path, name, which, clients):
    write_cifar(str(tmp_path / "port"), which)
    write_cifar(str(tmp_path / "ref"), which)
    for train in (True, False):
        for iid in (False, True):
            kw = dict(num_clients=clients if not iid else 7, do_iid=iid,
                      train=train, seed=3,
                      transform=T.get_transforms(name, train))
            got = fed_datasets[name](dataset_dir=str(tmp_path / "port"), **kw)
            ref = jax_data.fed_datasets[name](
                dataset_dir=str(tmp_path / "ref"),
                **dict(kw, transform=JT.get_transforms(name, train)))
            idx = np.random.RandomState(0).choice(len(got), 12, replace=False)
            _assert_same_batches(got, ref, idx)
    for fn in ["stats.json", "client0.npy", "client9.npy"]:
        assert (tmp_path / "port" / fn).read_bytes() == \
            (tmp_path / "ref" / fn).read_bytes()


def test_cifar_missing_files_raise_the_references_error(tmp_path):
    for name in ("CIFAR10", "CIFAR100"):
        with pytest.raises(FileNotFoundError) as got:
            fed_datasets[name](dataset_dir=str(tmp_path / "p"))
        with pytest.raises(FileNotFoundError) as ref:
            jax_data.fed_datasets[name](dataset_dir=str(tmp_path / "p"))
        assert str(got.value) == str(ref.value)
        assert "python-pickle batches" in str(got.value)


def _write_leaf(root):
    """The LEAF shards of the reference's ``test_emnist_leaf_json_ingest``."""
    rng = np.random.RandomState(0)
    for split, users in (("train", ["w0", "w1", "w2"]), ("test", ["w9"])):
        d = root / split
        d.mkdir(parents=True)
        blob = {"users": users, "user_data": {}}
        for i, u in enumerate(users):
            n = 3 + i
            blob["user_data"][u] = {
                "x": rng.rand(n, 784).round(3).tolist(),
                "y": rng.randint(0, 62, n).tolist(),
            }
        with open(d / "shard0.json", "w") as f:
            json.dump(blob, f)


def test_emnist_bitwise_matches_jax(tmp_path):
    for side in ("port", "ref"):
        _write_leaf(tmp_path / side)
    for train in (True, False):
        kw = dict(train=train, do_iid=False, num_clients=None, seed=0)
        got = fed_datasets["EMNIST"](
            dataset_dir=str(tmp_path / "port"),
            transform=T.get_transforms("EMNIST", train), **kw)
        ref = jax_data.FedEMNIST(dataset_dir=str(tmp_path / "ref"),
                                 transform=JT.get_transforms("EMNIST", train),
                                 **kw)
        idx = np.arange(len(got))[::-1].copy()
        _assert_same_batches(got, ref, idx)
    assert list(got.images_per_client) == [3, 4, 5]
    with np.load(tmp_path / "port" / "train.npz") as a, \
            np.load(tmp_path / "ref" / "train.npz") as b:
        for key in ("x", "y", "offsets"):
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(FileNotFoundError, match="LEAF EMNIST"):
        fed_datasets["EMNIST"](dataset_dir=str(tmp_path / "none"))


def _jpeg_tree(root, n_wnids=2, n_train=6, n_val=2, hw=(40, 56)):
    """The reference's ``_fake_imagenet_tree``."""
    from PIL import Image
    rng = np.random.RandomState(0)
    for split, n in (("train", n_train), ("val", n_val)):
        for w in range(n_wnids):
            d = os.path.join(root, split, f"n{w:08d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                arr = rng.randint(0, 255, (hw[0], hw[1], 3), np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"img_{i}.JPEG"))


def test_imagenet_bitwise_matches_jax(tmp_path):
    pytest.importorskip("PIL")

    class Tiny(FedImageNet):
        image_size, storage_size = 24, 32

    class RefTiny(jax_data.FedImageNet):
        image_size, storage_size = 24, 32

    for side in ("port", "ref"):
        _jpeg_tree(str(tmp_path / side))
    for train in (True, False):
        for transform, ref_transform in (
                (None, None), (T.get_transforms("ImageNet", train),
                               JT.get_transforms("ImageNet", train))):
            kw = dict(train=train, seed=0)
            got = Tiny(dataset_dir=str(tmp_path / "port"),
                       transform=transform, **kw)
            ref = RefTiny(dataset_dir=str(tmp_path / "ref"),
                          transform=ref_transform, **kw)
            idx = np.array([3, 0, 1] if not train else [7, 0, 11, 3])
            _assert_same_batches(got, ref, idx)
    for fn in ("train_client_00000.npy", "train_client_00001.npy",
               "val_images.npy", "val_targets.npy", "stats.json"):
        assert (tmp_path / "port" / fn).read_bytes() == \
            (tmp_path / "ref" / fn).read_bytes()
    # the LRU cache of memory maps holds at most _MMAP_CACHE_MAX
    got = Tiny(dataset_dir=str(tmp_path / "port"), train=True)
    got._MMAP_CACHE_MAX = 1
    got.get_flat_batch(np.array([0, 11]))
    assert list(got._mmap_cache) == [got._client_fn(1)]
    with pytest.raises(FileNotFoundError, match="ImageNet not found"):
        Tiny(dataset_dir=str(tmp_path / "none"))


def _jax_params(seed):
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    return jax.device_get(JaxResNet9(channels=NARROW).init(
        init_rng, jnp.zeros((1, 32, 32, 3)), train=False)["params"])


FLAGS = ["--dataset_name", "CIFAR10", "--model", "ResNet9", "--mode",
         "sketch", "--error_type", "virtual", "--virtual_momentum", "0.9",
         "--num_clients", "20", "--num_workers", "4", "--local_batch_size",
         "8", "--k", "500", "--num_rows", "3", "--num_cols", "4000",
         "--pivot_epoch", "5", "--lr_scale", "0.4", "--scan_rounds", "2",
         "--valid_batch_size", "20", "--num_epochs", "1"]


def test_cv_entry_point_on_cifar10_files_matches_jax(tmp_path, monkeypatch):
    """Two rounds (one window) of the example's flags at a narrow width on
    tiny CIFAR-10 pickles: the same batches, augmentation included, from
    the same weights through both packages' ``training.cv.train``."""
    params = _jax_params(21)

    class FromJax(ResNet9):
        def reset_parameters(self, generator=None):
            self.load_state_dict(params_from_jax(params))

    monkeypatch.setattr(cv, "get_model", lambda name, **kw: FromJax(
        channels=NARROW, num_classes=kw["num_classes"]))
    monkeypatch.setattr(jax_cv, "get_model", lambda name, **kw: JaxResNet9(
        channels=NARROW, num_classes=kw["num_classes"]))
    seen = {}
    for cls, tag in ((JaxLearner, "ref"), (FedLearner, "port")):
        saved = cls.finalize_scan_metrics

        def record(learner, raw, saved=saved, tag=tag):
            out = saved(learner, raw)
            seen.setdefault(tag, []).extend(out)
            return out
        monkeypatch.setattr(cls, "finalize_scan_metrics", record)
    for side in ("port", "ref"):
        write_cifar(str(tmp_path / side))
    ref_l, ref_row = jax_cv.train(jax_parser().parse_args(
        FLAGS + ["--dataset_dir", str(tmp_path / "ref")]), max_rounds=2,
        log=False)
    got_l, got_row = cv.train(build_parser().parse_args(
        FLAGS + ["--dataset_dir", str(tmp_path / "port"), "--device",
                 "cpu"]), max_rounds=2, log=False)
    assert len(seen["ref"]) == len(seen["port"]) == 2
    for r, g in zip(seen["ref"], seen["port"]):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints"):
            assert g[key] == r[key], key
    assert got_row["rounds"] == seen["port"]
    np.testing.assert_allclose(got_row["test_loss"], ref_row["test_loss"],
                               rtol=1e-5)
    assert got_l.total_upload_bytes == ref_l.total_upload_bytes
    np.testing.assert_allclose(got_l.state.weights.numpy(),
                               np.asarray(ref_l.state.weights), rtol=0,
                               atol=1e-5)
