"""The port's offline datasets and PersonaChat's raw-json ingest against the
JAX package's numpy readers on the CPU, bitwise.

* ``FedDigits`` and ``FedPatches32`` (scikit-learn's bundled data; skipped
  where scikit-learn is absent): the per-client ``.npy`` files, the
  ``test.npz``, ``stats.json`` with its cache version, the natural and
  overlay partitions and the batches fetched from them; a Patches32 cache
  of another version is rebuilt; Digits through the CV entry point;
* ``FedPERSONA`` from the raw ``personachat_self_original.json`` of the
  reference's own test (``tests/test_data.py``): the cached columns,
  offsets and stats of both splits, and a flat batch.
"""

import json

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.data import fed_datasets
from commefficient_tpu_torch.data.persona import FedPERSONA
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser


def _assert_same_dataset(got, ref, idx):
    assert got.num_clients == ref.num_clients
    np.testing.assert_array_equal(got.images_per_client,
                                  ref.images_per_client)
    np.testing.assert_array_equal(got.data_per_client, ref.data_per_client)
    assert len(got) == len(ref)
    if got.train:
        assert len(got.client_datasets) == len(ref.client_datasets)
        for a, b in zip(got.client_datasets, ref.client_datasets):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.get_flat_batch(idx), ref.get_flat_batch(idx)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got.test_images, ref.test_images)
        np.testing.assert_array_equal(got.test_targets, ref.test_targets)
        for a, b in zip(got.get_val_batch(idx), ref.get_val_batch(idx)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,num_clients,iid", [
    ("Digits", 100, False), ("Digits", 7, True), ("Patches32", 20, False)])
def test_offline_dataset_bitwise_matches_jax(tmp_path, name, num_clients,
                                             iid):
    pytest.importorskip("sklearn")
    from commefficient_tpu import data as jax_data
    ref_cls = {"Digits": jax_data.FedDigits,
               "Patches32": jax_data.FedPatches32}[name]
    cls = fed_datasets[name]
    for train in (True, False):
        kw = dict(num_clients=num_clients, do_iid=iid, train=train, seed=3)
        ref = ref_cls(dataset_dir=str(tmp_path / "ref"), **kw)
        got = cls(dataset_dir=str(tmp_path / "port"), **kw)
        n = len(got)
        idx = np.random.RandomState(0).choice(n, min(n, 64), replace=False)
        _assert_same_dataset(got, ref, idx)
    for fn in ["stats.json"] + [f"client{c}.npy" for c in range(10)]:
        a, b = (tmp_path / side / fn for side in ("port", "ref"))
        assert a.read_bytes() == b.read_bytes(), fn
    with np.load(tmp_path / "port" / "test.npz") as a, \
            np.load(tmp_path / "ref" / "test.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    assert json.loads((tmp_path / "port" / "stats.json").read_text())[
        "version"] == cls.version


def test_patches32_rebuilds_a_stale_cache(tmp_path):
    pytest.importorskip("sklearn")
    cls = fed_datasets["Patches32"]
    cls(dataset_dir=str(tmp_path), num_clients=10, seed=0)
    stats = json.loads((tmp_path / "stats.json").read_text())
    np.save(tmp_path / "client0.npy", np.zeros((1, 32, 32, 3), np.float32))
    (tmp_path / "stats.json").write_text(json.dumps(
        dict(stats, version=1)))
    again = cls(dataset_dir=str(tmp_path), num_clients=10, seed=0)
    assert json.loads((tmp_path / "stats.json").read_text()) == stats
    assert again.client_datasets[0].shape[0] == stats[
        "images_per_client"][0]


def test_digits_through_the_cv_entry_point(tmp_path):
    pytest.importorskip("sklearn")
    args = build_parser().parse_args([
        "--dataset_name", "Digits", "--model", "TinyMLP", "--mode",
        "uncompressed", "--num_clients", "100", "--num_workers", "4",
        "--local_batch_size", "8", "--valid_batch_size", "304",
        "--lr_scale", "0.1", "--num_epochs", "1", "--dataset_dir",
        str(tmp_path), "--device", "cpu"])
    learner, row = cv.train(args, max_rounds=2, log=False)
    assert learner.cfg.grad_size == 64 * 32 + 32 + 32 * 10 + 10
    assert all(np.isfinite(r["loss"]) for r in row["rounds"])
    assert all(r["upload_bytes"] == 4 * 4 * learner.cfg.grad_size
               for r in row["rounds"])
    assert np.isfinite(row["test_loss"]) and 0 <= row["test_acc"] <= 1
    assert bool(torch.isfinite(learner.state.weights).all())


def _write_raw_persona(path):
    """The tiny PersonaChat json of the reference's
    ``test_persona_raw_json_ingest``."""
    raw = {"train": [], "valid": []}
    for p in range(3):
        raw["train"].append({
            "personality": [f"i like thing {p} .", "i have a cat ."],
            "utterances": [
                {"candidates": ["wrong reply .", f"right reply {p} ."],
                 "history": ["hello there ."]},
                {"candidates": ["nope .", "yes indeed ."],
                 "history": ["hello there .", f"right reply {p} .",
                             "how are you ?"]},
            ],
        })
    raw["valid"].append(raw["train"][0])
    path.mkdir(parents=True, exist_ok=True)
    (path / "personachat_self_original.json").write_text(json.dumps(raw))


def test_persona_raw_json_ingest_bitwise_matches_jax(tmp_path):
    from commefficient_tpu.data.persona import FedPERSONA as JaxFedPERSONA
    for side in ("ref", "port"):
        _write_raw_persona(tmp_path / side)
    for train in (True, False):
        kw = dict(train=train, do_iid=False, num_clients=None, seed=0,
                  max_seq_len=128, personality_permutations=2)
        ref = JaxFedPERSONA(dataset_dir=str(tmp_path / "ref"), **kw)
        got = FedPERSONA(dataset_dir=str(tmp_path / "port"), **kw)
        assert got.num_clients == ref.num_clients == 3
        np.testing.assert_array_equal(got.images_per_client,
                                      ref.images_per_client)
        assert len(got) == len(ref)
        np.testing.assert_array_equal(got.offsets, ref.offsets)
        for a, b in zip(got.cols, ref.cols):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        idx = np.arange(len(got))[::-1].copy()
        fetch = "get_flat_batch" if train else "get_val_batch"
        for a, b in zip(getattr(got, fetch)(idx), getattr(ref, fetch)(idx)):
            np.testing.assert_array_equal(a, b)
    assert list(got.images_per_client) == [4, 4, 4]   # 2 permutations
    for fn in ("stats.json", "cache_meta.json"):
        a, b = (json.loads((tmp_path / side / fn).read_text())
                for side in ("port", "ref"))
        assert a == b, fn
