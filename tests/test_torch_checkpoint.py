"""Checkpoint format v3, the batcher's resume cursor and the finetune
loader of the port, on the CPU.

* the format: a bit flip fails the digest; ``find_latest_checkpoint``
  falls back past a corrupt newest file; retention keeps the newest 3 step
  files and the plain export; a fingerprint mismatch raises and leaves the
  learner untouched;
* the data layer under a resume: ``FedBatcher.epoch(skip=k)`` and
  ``cursor``/``restore_cursor`` on CIFAR-10 with its augmentation, bitwise
  the reference's batcher (rounds and cursors);
* files across packages: a JAX ``save_checkpoint`` file loads into the
  port (every state tensor bitwise the file's arrays, the sink row zero)
  and a port file into the JAX learner through the reference's own
  ``load_checkpoint``; one round after each load agrees at the round
  parity's tolerance;
* finetune: ``head_only_mask`` and ``load_pretrained_for_finetune``
  (same-width and head-swap) against the reference's on one file.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu import data as jax_data
from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.data import transforms as JT
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models.toy import TinyMLP as JaxTinyMLP
from commefficient_tpu.utils import checkpoint as jax_ckpt
from commefficient_tpu.utils import finetune as jax_finetune
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.data import FedBatcher, fed_datasets
from commefficient_tpu_torch.data import transforms as T
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.toy import TinyMLP
from commefficient_tpu_torch.utils.checkpoint import (CheckpointError,
                                                      find_latest_checkpoint,
                                                      load_checkpoint,
                                                      save_checkpoint,
                                                      state_leaves,
                                                      verify_checkpoint)
from commefficient_tpu_torch.utils.finetune import (
    head_only_mask, load_pretrained_for_finetune)
from commefficient_tpu_torch.utils.params import params_from_jax

N, W, B = 6, 2, 4
MLP = dict(num_classes=2, hidden=4)
BASE = dict(weight_decay=1e-3, num_workers=W, num_clients=N, lr_scale=0.05)
CONFIGS = {
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=3),
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, k=5, num_rows=3, num_cols=64),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(JaxTinyMLP(**MLP).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8)), train=False)["params"])


def port(params, cfg="local_topk", mlp=MLP):
    model = TinyMLP(**mlp, in_channels=8, image_size=1)
    model.load_state_dict(params_from_jax(params))
    return FedLearner(model, FedConfig(**BASE, **CONFIGS[cfg]),
                      make_cv_loss(model), device="cpu")


def ref(params, cfg="local_topk"):
    model = JaxTinyMLP(**MLP)
    return JaxLearner(model, JaxConfig(**BASE, **CONFIGS[cfg]),
                      jax_cv_loss(model), None, jax.random.PRNGKey(1),
                      np.zeros((1, 8), np.float32), init_params=params)


def rounds(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.choice(N, W, replace=False).astype(np.int32),
             (rng.randn(W, B, 8).astype(np.float32),
              rng.randint(0, 2, (W, B)).astype(np.int32)),
             np.ones((W, B), np.float32)) for _ in range(n)]


# --------------------------------------------------------------------------
# the format
# --------------------------------------------------------------------------

def test_digest_rejects_bit_flip(tmp_path, params):
    ln = port(params)
    ln.train_round(*rounds(1)[0])
    fn = save_checkpoint(str(tmp_path), ln, "toy", step=5)
    verify_checkpoint(fn)
    with np.load(fn) as z:
        data = {k: z[k] for k in z.files}
    w = data["arr_0"].copy()
    w.view(np.int32).flat[0] ^= 1
    data["arr_0"] = w
    np.savez(fn, **data)
    with pytest.raises(CheckpointError, match="digest"):
        verify_checkpoint(fn)


def test_find_latest_falls_back_past_corrupt(tmp_path, params):
    ln = port(params)
    r = rounds(2)
    ln.train_round(*r[0])
    save_checkpoint(str(tmp_path), ln, "toy", step=10)
    ln.train_round(*r[1])
    newest = save_checkpoint(str(tmp_path), ln, "toy", step=20)
    assert find_latest_checkpoint(str(tmp_path), "toy") == newest
    raw = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(CheckpointError):
        verify_checkpoint(newest)
    fallback = find_latest_checkpoint(str(tmp_path), "toy")
    assert fallback.endswith("toy_r00000010.npz")
    fresh = port(params)
    assert load_checkpoint(fallback, fresh)["rounds_done"] == 1
    assert fresh.rounds_done == 1


def test_retention_keeps_newest_three_and_export(tmp_path, params):
    ln = port(params)
    ln.train_round(*rounds(1)[0])
    save_checkpoint(str(tmp_path), ln, "toy")
    for step in (10, 20, 30, 40):
        save_checkpoint(str(tmp_path), ln, "toy", step=step)
    files = sorted(os.listdir(str(tmp_path)))
    assert "toy.npz" in files
    assert [f for f in files if "_r" in f] == [
        "toy_r00000020.npz", "toy_r00000030.npz", "toy_r00000040.npz"]
    assert (tmp_path / "toy.latest").read_text().strip() == \
        "toy_r00000040.npz"


def test_fingerprint_mismatch_raises_and_leaves_learner(tmp_path, params):
    ln = port(params)
    ln.train_round(*rounds(1)[0])
    fn = save_checkpoint(str(tmp_path), ln, "toy", step=1,
                         fingerprint={"lr_scale": 0.02, "seed": 3})
    fresh = port(params)
    before = [t.clone() for _, t, _ in state_leaves(fresh.state)]
    gen = fresh.generator.get_state()
    with pytest.raises(ValueError, match="different config"):
        load_checkpoint(fn, fresh,
                        expect_fingerprint={"lr_scale": 0.4, "seed": 3})
    for a, (_, b, _) in zip(before, state_leaves(fresh.state)):
        assert torch.equal(a, b)
    assert fresh.rounds_done == 0 and fresh.total_upload_bytes == 0
    assert torch.equal(fresh.generator.get_state(), gen)
    info = load_checkpoint(fn, fresh,
                           expect_fingerprint={"lr_scale": 0.02, "seed": 3})
    assert info["fingerprint"]["seed"] == 3
    assert torch.equal(fresh.generator.get_state(),
                       ln.generator.get_state())


# --------------------------------------------------------------------------
# the batcher's resume cursor against the reference's
# --------------------------------------------------------------------------

def _write_cifar(root, per_batch=24, seed=0):
    rng = np.random.RandomState(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for name, n in [(f"data_batch_{i}", per_batch) for i in range(1, 6)] + [
            ("test_batch", 10)]:
        labels = np.arange(n) % 10
        rng.shuffle(labels)
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         "labels": labels.tolist()}, f)


@pytest.fixture(scope="module")
def cifar_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")

    def make():
        _write_cifar(str(root / "port"))
        _write_cifar(str(root / "ref"))
        kw = dict(num_clients=20, train=True, seed=4)
        return (fed_datasets["CIFAR10"](
                    dataset_dir=str(root / "port"),
                    transform=T.get_transforms("CIFAR10", True), **kw),
                jax_data.fed_datasets["CIFAR10"](
                    dataset_dir=str(root / "ref"),
                    transform=JT.get_transforms("CIFAR10", True), **kw))
    return make


def _epoch(batcher, skip=0):
    return [(i.copy(), tuple(np.asarray(c).copy() for c in cols), m.copy())
            for i, cols, m in batcher.epoch(skip=skip)]


def _same_rounds(a, b):
    assert len(a) == len(b)
    for (ia, ca, ma), (ib, cb, mb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ma, mb)
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(x, y)


def test_batcher_skip_replay_and_cursor_match_reference(cifar_pair):
    k = 3
    ds, jds = cifar_pair()
    full = FedBatcher(ds, 3, 4, seed=7)
    jfull = jax_data.FedBatcher(jds, 3, 4, seed=7)
    e0, e1 = _epoch(full), _epoch(full)
    _same_rounds(e0, _epoch(jfull))
    _same_rounds(e1, _epoch(jfull))
    # skip k: the epoch's tail, then the next epoch bitwise (the sampler
    # and the augmentation drew as if the k rounds had run)
    ds, jds = cifar_pair()
    skipped = FedBatcher(ds, 3, 4, seed=7)
    jskipped = jax_data.FedBatcher(jds, 3, 4, seed=7)
    tail = _epoch(skipped, skip=k)
    _same_rounds(tail, e0[k:])
    _same_rounds(tail, _epoch(jskipped, skip=k))
    _same_rounds(_epoch(skipped), e1)
    # the cursor mid-epoch and at a boundary: the reference's JSON, and a
    # restored batcher (wrong seed) replays from round k bitwise
    ds, jds = cifar_pair()
    a, ja = FedBatcher(ds, 3, 4, seed=7), jax_data.FedBatcher(jds, 3, 4,
                                                              seed=7)
    it, jit = a.epoch(), ja.epoch()
    for _ in range(k):
        next(it), next(jit)
    cur = a.cursor(in_epoch=True)
    assert json.dumps(cur) == json.dumps(ja.cursor(in_epoch=True))
    expect = next(it)
    ds2, _ = cifar_pair()
    b = FedBatcher(ds2, 3, 4, seed=999)
    b.restore_cursor(json.loads(json.dumps(cur)), in_epoch=True)
    _same_rounds([next(iter(b.epoch(skip=k)))], [expect])
    list(it), list(jit)
    assert json.dumps(a.cursor(in_epoch=False)) == json.dumps(
        ja.cursor(in_epoch=False))


# --------------------------------------------------------------------------
# files across packages
# --------------------------------------------------------------------------

def _one_round_agrees(a_out, b_out, a_w, b_w):
    np.testing.assert_allclose(a_out["loss"], b_out["loss"], rtol=1e-5)
    assert a_out["upload_bytes"] == b_out["upload_bytes"]
    assert a_out["download_bytes"] == b_out["download_bytes"]
    np.testing.assert_allclose(a_w, b_w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_jax_file_loads_into_port(tmp_path, params, cfg):
    r = rounds(3)
    jl = ref(params, cfg)
    jl.train_round(*r[0])
    jl.train_round(*r[1])
    fn = jax_ckpt.save_checkpoint(str(tmp_path), jl, "toy", step=2,
                                  cursor={"entry": "cv"})
    ln = port(params, cfg)
    info = load_checkpoint(fn, ln)
    assert info["rounds_done"] == ln.rounds_done == 2
    assert info["cursor"] == {"entry": "cv"}
    with np.load(fn) as z:
        paths = json.loads(str(z["leaf_paths"]))
        leaves = state_leaves(ln.state)
        assert [p for p, _, _ in leaves] == paths
        for i, (p, t, rows) in enumerate(leaves):
            got = (t[:-1] if rows else t).numpy()
            assert got.dtype == z[f"arr_{i}"].dtype, p
            np.testing.assert_array_equal(got, z[f"arr_{i}"], err_msg=p)
            if rows:
                assert not t[-1].any(), p
        assert ln.total_upload_bytes == float(z["total_upload_bytes"])
    _one_round_agrees(ln.train_round(*r[2]), jl.train_round(*r[2]),
                      ln.state.weights.numpy(), np.asarray(jl.state.weights))


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_port_file_loads_into_jax(tmp_path, params, cfg):
    r = rounds(3)
    ln = port(params, cfg)
    ln.train_round(*r[0])
    ln.train_round(*r[1])
    fn = save_checkpoint(str(tmp_path), ln, "toy", step=2,
                         meta={"model": "TinyMLP", "num_classes": 2})
    jax_ckpt.verify_checkpoint(fn)
    jl = ref(params, cfg)
    info = jax_ckpt.load_checkpoint(fn, jl)
    assert info["rounds_done"] == jl.rounds_done == 2
    for (p, t, rows), (_, x) in zip(
            state_leaves(ln.state),
            jax.tree_util.tree_flatten_with_path(jl.state)[0]):
        np.testing.assert_array_equal((t[:-1] if rows else t).numpy(),
                                      np.asarray(x), err_msg=p)
    _one_round_agrees(ln.train_round(*r[2]), jl.train_round(*r[2]),
                      ln.state.weights.numpy(), np.asarray(jl.state.weights))


# --------------------------------------------------------------------------
# finetune
# --------------------------------------------------------------------------

def test_finetune_matches_reference(tmp_path):
    # the registry's TinyMLP (hidden 32): the head swap rebuilds it by name
    jmodel = JaxTinyMLP(num_classes=2)
    jl = JaxLearner(jmodel, JaxConfig(**BASE, **CONFIGS["local_topk"]),
                    jax_cv_loss(jmodel), None, jax.random.PRNGKey(1),
                    np.zeros((1, 8), np.float32))
    jl.train_round(*rounds(1)[0])
    fn = jax_ckpt.save_checkpoint(str(tmp_path), jl, "TinyMLP",
                                  meta={"model": "TinyMLP",
                                        "num_classes": 2})
    sample = np.zeros((1, 8), np.float32)

    def tiny(num_classes):
        model = TinyMLP(num_classes=num_classes, in_channels=8,
                        image_size=1)
        return model.reset_parameters(torch.Generator().manual_seed(5))

    def flat(model):
        return FedLearner(model, FedConfig(**BASE, **CONFIGS["local_topk"]),
                          make_cv_loss(model), device="cpu").state.weights
    # same width (the directory's one export), then a 3-class head swap
    for classes, where in ((2, str(tmp_path)), (3, fn)):
        jparams, jmask = jax_finetune.load_pretrained_for_finetune(
            JaxTinyMLP(num_classes=classes), jax.random.PRNGKey(5), sample,
            where)
        model, mask = load_pretrained_for_finetune(
            tiny(classes), where,
            make_model=lambda meta: tiny(meta["num_classes"]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(
            head_only_mask(model).numpy(),
            np.asarray(jax_finetune.head_only_mask(jparams)))
        body = np.asarray(jmask) == 0
        assert body.any() and (~body).any()
        np.testing.assert_array_equal(
            flat(model).numpy()[body],
            np.asarray(ravel_pytree(jparams)[0])[body])
