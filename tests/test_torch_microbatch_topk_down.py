"""``--microbatch_size``, ``--topk_down`` and ``download_counts`` in the
port against the JAX reference on the CPU.

* ``_masked_loss_and_grad`` at microbatch -1, 4 and 3 (a ragged last
  chunk) on a batch with a masked tail: gradient, loss and metric sums
  against the reference's at rtol 1e-6 / atol 1e-7; the chunked sums
  equal the one-shot ones at the reference's own tolerance (atol 1e-5,
  ``tests/test_round.py``); chunk i draws its dropout from
  ``fold_in(fold_in(seed, 0x4d42), i)``;
* 3 rounds at microbatch -1, 4 and 3 against the reference's rounds:
  losses rtol 1e-5, bytes exact, weights atol 1e-6;
* a 3-round local_topk ``--topk_down`` trajectory of a narrow ResNet9
  against the reference's: losses rtol 1e-5, bytes exact, weights,
  errors and the stale weight rows atol 1e-6;
* the reference's k == d exactness: with a one-weight model ``--topk_down``
  reconstructs the server's weights exactly, so the trajectory equals the
  one without it bitwise, and the stale rows hold the last forward
  weights (and the initial weights for a client never sampled);
* ``download_counts`` bitwise the reference's on random inputs with the
  -2 and -1 sentinels and tied stale rounds;
* the CV entry point with ``--microbatch_size`` and ``--topk_down`` on
  the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import client as jax_client
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.federated.losses import \
    make_regression_loss as jax_regression_loss
from commefficient_tpu.federated.round import \
    download_counts as jax_download_counts
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.models.toy import TinyMLP as JaxTinyMLP
from commefficient_tpu.models.toy import ToyLinear as JaxToyLinear
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client as client_lib
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.federated.round import download_counts
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.models.toy import TinyMLP, ToyLinear
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.utils.params import (flatten_params,
                                                  params_from_jax)

MLP = dict(num_classes=2, hidden=16)


def _mlp_data(seed=3):
    rng = np.random.RandomState(seed)
    xs = rng.randn(16, 8).astype(np.float32)
    ys = (xs[:, 0] > 0).astype(np.int32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 6:] = 0.0          # a masked tail meets the chunks' padding
    return (xs.reshape(2, 8, 8), ys.reshape(2, 8)), mask


def _mlp_pair(seed=1):
    jmodel = JaxTinyMLP(**MLP)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8)), train=False)["params"])
    model = TinyMLP(**MLP, in_channels=8, image_size=1)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model


@pytest.mark.parametrize("mb", [-1, 4, 3])
def test_masked_loss_and_grad_matches_jax(mb):
    jmodel, params, model = _mlp_pair()
    (xs, ys), mask = _mlp_data()
    batch, m = (xs[1], ys[1]), mask[1]
    flat, unravel = ravel_pytree(params)
    ref = jax.jit(lambda f, b, mm: jax_client._masked_loss_and_grad(
        jax_cv_loss(jmodel), unravel, f, b, mm, jax.random.PRNGKey(0),
        microbatch_size=mb))(flat, tuple(jnp.asarray(c) for c in batch),
                             jnp.asarray(m))
    tflat, unflatten = flatten_params(model)
    got = client_lib._masked_loss_and_grad(
        make_cv_loss(model), unflatten, tflat,
        tuple(torch.from_numpy(c) for c in batch), torch.from_numpy(m),
        seed=0, microbatch_size=mb)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    one_shot = client_lib._masked_loss_and_grad(
        make_cv_loss(model), unflatten, tflat,
        tuple(torch.from_numpy(c) for c in batch), torch.from_numpy(m))
    for a, b in zip(got, one_shot):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_microbatch_chunk_seeds():
    """Chunk i of a client seeded s draws from fold_in(fold_in(s, 0x4d42),
    i): a domain apart from the DP noise's fold_in(s, NOISE_FOLD)."""
    seen = []

    def apply_loss(params, batch, seed, train):
        seen.append((seed, batch[0].shape[0]))
        loss = torch.sum(params["w"] * batch[0], dim=-1)
        return loss, loss.detach()[None]

    w = torch.ones(3)
    x = torch.arange(21.0).reshape(7, 3)
    grad, loss, _ = client_lib._masked_loss_and_grad(
        apply_loss, lambda f: {"w": f}, w, (x,), torch.ones(7), seed=11,
        microbatch_size=3)
    base = fold_in(11, client_lib.MICROBATCH_FOLD)
    assert seen == [(fold_in(base, i), 3) for i in range(3)]
    assert client_lib.MICROBATCH_FOLD == 0x4D42
    torch.testing.assert_close(grad, x.sum(0), rtol=0, atol=0)
    assert float(loss) == float(x.sum())


def test_microbatch_rounds_match_jax():
    (xs, ys), mask = _mlp_data()
    ids = np.arange(2)
    got_by_mb = {}
    for mb in (-1, 4, 3):
        kw = dict(mode="uncompressed", virtual_momentum=0.9,
                  weight_decay=1e-3, num_workers=2, num_clients=2,
                  lr_scale=0.1, microbatch_size=mb)
        jmodel, params, model = _mlp_pair()
        jl = JaxLearner(jmodel, JaxConfig(**kw), jax_cv_loss(jmodel), None,
                        jax.random.PRNGKey(1), xs[0, :1],
                        init_params=params)
        tl = FedLearner(model, FedConfig(**kw), make_cv_loss(model),
                        device="cpu")
        for _ in range(3):
            ref = jl.train_round(ids, (xs, ys), mask)
            got = tl.train_round(ids, (xs, ys), mask)
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
            for key in ("download_bytes", "upload_bytes", "num_datapoints"):
                assert got[key] == ref[key], key
        np.testing.assert_allclose(tl.state.weights.numpy(),
                                   np.asarray(jl.state.weights), rtol=0,
                                   atol=1e-6)
        got_by_mb[mb] = tl.state.weights.numpy()
    for mb in (4, 3):
        np.testing.assert_allclose(got_by_mb[mb], got_by_mb[-1], rtol=0,
                                   atol=1e-5)


NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
TOPK_DOWN = dict(mode="local_topk", error_type="local", k=200,
                 virtual_momentum=0.5, do_topk_down=True, num_clients=10,
                 num_workers=4)


def test_topk_down_trajectory_matches_jax():
    jmodel = JaxResNet9(channels=NARROW)
    sample = jnp.zeros((1, 32, 32, 3))
    params = jmodel.init(jax.random.PRNGKey(0), sample,
                         train=False)["params"]
    jl = JaxLearner(jmodel, JaxConfig(**TOPK_DOWN), jax_cv_loss(jmodel),
                    jax_cv_loss(jmodel), jax.random.PRNGKey(0), sample,
                    init_params=params)
    model = ResNet9(channels=NARROW)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tl = FedLearner(model, FedConfig(**TOPK_DOWN), make_cv_loss(model),
                    device="cpu")
    assert tl.cfg.has_client_state and tl.state.clients.weights.shape == (
        11, tl.cfg.grad_size)
    rng = np.random.RandomState(5)
    for rnd in range(3):
        ids = rng.choice(10, 4, replace=False).astype(np.int32)
        batch = (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (4, 8)).astype(np.int32))
        mask = np.ones((4, 8), np.float32)
        if rnd == 2:
            mask[3] = 0            # an empty slot writes no stale row
        ref = jl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        got = tl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints"):
            assert got[key] == ref[key], key
    close = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), **close)
    for field in ("weights", "errors"):
        mine = getattr(tl.state.clients, field)[:10].numpy()
        ref = np.asarray(getattr(jl.state.clients, field))
        np.testing.assert_allclose(mine, ref, **close)
    np.testing.assert_array_equal(tl.state.client_last_round.numpy(),
                                  np.asarray(jl.state.client_last_round))


def _toy_loss(model):
    def apply_loss(params, batch, seed, train):
        x, y = batch
        pred = functional_call(model, params, (x,))
        loss = torch.sum((pred - y) ** 2, dim=-1)
        return loss, torch.zeros((1, loss.shape[0]))
    return apply_loss


def test_topk_down_at_k_equal_d_reconstructs_stale_weights():
    """The reference's ``test_topk_down_reconstructs_stale_weights`` on
    both packages: y = w x, d = 1, k = 1."""
    x = np.asarray([[0.0], [1.0], [2.0], [3.0]], np.float32)
    ids, batch, mask = (np.array([0]), (x[None], x[None]),
                        np.ones((1, 4), np.float32))
    learners = {}
    for down in (False, True):
        kw = dict(mode="true_topk", error_type="virtual", k=1,
                  virtual_momentum=0.0, weight_decay=0, num_workers=1,
                  num_clients=3, lr_scale=0.02, do_topk_down=down)
        jmodel = JaxToyLinear()
        jl = JaxLearner(jmodel, JaxConfig(**kw), jax_regression_loss(jmodel),
                        None, jax.random.PRNGKey(0), x[:1])
        model = ToyLinear().reset_parameters()
        tl = FedLearner(model, FedConfig(**kw), _toy_loss(model),
                        device="cpu")
        learners[down] = (jl, tl)
    assert learners[True][1].state.clients.weights is not None
    assert learners[False][1].state.clients.weights is None
    for _ in range(3):
        w_before = learners[True][1].state.weights.clone()
        outs = [(jl.train_round(ids, batch, mask),
                 tl.train_round(ids, batch, mask))
                for jl, tl in learners.values()]
        (ja, ta), (jb, tb) = outs
        assert ta["loss"] == tb["loss"] == pytest.approx(ja["loss"],
                                                         rel=1e-6)
        assert jb["loss"] == ja["loss"]
    (jl0, tl0), (jl1, tl1) = learners.values()
    np.testing.assert_array_equal(tl0.state.weights.numpy(),
                                  tl1.state.weights.numpy())
    np.testing.assert_allclose(tl1.state.weights.numpy(),
                               np.asarray(jl1.state.weights), rtol=1e-6)
    stale = tl1.state.clients.weights
    np.testing.assert_array_equal(stale[0].numpy(), w_before.numpy())
    assert not torch.allclose(stale[2], w_before)   # never sampled: init
    assert float(stale[2]) == 0.0


@pytest.mark.parametrize("W,d", [(1, 50), (4, 1_000), (8, 5_000),
                                 (4, 1)])
def test_download_counts_bitwise_with_sentinels_and_ties(W, d):
    rng = np.random.RandomState(W * 131 + d)
    last_changed = rng.randint(-2, 6, d).astype(np.int32)
    stale = rng.randint(-1, 6, W).astype(np.int32)
    stale[0] = -1                              # never pulled
    stale[W // 2:] = stale[W // 2]             # tied stale rounds
    ref = jax_download_counts(jnp.asarray(last_changed), jnp.asarray(stale))
    got = download_counts(torch.from_numpy(last_changed),
                          torch.from_numpy(stale))
    assert got.dtype == torch.int32 and got.shape == (W,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), (last_changed[None, :] >= stale[:, None]).sum(1))


def _cli_args(tmp_path, *extra):
    (tmp_path / "stats.json").write_text(json.dumps(
        {"images_per_client": [32] * 10, "num_val_images": 256}))
    return build_parser().parse_args([
        "--num_workers", "2", "--k", "100", "--num_rows", "3",
        "--num_cols", "5000", "--valid_batch_size", "256",
        "--dataset_dir", str(tmp_path), "--device", "cpu",
        "--num_epochs", "1", *extra])


@pytest.mark.parametrize("extra,per_client", [
    (["--mode", "local_topk", "--error_type", "local", "--topk_down",
      "--num_clients", "20", "--local_batch_size", "4"], 4 * 100),
    (["--mode", "sketch", "--error_type", "virtual", "--microbatch_size",
      "3", "--local_batch_size", "8"], 4 * 3 * 5_120)],
    ids=["topk_down", "microbatch"])
def test_cli_runs_on_cpu(tmp_path, monkeypatch, extra, per_client):
    monkeypatch.setattr(cv, "get_model",
                        lambda *a, **kw: ResNet9(channels=NARROW))
    learner, row = cv.train(_cli_args(tmp_path, *extra), max_rounds=2,
                            log=False)
    rounds = row["rounds"]
    assert len(rounds) == 2 and all(np.isfinite(r["loss"]) for r in rounds)
    assert all(r["upload_bytes"] == 2 * per_client for r in rounds)
    assert bool(torch.isfinite(learner.state.weights).all())
