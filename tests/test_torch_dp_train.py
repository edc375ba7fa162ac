"""Whole rounds with per-client clipping and differential privacy in the
port against the JAX reference on the CPU, and the two entry points.

* 3 ``FedLearner`` rounds of a narrow ResNet9 from the same bridged
  weights and batches (round 3 an epoch tail: one padded slot, one ragged
  client) in sketch + ``max_grad_norm`` (each client's table clipped by
  its ``l2estimate``), sketch + DP worker, true_topk + ``max_grad_norm``,
  local_topk + DP worker and uncompressed + DP server, the noise at 0
  (the two packages draw different normals): loss rtol 1e-5, byte
  metrics and ``last_changed`` exact, weights and server state atol 1e-6;
* 2 rounds of GPT2 at ``gpt2-tiny``'s width with ``max_grad_norm`` (the
  per-worker sketch path, dropout 0), at the same tolerances;
* the CV entry point on the CPU, one round each, in sketch +
  ``--max_grad_norm`` and in uncompressed + ``--dp --dp_mode server``
  with noise, and the GPT2 entry point with ``--dp``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_gpt2_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import (make_cv_loss,
                                                      make_gpt2_train_loss)
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
from commefficient_tpu_torch.training.gpt2 import train as gpt2_train
from commefficient_tpu_torch.utils.params import params_from_jax

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
W, B, CLIENTS = 4, 8, 10
COMMON = dict(k=200, num_clients=CLIENTS, num_workers=W)
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              num_cols=2_000, num_rows=5)
DP = dict(do_dp=True, l2_norm_clip=0.5, noise_multiplier=0.0)
CASES = {
    "sketch_max_grad_norm": dict(SKETCH, max_grad_norm=0.5),
    "sketch_dp_worker": dict(SKETCH, dp_mode="worker", **DP),
    "true_topk_max_grad_norm": dict(mode="true_topk", error_type="virtual",
                                    virtual_momentum=0.9,
                                    max_grad_norm=0.5),
    "local_topk_dp_worker": dict(mode="local_topk", error_type="local",
                                 local_momentum=0.9, dp_mode="worker", **DP),
    "uncompressed_dp_server": dict(mode="uncompressed",
                                   virtual_momentum=0.9, dp_mode="server",
                                   **DP),
}


def _learners(kw, seed=0):
    jmodel = JaxResNet9(channels=NARROW)
    sample = jnp.zeros((1, 32, 32, 3))
    params = jmodel.init(jax.random.PRNGKey(seed), sample,
                         train=False)["params"]
    jl = JaxLearner(jmodel, JaxConfig(**kw), jax_cv_loss(jmodel),
                    jax_cv_loss(jmodel), jax.random.PRNGKey(seed), sample,
                    init_params=params)
    model = ResNet9(channels=NARROW)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tl = FedLearner(model, FedConfig(**kw), make_cv_loss(model),
                    make_cv_loss(model), device="cpu")
    return jl, tl


def _batches(rounds, seed):
    rng = np.random.RandomState(seed)
    out = []
    for rnd in range(rounds):
        ids = rng.choice(CLIENTS, W, replace=False).astype(np.int32)
        batch = (rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (W, B)).astype(np.int32))
        mask = np.ones((W, B), np.float32)
        if rnd == 2:   # an epoch-tail round: one empty slot, one ragged
            mask[3] = 0
            mask[1, 4:] = 0
        out.append((ids, batch, mask))
    return out


def _check_round(got, ref):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for key in ("download_bytes", "upload_bytes", "num_datapoints",
                "aborted"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("name", list(CASES))
def test_three_rounds_match_jax(name):
    kw = dict(COMMON, **CASES[name])
    jl, tl = _learners(kw)
    for rnd, (ids, batch, mask) in enumerate(_batches(3, seed=len(name))):
        _check_round(tl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd),
                     jl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd))
    np.testing.assert_array_equal(tl.state.last_changed.numpy(),
                                  np.asarray(jl.state.last_changed))
    np.testing.assert_array_equal(tl.state.client_last_round.numpy(),
                                  np.asarray(jl.state.client_last_round))
    close = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), **close)
    for field in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(getattr(tl.state.opt, field).numpy(),
                                   np.asarray(getattr(jl.state.opt, field)),
                                   **close)
    if tl.cfg.needs_error_state:
        # rows hold sums over a client's datapoints
        np.testing.assert_allclose(
            tl.state.clients.errors[:CLIENTS].numpy(),
            np.asarray(jl.state.clients.errors), rtol=1e-5, atol=1e-6)


GPT2_TINY = dict(vocab_size=300, n_positions=256, n_embd=128, n_layer=2,
                 n_head=4, dropout=0.0)
GW, GB, GC, GT = 3, 2, 2, 32


def _gpt2_batch(rng):
    ids = rng.randint(0, 300, (GW, GB, GC, GT)).astype(np.int32)
    types = rng.randint(256, 261, (GW, GB, GC, GT)).astype(np.int32)
    mc = rng.randint(GT // 2, GT, (GW, GB, GC)).astype(np.int32)
    labels = np.where(rng.rand(GW, GB, GC, GT) < 0.3, ids, -1).astype(
        np.int32)
    return ids, mc, labels, np.full((GW, GB), GC - 1, np.int32), types


def test_gpt2_tiny_max_grad_norm_two_rounds_match_jax():
    kw = dict(SKETCH, k=500, num_cols=4_000, num_rows=3, max_grad_norm=1.0,
              num_clients=6, num_workers=GW, weight_decay=0.0,
              lr_scale=0.04)
    jmodel = JaxGPT2(JaxGPT2Config(**GPT2_TINY, attn_impl="blockwise"))
    z = jnp.zeros((1, GC, GT), jnp.int32)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, GC), jnp.int32),
        train=False)["params"])
    jl = JaxLearner(None, JaxConfig(**kw), jax_gpt2_loss(jmodel), None,
                    jax.random.PRNGKey(0), None, init_params=params)
    model = GPT2DoubleHeads(GPT2Config(**GPT2_TINY, attn_impl="blockwise"))
    model.load_state_dict(params_from_jax(params))
    tl = FedLearner(model, FedConfig(**kw), make_gpt2_train_loss(model),
                    device="cpu", seed=0)
    rng = np.random.RandomState(7)
    for rnd in range(2):
        ids = rng.choice(6, GW, replace=False).astype(np.int32)
        batch, mask = _gpt2_batch(rng), np.ones((GW, GB), np.float32)
        _check_round(tl.train_round(ids, batch, mask, epoch_frac=rnd),
                     jl.train_round(ids, batch, mask, epoch_frac=rnd))
    assert tl.cfg.grad_size > 400_000
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=1e-6)


def _cli_args(tmp_path, *extra):
    (tmp_path / "stats.json").write_text(json.dumps(
        {"images_per_client": [32] * 10, "num_val_images": 256}))
    return build_parser().parse_args([
        "--num_workers", "2", "--k", "100", "--num_rows", "3",
        "--num_cols", "5000", "--valid_batch_size", "256",
        "--local_batch_size", "4", "--dataset_dir", str(tmp_path),
        "--device", "cpu", "--num_epochs", "1", *extra])


@pytest.mark.parametrize("extra,per_client", [
    (["--mode", "sketch", "--error_type", "virtual", "--max_grad_norm",
      "1.0"], 4 * 3 * 5_120),
    (["--mode", "uncompressed", "--virtual_momentum", "0.9", "--dp",
      "--dp_mode", "server", "--l2_norm_clip", "1.0",
      "--noise_multiplier", "1e-3"], None)],
    ids=["sketch_max_grad_norm", "uncompressed_dp_server"])
def test_cv_cli_runs_on_cpu(tmp_path, monkeypatch, extra, per_client):
    monkeypatch.setattr(cv, "get_model",
                        lambda *a, **kw: ResNet9(channels=NARROW))
    learner, row = cv.train(_cli_args(tmp_path, *extra), max_rounds=1,
                            log=False)
    cfg = learner.cfg
    assert cfg.do_dp == ("--dp" in extra)
    assert cfg.max_grad_norm == (1.0 if "--max_grad_norm" in extra
                                 else None)
    r, = row["rounds"]
    assert np.isfinite(r["loss"]) and np.isfinite(row["test_loss"])
    assert r["upload_bytes"] == 2 * (per_client or 4 * cfg.grad_size)
    if cfg.do_dp:
        assert (cfg.dp_mode, cfg.l2_norm_clip, cfg.noise_multiplier) == (
            "server", 1.0, 1e-3)
    assert np.isfinite(learner.state.weights.numpy()).all()


def test_gpt2_cli_runs_dp_on_cpu(tmp_path):
    args = build_gpt2_parser().parse_args([
        "--model", "gpt2-tiny", "--max_seq_len", "32", "--mode", "sketch",
        "--error_type", "virtual", "--k", "1000", "--num_cols", "5000",
        "--num_rows", "3", "--num_epochs", "1", "--dataset_dir",
        str(tmp_path), "--synthetic_personas", "4", "--synthetic_dialogs",
        "2", "--device", "cpu", "--dp", "--l2_norm_clip", "0.5",
        "--noise_multiplier", "1e-3"])
    learner, row = gpt2_train(args, max_rounds=1, log=False)
    assert learner.cfg.do_dp and learner.cfg.dp_mode == "worker"
    r, = row["rounds"]
    assert np.isfinite(r["loss"]) and r["upload_bytes"] == 2 * 4 * 3 * 5_120
