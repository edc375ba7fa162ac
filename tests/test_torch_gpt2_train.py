"""GPT2 federated training in the port against the JAX reference on the
CPU, and the GPT2 entry point.

* three ``FedLearner`` rounds of a narrow GPT2 (2 layers, n_embd 32, 4
  heads, vocab 300, T 32, dropout 0) from the same bridged weights and
  batches, in sketch mode (the fused path) and in local_topk (the
  per-worker path): loss rtol 1e-5, bytes exact, weights atol 1e-6;
* the CLI runs one round on the CPU when asked, refuses CUDA without a
  card, and keeps the reference's ValueErrors of the inner mesh axes
  (MoE, the expert, seq and stage axes and ring attention run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_train_loss
from commefficient_tpu.federated.losses import \
    make_gpt2_val_loss as jax_val_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import (make_gpt2_train_loss,
                                                      make_gpt2_val_loss)
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.training.args import parse_mesh
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser, train
from commefficient_tpu_torch.utils.params import params_from_jax

NARROW = dict(vocab_size=300, n_positions=32, n_embd=32, n_layer=2,
              n_head=4, dropout=0.0)
MODES = {
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, k=500, num_cols=4_000,
                   num_rows=3),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=500),
}
W, B, C, T = 3, 2, 2, 32


def _round_batch(rng):
    ids = rng.randint(0, 300, (W, B, C, T)).astype(np.int32)
    types = rng.randint(256, 261, (W, B, C, T)).astype(np.int32)
    mc = rng.randint(T // 2, T, (W, B, C)).astype(np.int32)
    labels = np.where(rng.rand(W, B, C, T) < 0.3, ids, -1).astype(np.int32)
    mc_labels = np.full((W, B), C - 1, np.int32)
    return ids, mc, labels, mc_labels, types


def _learners(mode):
    kw = dict(MODES[mode], num_clients=6, num_workers=W, weight_decay=0.0,
              lr_scale=0.04)
    jmodel = JaxGPT2(JaxGPT2Config(**NARROW, attn_impl="blockwise"))
    z = jnp.zeros((1, C, T), jnp.int32)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, C), jnp.int32),
        train=False)["params"])
    jl = JaxLearner(None, JaxConfig(**kw), jax_train_loss(jmodel),
                    jax_val_loss(jmodel), jax.random.PRNGKey(0), None,
                    init_params=params)
    model = GPT2DoubleHeads(GPT2Config(**NARROW, attn_impl="blockwise"))
    model.load_state_dict(params_from_jax(params))
    tl = FedLearner(model, FedConfig(**kw), make_gpt2_train_loss(model),
                    make_gpt2_val_loss(model), device="cpu", seed=0)
    return jl, tl


@pytest.mark.parametrize("mode", sorted(MODES))
def test_three_rounds_match_jax(mode):
    jl, tl = _learners(mode)
    rng = np.random.RandomState(7)
    for rnd in range(3):
        ids = rng.choice(6, W, replace=False).astype(np.int32)
        batch = _round_batch(rng)
        mask = np.ones((W, B), np.float32)
        if rnd == 2:
            mask[2, 1] = 0          # a ragged client
        ref = jl.train_round(ids, batch, mask, epoch_frac=rnd)
        got = tl.train_round(ids, batch, mask, epoch_frac=rnd)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints",
                    "aborted"):
            assert got[key] == ref[key], key
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=1e-6)
    val = [(_round_batch(rng)[:5], np.ones(W * B, np.float32))]
    val = [(tuple(c.reshape((W * B,) + c.shape[2:]) for c in b), m)
           for b, m in val]
    got, ref = tl.evaluate(val), jl.evaluate(val)
    np.testing.assert_allclose(got["metrics"], np.asarray(ref["metrics"]),
                               rtol=1e-5)


def _args(tmp_path, *extra):
    return build_gpt2_parser().parse_args([
        "--model", "gpt2-tiny", "--max_seq_len", "32", "--mode", "sketch",
        "--error_type", "virtual", "--virtual_momentum", "0.9",
        "--k", "1000", "--num_cols", "5000", "--num_rows", "3",
        "--num_epochs", "1", "--dataset_dir", str(tmp_path),
        "--synthetic_personas", "4", "--synthetic_dialogs", "2", *extra])


def test_cli_one_round_on_cpu(tmp_path):
    args = _args(tmp_path, "--device", "cpu", "--attn_impl", "blockwise")
    learner, row = train(args, max_rounds=1, log=False)
    assert len(row["rounds"]) == 1
    r = row["rounds"][0]
    assert np.isfinite(r["loss"]) and r["upload_bytes"] == 2 * 4 * 3 * 5_120
    assert np.isfinite(row["nll"]) and 0 <= row["mc_acc"] <= 1
    assert learner.cfg.grad_size == sum(
        p.numel() for p in learner.model.parameters())


def test_cli_refuses_cuda_without_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train(_args(tmp_path), max_rounds=1, log=False)


@pytest.mark.parametrize("extra,item", [
    pytest.param(["--moe_experts", "4", "--mesh", "clients=2,expert=2",
                  "--max_grad_norm", "1.0"], "expert=2 requires the fused",
                 id="extra0-A12"),
    pytest.param(["--mesh", "clients=2,seq=2", "--attn_impl", "blockwise"],
                 "cannot shard the sequence", id="extra1-A12"),
    pytest.param(["--mesh", "clients=1,stage=2"], "mc_coef 0",
                 id="extra2-A12"),
    pytest.param(["--attn_impl", "ring"], "requires --mesh",
                 id="extra3-A12")])
def test_cli_refuses_unported_flags(tmp_path, extra, item):
    """The expert, seq and stage axes and ring attention run since A12's
    slices, and keep the reference's ValueErrors (an expert axis off the
    fused round, blockwise on a seq axis, ring without one, a stage axis
    without ``--mc_coef 0``)."""
    args = _args(tmp_path, "--device", "cpu", *extra)
    with pytest.raises(ValueError, match=item):
        train(args, mesh=parse_mesh(args.mesh), max_rounds=1, log=False)
