"""The port's five modes as whole rounds against the JAX reference on the
CPU, and the CV entry point in every mode.

* 3 ``FedLearner`` rounds per mode from the same bridged narrow-ResNet9
  weights and batches — uncompressed, true_topk, local_topk and fedavg,
  plus local_topk with local error and momentum (its client rows carried
  over from a nonzero start by the state bridge), true_topk with local
  momentum (the per-worker path, client velocities masked at the global
  support) and sketch with ``server_fused off``: loss rtol 1e-5, byte
  metrics and ``last_changed`` exact, weights and server state atol 1e-6,
  client rows (sums over a client's datapoints) rtol 1e-5 / atol 1e-6;
* ``training.cv.train`` runs each mode on the CPU with exact upload bytes;
* the CLI refuses every flag the port does not run, naming its ROADMAP
  item."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.federated.state import ClientState as JaxClients
from commefficient_tpu.federated.state import ServerOptState as JaxOpt
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.training import cv
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.utils.params import (client_state_from_arrays,
                                                  params_from_jax,
                                                  server_opt_from_arrays)

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
W, B, CLIENTS = 4, 8, 10
COMMON = dict(k=200, num_clients=CLIENTS, num_workers=W)
MODES = {
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9),
    "local_topk": dict(mode="local_topk"),
    "fedavg": dict(mode="fedavg", local_batch_size=-1, num_fedavg_epochs=2,
                   fedavg_batch_size=4, fedavg_lr_decay=0.9,
                   virtual_momentum=0.5, lr_scale=0.1),
    "local_topk_local_error": dict(mode="local_topk", error_type="local",
                                   local_momentum=0.9, virtual_momentum=0.5),
    "true_topk_local_momentum": dict(mode="true_topk", error_type="virtual",
                                     local_momentum=0.5,
                                     virtual_momentum=0.9),
    "sketch_server_fused_off": dict(mode="sketch", error_type="virtual",
                                    virtual_momentum=0.9, num_cols=2_000,
                                    num_rows=5, server_fused="off"),
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


def _start_from_nonzero_state(jl, tl, seed):
    """Give both learners the same nonzero server and client state."""
    rng = np.random.RandomState(seed)
    d, cfg = tl.cfg.grad_dim, tl.cfg

    def rows(on, shape):
        return (rng.randn(*shape).astype(np.float32) * 1e-3) if on else None

    opt = JaxOpt(Vvelocity=rows(True, (d,)), Verror=rows(True, (d,)))
    clients = JaxClients(velocities=rows(cfg.needs_velocity_state,
                                         (CLIENTS, d)),
                         errors=rows(cfg.needs_error_state, (CLIENTS, d)))
    jl.state = jl.state.replace(
        opt=jax.tree.map(jnp.asarray, opt),
        clients=jax.tree.map(jnp.asarray, clients))
    tl.state.opt = server_opt_from_arrays(opt)
    tl.state.clients = client_state_from_arrays(clients)


def _batches(rounds, seed, fedavg):
    rng = np.random.RandomState(seed)
    out = []
    for rnd in range(rounds):
        ids = rng.choice(CLIENTS, W, replace=False).astype(np.int32)
        batch = (rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (W, B)).astype(np.int32))
        mask = np.ones((W, B), np.float32)
        if fedavg:   # clients of 8, 5 and 7 datapoints: ragged tails
            mask[1, 5:] = 0
            mask[2, 7:] = 0
        if rnd == 2:   # an epoch-tail round: one empty slot, one ragged
            mask[3] = 0
            mask[1, 4:] = 0
        out.append((ids, batch, mask))
    return out


@pytest.mark.parametrize("name", list(MODES))
def test_three_rounds_match_jax(name):
    kw = dict(COMMON, **MODES[name])
    jl, tl = _learners(kw)
    if name == "local_topk_local_error":
        _start_from_nonzero_state(jl, tl, seed=7)
    for rnd, (ids, batch, mask) in enumerate(
            _batches(3, seed=len(name), fedavg=kw["mode"] == "fedavg")):
        ref = jl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        got = tl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints",
                    "aborted"):
            assert got[key] == ref[key], key
    np.testing.assert_array_equal(tl.state.last_changed.numpy(),
                                  np.asarray(jl.state.last_changed))
    np.testing.assert_array_equal(tl.state.client_last_round.numpy(),
                                  np.asarray(jl.state.client_last_round))
    assert int(tl.state.round_idx) == int(jl.state.round_idx) == 3
    close = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), **close)
    for field in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(getattr(tl.state.opt, field).numpy(),
                                   np.asarray(getattr(jl.state.opt, field)),
                                   **close)
    for field in ("velocities", "errors"):
        mine, ref = (getattr(s.clients, field) for s in (tl.state, jl.state))
        assert (mine is None) == (ref is None), field
        if ref is not None:
            assert mine.shape[0] == CLIENTS + 1
            # rows hold sums over a client's datapoints, not means: they
            # carry the gradients' relative error at B times the size
            np.testing.assert_allclose(mine[:CLIENTS].numpy(),
                                       np.asarray(ref), rtol=1e-5, atol=1e-6)


def _cli_args(tmp_path, *extra):
    # a small Synthetic set: 32 images a class, 256 to validate on
    (tmp_path / "stats.json").write_text(json.dumps(
        {"images_per_client": [32] * 10, "num_val_images": 256}))
    return build_parser().parse_args([
        "--num_workers", "2", "--k", "100", "--num_rows", "3",
        "--num_cols", "5000", "--valid_batch_size", "256",
        "--dataset_dir", str(tmp_path), "--device", "cpu",
        "--num_epochs", "1", *extra])


CLI_MODES = {
    "sketch_off": ["--mode", "sketch", "--error_type", "virtual",
                   "--server_fused", "off", "--local_batch_size", "4"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--virtual_momentum", "0.9", "--local_batch_size", "4"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.9", "--num_clients", "20",
                   "--local_batch_size", "4"],
    "uncompressed": ["--mode", "uncompressed", "--virtual_momentum", "0.9",
                     "--local_batch_size", "4"],
    "fedavg": ["--mode", "fedavg", "--local_batch_size", "-1",
               "--num_fedavg_epochs", "2", "--fedavg_batch_size", "16",
               "--fedavg_lr_decay", "0.9"],
}


@pytest.mark.parametrize("name", list(CLI_MODES))
def test_cli_runs_every_mode_on_cpu(tmp_path, monkeypatch, name):
    """The entry point in each mode, with a narrow ResNet9 in place of the
    full-width one (``chip_smoke.py`` runs full width on the card)."""
    monkeypatch.setattr(cv, "get_model",
                        lambda *a, **kw: ResNet9(channels=NARROW))
    learner, row = cv.train(_cli_args(tmp_path, *CLI_MODES[name]),
                            max_rounds=2, log=False)
    rounds = row["rounds"]
    assert len(rounds) == 2
    assert all(np.isfinite(r["loss"]) for r in rounds)
    assert np.isfinite(row["test_loss"])
    cfg = learner.cfg
    per_client = 4 * {"sketch": 3 * 5_120, "local_topk": 100}.get(
        cfg.mode, cfg.grad_size)
    assert all(r["upload_bytes"] == 2 * per_client for r in rounds)
    assert bool(torch.isfinite(learner.state.weights).all())


@pytest.mark.parametrize("flag,item", [
    (["--microbatch_size", "4"], "A5"), (["--topk_down"], "A5"),
    (["--mode", "local_topk", "--error_type", "none", "--client_k_dist",
      "uniform:0.5,1"], "A9"),
    (["--topk_approx_recall", "0.95"], "A2"),
    (["--client_state", "sparse"], "A9"), (["--grad_buckets", "2"], "A9"),
    (["--batchnorm"], "A6"), (["--sketch_scheme", "global"], "A1")])
def test_cli_refuses_unported_config_flags(tmp_path, flag, item):
    args = _cli_args(tmp_path, "--mode", "sketch", "--error_type",
                     "virtual", *flag)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        cv.train(args, log=False)
