"""The port's federated round against the JAX reference on the CPU.

* ``download_counts`` and the round's byte metrics: exact;
* the sketch-mode ``server_update`` fed the same table and state: bitwise
  where the momentum product is exact; the reference's jitted
  ``g + rho*v`` is an FMA and the port's eager one is not, so at rho=0.9
  they differ by up to 1 ulp of ``rho*v`` (plus 1 ulp of the result);
* one and three whole ``FedLearner`` rounds from the same bridged weights
  and batches: loss rtol 1e-5, byte metrics and ``last_changed`` exact,
  weights within atol 1e-6 (convolution summation order);
* the seeded data pipeline gives both packages the same rounds;
* the CLI entry point runs on the CPU when asked and refuses CUDA when
  there is none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.data.batching import FedBatcher as JaxBatcher
from commefficient_tpu.data.synthetic import SyntheticCV as JaxSynthetic
from commefficient_tpu.federated import server as jax_server
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.federated.round import \
    download_counts as jax_download_counts
from commefficient_tpu.federated.state import ServerOptState as JaxOpt
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.data.batching import FedBatcher
from commefficient_tpu_torch.data.synthetic import SyntheticCV
from commefficient_tpu_torch.federated import server
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.federated.round import download_counts
from commefficient_tpu_torch.federated.state import ServerOptState
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.training.cv import train
from commefficient_tpu_torch.utils.params import params_from_jax

NARROW = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
SKETCH = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
              k=200, num_cols=2_000, num_rows=5, num_clients=10,
              num_workers=4)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_download_counts_bitwise():
    rng = np.random.RandomState(0)
    for W, d in ((1, 50), (4, 1_000), (8, 5_000)):
        last_changed = rng.randint(-2, 6, d).astype(np.int32)
        stale = rng.randint(-1, 6, W).astype(np.int32)
        stale[:W // 2] = stale[0]   # duplicate stale rounds
        ref = jax_download_counts(jnp.asarray(last_changed),
                                  jnp.asarray(stale))
        got = download_counts(torch.from_numpy(last_changed),
                              torch.from_numpy(stale))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        dense = (last_changed[None, :] >= stale[:, None]).sum(1)
        np.testing.assert_array_equal(got.numpy(), dense)


@pytest.mark.parametrize("error_type", ["virtual", "none"])
def test_server_update_matches_jax_bitwise(error_type):
    """With momentum 0.5 the product ``rho*v`` is exact, so FMA contraction
    cannot matter and the whole server step — momentum, error, fused
    unsketch + top-k, re-sketch of the survivors, masking — is bitwise the
    reference's (the 0.9 case is pinned below)."""
    d = 30_000
    kw = dict(SKETCH, error_type=error_type, virtual_momentum=0.5, k=300)
    jcfg = JaxConfig(**kw).finalize(d)
    cfg = FedConfig(**kw).finalize(d)
    rng = np.random.RandomState(1)
    shape = cfg.transmit_shape
    g, vv, ve = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    lr = np.float32(0.3)
    j_update, j_state = jax.jit(
        lambda g_, s_: jax_server.server_update(g_, s_, jcfg, lr))(
            jnp.asarray(g), JaxOpt(Vvelocity=jnp.asarray(vv),
                                   Verror=jnp.asarray(ve)))
    update, state = server.server_update(
        torch.from_numpy(g), ServerOptState(Vvelocity=torch.from_numpy(vv),
                                            Verror=torch.from_numpy(ve)),
        cfg, float(lr))
    assert int((update != 0).sum()) == 300
    np.testing.assert_array_equal(_bits(update), _bits(j_update))
    np.testing.assert_array_equal(_bits(state.Vvelocity),
                                  _bits(j_state.Vvelocity))
    np.testing.assert_array_equal(_bits(state.Verror), _bits(j_state.Verror))


def test_momentum_step_fma_tolerance():
    """``g + rho*v`` at rho=0.9: the reference's jitted XLA contracts it
    into an FMA (one rounding), the port's eager PyTorch rounds the product
    first. They differ by at most 1 ulp of ``rho*v`` plus 1 ulp of the
    result — many ulps of the result where g and rho*v cancel."""
    rng = np.random.RandomState(2)
    g, v = rng.randn(2, 100_000).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda a, b: jax_server._momentum(a, b, 0.9))(g, v))
    got = server._momentum(torch.from_numpy(g), torch.from_numpy(v),
                           0.9).numpy()
    prod = np.float32(0.9) * v
    assert np.all(np.abs(got - ref)
                  <= np.spacing(np.abs(prod)) + np.spacing(np.abs(ref)))
    exact = (np.float64(np.float32(0.9)) * v + g).astype(np.float32)
    np.testing.assert_array_equal(ref, exact)      # XLA: one rounding
    assert (got != ref).any()


def _learners(seed=0):
    jmodel = JaxResNet9(channels=NARROW)
    sample = jnp.zeros((1, 32, 32, 3))
    params = jmodel.init(jax.random.PRNGKey(seed), sample,
                         train=False)["params"]
    jl = JaxLearner(jmodel, JaxConfig(**SKETCH), jax_cv_loss(jmodel),
                    jax_cv_loss(jmodel), jax.random.PRNGKey(seed), sample,
                    init_params=params)
    model = ResNet9(channels=NARROW)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    tl = FedLearner(model, FedConfig(**SKETCH), make_cv_loss(model),
                    make_cv_loss(model), device="cpu")
    return jl, tl


@pytest.mark.parametrize("rounds", [1, 3])
def test_fedlearner_rounds_match_jax(rounds):
    jl, tl = _learners()
    rng = np.random.RandomState(rounds)
    for rnd in range(rounds):
        ids = rng.choice(10, 4, replace=False).astype(np.int32)
        batch = (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (4, 8)).astype(np.int32))
        mask = np.ones((4, 8), np.float32)
        if rnd == 2:   # an epoch-tail round: one empty slot, one ragged
            mask[3] = 0
            mask[1, 5:] = 0
        ref = jl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        got = tl.train_round(ids, batch, mask, epoch_frac=1.0 + rnd)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["metrics"], ref["metrics"])
        for key in ("download_bytes", "upload_bytes", "num_datapoints",
                    "aborted"):
            assert got[key] == ref[key], key
    np.testing.assert_array_equal(tl.state.last_changed.numpy(),
                                  np.asarray(jl.state.last_changed))
    np.testing.assert_array_equal(tl.state.client_last_round.numpy(),
                                  np.asarray(jl.state.client_last_round))
    assert int(tl.state.round_idx) == int(jl.state.round_idx) == rounds
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tl.state.opt.Verror.numpy(),
                               np.asarray(jl.state.opt.Verror), rtol=0,
                               atol=1e-6)


def test_nan_guard_freezes_state():
    _, tl = _learners()
    before = tl.state.weights.clone()
    batch = (np.full((4, 8, 32, 32, 3), np.nan, np.float32),
             np.zeros((4, 8), np.int32))
    out = tl.train_round(np.arange(4), batch, np.ones((4, 8), np.float32),
                         epoch_frac=1.0)
    assert out["aborted"] and out["download_bytes"] == 0
    assert out["upload_bytes"] == 0
    torch.testing.assert_close(tl.state.weights, before, rtol=0, atol=0)
    assert int(tl.state.round_idx) == 0


def test_data_pipeline_rounds_match_jax(tmp_path):
    """Same seeds, same draw order: identical client ids and batches."""
    kw = dict(num_clients=None, train=True, seed=21, per_class=64)
    jset = JaxSynthetic(dataset_dir=str(tmp_path / "jax"), **kw)
    tset = SyntheticCV(dataset_dir=str(tmp_path / "torch"), **kw)
    jb, tb = JaxBatcher(jset, 8, 32, seed=21), FedBatcher(tset, 8, 32,
                                                          seed=21)
    next(iter(jb.epoch()))
    next(iter(tb.epoch()))
    for (jids, jcols, jmask), (tids, tcols, tmask) in zip(jb.epoch(),
                                                          tb.epoch()):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tmask, jmask)
        for a, b in zip(tcols, jcols):
            np.testing.assert_array_equal(a, b)
    assert tb.steps_per_epoch() == jb.steps_per_epoch() == 3


def _cli_args(tmp_path, *extra):
    return build_parser().parse_args([
        "--mode", "sketch", "--error_type", "virtual",
        "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "4", "--k", "100", "--num_rows", "3",
        "--num_cols", "5000", "--valid_batch_size", "256",
        "--dataset_dir", str(tmp_path), "--test", *extra])


@pytest.fixture
def one_intra_op_thread():
    """One intra-op thread: under the suite's parallel workers, a
    full-width ResNet9 at 8 threads a worker oversubscribes the cores and
    its OpenMP threads spin-wait on each other (over 400 s against 12 s
    alone, measured with 7 busy processes on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_train_two_rounds_on_cpu(tmp_path, one_intra_op_thread):
    args = _cli_args(tmp_path, "--device", "cpu", "--num_epochs", "1")
    args.do_test = False   # --test only shrinks the dataset here
    learner, row = train(args, max_rounds=2, log=False)
    rounds = row["rounds"]
    assert len(rounds) == 2
    assert all(np.isfinite(r["loss"]) for r in rounds)
    assert all(r["upload_bytes"] == 4 * 3 * 5_120 * 2 for r in rounds)
    assert learner.cfg.grad_size == 6_568_640
    assert np.isfinite(row["test_loss"])


def test_entry_points_refuse_cuda_without_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train(_cli_args(tmp_path), max_rounds=1, log=False)
    model = ResNet9(channels=NARROW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedLearner(model, FedConfig(**SKETCH), make_cv_loss(model))


@pytest.mark.parametrize("override,item", [
    (dict(mode="local_topk", error_type="local", client_state_offload=True,
          mesh_shape=(1, 2), mesh_axis_names=("clients", "model")),
     "A12")])
def test_config_refuses_what_is_not_ported(override, item):
    """Offloaded client rows on a model mesh axis run since A12 1b
    (``tests/test_torch_tp_1b.py``): the config takes them."""
    cfg = FedConfig(**dict(SKETCH, **override)).finalize(1_000)
    assert cfg.model_axis == 2 and cfg.client_state_offload


@pytest.mark.parametrize("override", [dict(sketch_scheme="global"),
                                      dict(grad_buckets=2)])
def test_config_takes_what_was_refused(override):
    cfg = FedConfig(**dict(SKETCH, **override)).finalize(1_000)
    assert cfg.transmit_shape == ((5, 2_000) if cfg.sketch_scheme
                                  == "global" else (5, 2_048))


def test_cli_runs_client_state_offload(tmp_path):
    args = _cli_args(tmp_path, "--device", "cpu", "--num_epochs", "1",
                     "--model", "TinyMLP", "--mode", "local_topk",
                     "--error_type", "local", "--local_momentum", "0.9",
                     "--client_state_offload", "--offload_pipeline_depth",
                     "3")
    args.do_test = False
    learner, row = train(args, max_rounds=3, log=False)
    assert len(row["rounds"]) == 3
    assert learner.state.clients.errors is None
    assert learner._offload_pipe.depth == 3
    # the loop flushed at the epoch's end: every round's rows landed
    assert not learner._offload_pipe._pending
    stats = learner._offload_pipe.stats
    assert stats["flushed_rounds"] == 3 and stats["prefetch_hits"] == 2
    assert learner.host_store.shard_writes.sum() == 2 * 3 * 2


@pytest.mark.parametrize("flag", [["--mesh", "clients=2,model=2"],
                                  ["--finetune"],
                                  ["--serve_tp", "2"]])
def test_cli_refuses_unported_flags(tmp_path, flag):
    """``--finetune`` runs since ROADMAP A10: a missing checkpoint at
    ``--finetune_path`` raises instead of a refusal. ``--mesh clients=N``
    runs since A12's clients axis; a CV run refuses an inner axis with the
    reference's ValueError. ``--serve_tp`` above 1 runs since A12's model
    axis: without a model mesh axis it raises the reference's
    ValueError."""
    exc, match = NotImplementedError, "ROADMAP"
    if flag[0] == "--mesh":
        exc, match = ValueError, "CV models have no TP layout"
    if flag[0] == "--serve_tp":
        exc, match = ValueError, "add model=2 to --mesh"
    if flag == ["--finetune"]:
        flag = flag + ["--finetune_path", str(tmp_path / "missing.npz")]
        exc, match = FileNotFoundError, "missing.npz"
    with pytest.raises(exc, match=match):
        train(_cli_args(tmp_path, "--device", "cpu", *flag), log=False)
