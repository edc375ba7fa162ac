"""The seeded fault model, the buffered (FedBuff) server and per-client
quarantine of the port, on the CPU.

Against the JAX reference:

* ``FaultModel``'s draws (fates, cohorts, the sync barrier, the straggler
  mask) bitwise over a grid of seeds;
* the buffered learner under a fault schedule: ``fault_stats``,
  ``applies_done`` and ``sim_time`` exactly (the event loop is host
  numpy), weights and bytes at the round parity's tolerance (atol 1e-6,
  bytes exact);
* quarantine in the sync and buffered servers: the same dropped
  contribution, bench clock and uploads, weights at atol 1e-6.

Within the port, bitwise: the lock-step buffered learner is the sync
learner, with and without quarantine, through a padded tail and a NaN
round (and the reference's lock-step learner at atol 1e-6); a faulted
run replays; offloaded rows equal device-resident rows, under quarantine
too.
And: ``flush_faults`` applies a partial buffer, the staleness discount
changes the trajectory, the server-side breach still aborts, and the
reference's refusals raise its errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.buffer import \
    BufferedFedLearner as JaxBuffered
from commefficient_tpu.federated.faults import FaultModel as JaxFaults
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models.toy import TinyMLP as JaxTinyMLP
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.buffer import BufferedFedLearner
from commefficient_tpu_torch.federated.faults import FaultModel
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.toy import TinyMLP
from commefficient_tpu_torch.training.args import (build_parser,
                                                   learner_factory,
                                                   refuse_buffered_scan)
from commefficient_tpu_torch.utils.params import params_from_jax

N, W, B = 6, 2, 4
MLP = dict(num_classes=2, hidden=4)
CFG = dict(mode="local_topk", error_type="local", local_momentum=0.9, k=3,
           weight_decay=0, num_workers=W, num_clients=N, lr_scale=0.05)
FAULTS = dict(straggler_frac=0.3, straggler_mult=5.0, dropout_prob=0.15,
              crash_prob=0.05)
# round 4's worker 0 (the NaN batch) is client 4; rounds 5 and 6 sample
# client 4 again, so its bench shows; round 7 lets it age out
QUARANTINE_IDS = [[0, 1], [2, 3], [4, 5], [0, 1],
                  [4, 5], [4, 1], [4, 2], [0, 1]]


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


def port(params, server_mode="sync", fault_model=None, **kw):
    model = TinyMLP(**MLP, in_channels=8, image_size=1)
    model.load_state_dict(params_from_jax(params))
    cfg = FedConfig(server_mode=server_mode, **dict(CFG, **kw))
    if server_mode == "buffered":
        return BufferedFedLearner(model, cfg, make_cv_loss(model),
                                  device="cpu", fault_model=fault_model)
    return FedLearner(model, cfg, make_cv_loss(model), device="cpu")


def ref(params, server_mode="sync", fault_model=None, **kw):
    model = JaxTinyMLP(**MLP)
    cfg = JaxConfig(server_mode=server_mode, **dict(CFG, **kw))
    args = (model, cfg, jax_cv_loss(model), None, jax.random.PRNGKey(1),
            np.zeros((1, 8), np.float32))
    if server_mode == "buffered":
        return JaxBuffered(*args, init_params=params,
                           fault_model=fault_model)
    return JaxLearner(*args, init_params=params)


def scenario(n_rounds=8, nan_round=4, ids_fn=None, seed=0):
    """Consecutive rounds share a client, round 2 has a padded slot, and
    worker 0's batch at ``nan_round`` holds a NaN."""
    rng = np.random.RandomState(seed)
    rounds = []
    for r in range(n_rounds):
        ids = (np.array([r % N, (r + 1) % N]) if ids_fn is None
               else np.asarray(ids_fn(r)))
        xs = rng.randn(W, B, 8).astype(np.float32)
        ys = rng.randint(0, 2, (W, B)).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        if r == 2:
            mask[-1] = 0.0
        if r == nan_round:
            xs[0, 0, 0] = np.nan
        rounds.append((ids.astype(np.int32), (xs, ys), mask))
    return rounds


def run(ln, rounds, keep=()):
    outs = []
    for ids, batch, mask in rounds:
        raw = ln.train_round_async(ids, batch, mask)
        extra = {k: float(np.asarray(raw[k])) for k in keep if k in raw}
        out = ln.finalize_round_metrics(raw)
        out.update(extra)
        outs.append(out)
    return outs


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def same_bits(x, y) -> bool:
    """Bitwise equal tensors (NaN included)."""
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def assert_same_port(a, b, outs_a, outs_b):
    for x, y in zip(outs_a, outs_b):
        for key in ("loss", "aborted", "download_bytes", "upload_bytes",
                    "update_l2"):
            assert np.array_equal(x[key], y[key], equal_nan=True), key
    for field in ("weights", "last_changed", "client_last_round",
                  "quarantine", "round_idx", "weights_version", "aborted"):
        assert same_bits(getattr(a.state, field),
                         getattr(b.state, field)), field
    for field in ("velocities", "errors"):
        assert same_bits(getattr(a.state.clients, field),
                         getattr(b.state.clients, field)), field
    assert same_bits(a.state.opt.Vvelocity, b.state.opt.Vvelocity)
    assert a.total_download_bytes == b.total_download_bytes
    assert a.total_upload_bytes == b.total_upload_bytes


# --------------------------------------------------------------------------
# the fault model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_fault_model_draws_bitwise(seed):
    kw = dict(FAULTS, base_latency=1.5, latency_sigma=0.4)
    fm, jf = FaultModel(seed, 11, **kw), JaxFaults(seed, 11, **kw)
    for r in (0, 1, 5, 37):
        for c in range(11):
            a, b = fm.fate(r, c), jf.fate(r, c)
            assert (a.started, a.arrives, a.latency) == (
                b.started, b.arrives, b.latency)
    ids, valid = [3, 9, 0, 4], [True, True, False, True]
    for a, b in zip(fm.cohort_fates(12, ids, valid),
                    jf.cohort_fates(12, ids, valid)):
        np.testing.assert_array_equal(a, b)
    pa, sa, ta = fm.sync_round(4, ids, valid)
    pb, sb, tb = jf.sync_round(4, ids, valid)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(sa, sb)
    assert ta == tb and fm.sync_timeout == jf.sync_timeout
    np.testing.assert_array_equal(fm.straggler, jf.straggler)
    assert fm.fate_draws == jf.fate_draws
    with pytest.raises(ValueError):
        FaultModel(seed, 4, dropout_prob=1.0)


# --------------------------------------------------------------------------
# lock-step: the buffered learner is the sync learner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quarantine", [False, True])
def test_lockstep_matches_sync_bitwise(params, quarantine):
    kw = dict(client_quarantine=True, quarantine_rounds=2) if quarantine \
        else {}
    rounds = scenario()
    s, b = port(params, **kw), port(params, "buffered", **kw)
    outs_s, outs_b = run(s, rounds), run(b, rounds)
    # the scenario really tripped the guard (without quarantine) or
    # excluded the NaN slot (with it)
    assert outs_s[-1]["aborted"] != quarantine
    assert_same_port(s, b, outs_s, outs_b)
    assert b.applies_done == b.cohorts_done == len(rounds)
    assert int(b.state.weights_version) == int(b.state.round_idx)


def test_lockstep_matches_reference(params):
    """The lock-step learner against the reference's buffered learner
    with no fault model, at the round parity's tolerance (ROADMAP C13),
    at an exact local momentum (0.5: XLA contracts ``g + rho * v`` into
    an FMA, C2, and over 8 rounds at 0.9 the sync learners of the two
    packages already part at a top-k tie)."""
    rounds = scenario(nan_round=None)
    a = port(params, "buffered", local_momentum=0.5)
    b = ref(params, "buffered", local_momentum=0.5)
    for x, y in zip(run(a, rounds), run(b, rounds)):
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-5)
        assert (x["upload_bytes"], x["download_bytes"]) == (
            y["upload_bytes"], y["download_bytes"])
    np.testing.assert_allclose(_np(a.state.weights), _np(b.state.weights),
                               rtol=0, atol=1e-6)
    assert (a.applies_done, int(a.state.weights_version)) == (
        b.applies_done, int(b.state.weights_version))


# --------------------------------------------------------------------------
# the event loop under faults, against the reference
# --------------------------------------------------------------------------

def _faulted(params, make, faults, alpha=0.0, **kw):
    return make(params, "buffered", fault_model=faults(3, N, **FAULTS),
                buffer_m=3, staleness_alpha=alpha, **kw)


@pytest.fixture(scope="module")
def faulted_pair(params):
    """A 12-cohort faulted schedule on both packages (alpha 0.5)."""
    rounds = scenario(n_rounds=12, nan_round=None)
    a = _faulted(params, port, FaultModel, alpha=0.5)
    b = _faulted(params, ref, JaxFaults, alpha=0.5)
    outs_a = run(a, rounds, keep=("staleness_mean",))
    outs_b = run(b, rounds)
    fa, fb = a.flush_faults(), b.flush_faults()
    return rounds, (a, outs_a, fa), (b, outs_b, fb)


def test_faulted_schedule_matches_reference(faulted_pair):
    _, (a, outs_a, fa), (b, outs_b, fb) = faulted_pair
    assert a.fault_stats == b.fault_stats
    assert (a.applies_done, a.cohorts_done) == (b.applies_done,
                                                b.cohorts_done)
    assert a.sim_time == b.sim_time
    assert a.fault_stats["dropouts"] + a.fault_stats["crashes"] > 0
    assert a.event_cursor() == b.event_cursor()
    for x, y in zip(outs_a, outs_b):
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-5)
        assert x["upload_bytes"] == y["upload_bytes"]
        assert x["download_bytes"] == y["download_bytes"]
    assert (fa is None) == (fb is None)
    np.testing.assert_allclose(_np(a.state.weights), _np(b.state.weights),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(a.state.client_last_round),
                                  _np(b.state.client_last_round))
    assert int(a.state.weights_version) == int(b.state.weights_version)
    assert a.total_upload_bytes == b.total_upload_bytes
    assert a.total_download_bytes == b.total_download_bytes


def test_staleness_discount_changes_trajectory(params, faulted_pair):
    rounds, (a, outs_a, _), _ = faulted_pair
    flat = _faulted(params, port, FaultModel, alpha=0.0)
    run(flat, rounds)
    flat.flush_faults()
    assert flat.fault_stats == a.fault_stats
    assert any(o.get("staleness_mean", 0) > 0 for o in outs_a)
    assert not torch.equal(flat.state.weights, a.state.weights)
    # and the faulted run replays bitwise from its seed
    again = _faulted(params, port, FaultModel, alpha=0.5)
    run(again, rounds)
    again.flush_faults()
    assert torch.equal(again.state.weights, a.state.weights)
    assert again.sim_time == a.sim_time


def test_flush_faults_applies_partial_buffer(params):
    fm = FaultModel(0, N, latency_sigma=1e-9)
    ln = port(params, "buffered", fault_model=fm, buffer_m=5)
    w0 = ln.state.weights.clone()
    run(ln, scenario(n_rounds=1, nan_round=None))
    assert ln.applies_done == 0 and ln.total_upload_bytes == 0
    out = ln.flush_faults()
    assert ln.applies_done == 1
    assert ln.fault_stats["partial_applies"] == 1
    assert out["upload_bytes"] > 0
    assert ln.total_upload_bytes == out["upload_bytes"]
    assert not torch.equal(ln.state.weights, w0)
    assert ln.flush_faults() is None


def test_buffered_offload_matches_device_rows_bitwise(params):
    rounds = scenario(n_rounds=10, nan_round=None)
    dev = _faulted(params, port, FaultModel)
    off = _faulted(params, port, FaultModel, client_state_offload=True)
    outs_dev, outs_off = run(dev, rounds), run(off, rounds)
    dev.flush_faults()
    off.flush_faults()
    for x, y in zip(outs_dev, outs_off):
        assert (x["loss"], x["upload_bytes"]) == (y["loss"],
                                                  y["upload_bytes"])
    assert torch.equal(dev.state.weights, off.state.weights)
    for field in ("velocities", "errors"):
        rows = getattr(dev.state.clients, field)[:N]
        assert torch.equal(rows, off.host_store.stacked(field)), field
    assert off._offload_pipe.stats["flushed_rounds"] > 0


# --------------------------------------------------------------------------
# quarantine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("server_mode", ["sync", "buffered"])
def test_quarantine_drops_only_bad_contribution(params, server_mode):
    kw = dict(client_quarantine=True, quarantine_rounds=2)
    rounds = scenario(ids_fn=lambda r: QUARANTINE_IDS[r])
    keep = ("dropped_contributions", "num_quarantined")
    a, b = port(params, server_mode, **kw), ref(params, server_mode, **kw)
    outs_a, outs_b = run(a, rounds, keep=keep), run(b, rounds, keep=keep)
    assert not any(o["aborted"] for o in outs_a)
    assert torch.isfinite(a.state.weights).all()
    assert [o["dropped_contributions"] for o in outs_a] == \
        [0, 0, 0, 0, 1, 0, 0, 0]
    assert [o["num_quarantined"] for o in outs_a] == [0, 0, 0, 0, 1, 1, 0, 0]
    full = outs_a[0]["upload_bytes"]
    assert outs_a[5]["upload_bytes"] == outs_a[6]["upload_bytes"] == full / 2
    for x, y in zip(outs_a, outs_b):
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=1e-5)
        for key in keep + ("upload_bytes", "download_bytes", "aborted"):
            assert x[key] == y[key], key
    np.testing.assert_allclose(_np(a.state.weights), _np(b.state.weights),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(a.state.quarantine),
                                  _np(b.state.quarantine))
    np.testing.assert_array_equal(_np(a.state.client_last_round),
                                  _np(b.state.client_last_round))


@pytest.mark.parametrize("faulted", [False, True])
def test_quarantine_offload_matches_device_rows_bitwise(params, faulted):
    """A NaN client's rows and a benched client's stay out of the host
    arenas, as the device scatter leaves them out of the device rows: in
    the sync round, and in the buffered server under a fault schedule."""
    kw = dict(client_quarantine=True, quarantine_rounds=2)
    rounds = scenario(ids_fn=lambda r: QUARANTINE_IDS[r])
    keep = ("dropped_contributions", "num_quarantined")
    if faulted:
        dev = _faulted(params, port, FaultModel, **kw)
        off = _faulted(params, port, FaultModel, client_state_offload=True,
                       **kw)
    else:
        dev = port(params, **kw)
        off = port(params, client_state_offload=True, **kw)
    outs_dev, outs_off = run(dev, rounds, keep), run(off, rounds, keep)
    if faulted:
        # the end-of-training flush applies the buffer's last slots
        outs_dev.append(dev.flush_faults())
        outs_off.append(off.flush_faults())
    off.flush_offload()
    assert sum(o.get("dropped_contributions", 0) for o in outs_off) == 1
    for x, y in zip(outs_dev, outs_off):
        for key in ("loss", "upload_bytes", "download_bytes") + keep:
            assert x.get(key) == y.get(key), key
    for field in ("weights", "quarantine", "client_last_round"):
        assert same_bits(getattr(dev.state, field),
                         getattr(off.state, field)), field
    for field in ("velocities", "errors"):
        rows = getattr(dev.state.clients, field)[:N]
        assert torch.isfinite(rows).all(), field
        assert same_bits(rows, off.host_store.stacked(field)), field


def test_quarantine_still_aborts_on_server_breach(params):
    ln = port(params, client_quarantine=True, nan_threshold=1e-6)
    outs = run(ln, scenario(n_rounds=3, nan_round=None))
    assert outs[0]["aborted"] and outs[-1]["aborted"]
    assert int(ln.state.round_idx) == 0


# --------------------------------------------------------------------------
# the reference's refusals
# --------------------------------------------------------------------------

def test_reference_refusals(params):
    model = TinyMLP(**MLP, in_channels=8, image_size=1)
    with pytest.raises(ValueError, match="server_mode"):
        BufferedFedLearner(model, FedConfig(**CFG), make_cv_loss(model),
                           device="cpu")
    with pytest.raises(ValueError, match="grad_buckets"):
        FedConfig(server_mode="buffered", grad_buckets=2, **CFG).validate()
    b = port(params, "buffered")
    with pytest.raises(NotImplementedError, match="scan window"):
        b.scan_window(2)
    with pytest.raises(NotImplementedError, match="event loop"):
        b.train_rounds_scan(None, None, None)
    parse = build_parser().parse_args
    with pytest.raises(ValueError, match="--fault_seed needs"):
        learner_factory(parse(["--fault_seed", "3"]), N)
    with pytest.raises(ValueError, match="sync-mode optimization"):
        refuse_buffered_scan(parse(["--server_mode", "buffered",
                                    "--scan_rounds", "2"]))
    cls, extra = learner_factory(parse([
        "--server_mode", "buffered", "--fault_seed", "5",
        "--straggler_frac", "0.5", "--dispatch_interval", "2.0"]), N)
    assert cls is BufferedFedLearner and extra["dispatch_interval"] == 2.0
    fm = extra["fault_model"]
    assert (fm.seed, fm.straggler_frac, fm.num_clients) == (5, 0.5, N)
