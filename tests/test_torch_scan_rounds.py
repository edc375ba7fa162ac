"""``--scan_rounds``: the port's K-round windows on the CPU.

Within the port, bitwise: ``train_rounds_scan`` against K
``train_round`` calls (every per-round dict, weights, server and client
state, ``rounds_done``, byte totals) in the three configurations of the
reference's ``test_rounds_scan_matches_sequential``; ``ScanWindow`` over
7 rounds at K = 3 (two windows and a tail of one); the first aborted
round of a window, with the sticky guard freezing the rest; the CV
entry point at ``--scan_rounds 2`` against 1. Against the reference: the
scanned sketch rounds from the same flat weights (loss rtol 1e-5, bytes
exact), the finalize mix-up errors and the refusal under
``--client_state_offload``, with the reference's types and messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models.toy import TinyMLP as JaxTinyMLP
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.toy import TinyMLP
from commefficient_tpu_torch.training.args import build_parser
from commefficient_tpu_torch.training.cv import train
from commefficient_tpu_torch.training.loop import RoundFeed, first_abort
from commefficient_tpu_torch.utils.params import params_from_jax

N, W, B = 8, 3, 4
MLP = dict(num_classes=2, hidden=16)          # d = 178
BASE = dict(weight_decay=1e-3, num_workers=W, num_clients=N, lr_scale=0.05)
# the reference's three scan configurations (tests/test_round.py)
CONFIGS = {
    "uncompressed": dict(mode="uncompressed", error_type="none",
                         virtual_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual",
                   virtual_momentum=0.9, k=1, num_rows=3, num_cols=16),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, virtual_momentum=0, k=1),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tests' tensors are small: one intra-op thread keeps each
    operation from waiting on threads that the suite's other workers
    hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed=1):
    jmodel = JaxTinyMLP(**MLP)
    return jmodel, jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8)), train=False)["params"])


def _sched(t):
    """An LR that moves every round, so each schedule point counts."""
    return 0.05 + 0.01 * float(t)


def _port(params, **kw):
    model = TinyMLP(**MLP, in_channels=8, image_size=1)
    model.load_state_dict(params_from_jax(params))
    return FedLearner(model, FedConfig(**dict(BASE, **kw)),
                      make_cv_loss(model), lr_schedule=_sched, device="cpu",
                      seed=5)


def _rounds(n, seed=0, nan_round=None):
    """``n`` rounds of (ids, (x, y), mask); round 2 has a padded slot;
    ``nan_round`` trips the device guard there."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(n):
        ids = rng.choice(N, W, replace=False).astype(np.int32)
        xs = rng.randn(W, B, 8).astype(np.float32)
        ys = rng.randint(0, 2, (W, B)).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        if r == 2:
            mask[-1] = 0.0
        if r == nan_round:
            xs[0, 0, 0] = np.nan
        out.append((ids, (xs, ys), mask))
    return out


def _stack(rounds):
    return (np.stack([r[0] for r in rounds]),
            tuple(np.stack([r[1][i] for r in rounds]) for i in range(2)),
            np.stack([r[2] for r in rounds]))


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
        if a.dtype == torch.float32 else torch.equal(a, b)


def _assert_same_learners(a: FedLearner, b: FedLearner):
    sa, sb = a.state, b.state
    for x, y in ((sa.weights, sb.weights), (sa.round_idx, sb.round_idx),
                 (sa.last_changed, sb.last_changed),
                 (sa.client_last_round, sb.client_last_round),
                 (sa.aborted, sb.aborted)):
        assert _same(x, y)
    for x, y in ((sa.opt.Vvelocity, sb.opt.Vvelocity),
                 (sa.opt.Verror, sb.opt.Verror),
                 (sa.clients.velocities, sb.clients.velocities),
                 (sa.clients.errors, sb.clients.errors)):
        assert (x is None) == (y is None)
        if x is not None:
            assert _same(x, y)
    assert a.rounds_done == b.rounds_done
    assert a.total_download_bytes == b.total_download_bytes
    assert a.total_upload_bytes == b.total_upload_bytes
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _assert_same_outs(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for x, y in zip(outs_a, outs_b):
        assert x.keys() == y.keys()
        for key in x:
            if key == "metrics":
                assert x[key].dtype == y[key].dtype
                np.testing.assert_array_equal(x[key], y[key])
            else:
                assert x[key] == y[key] or (x[key] != x[key]
                                            and y[key] != y[key]), key


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rounds_scan_matches_sequential_bitwise(name):
    _, params = _params()
    a, b = (_port(params, **CONFIGS[name]) for _ in range(2))
    rounds = _rounds(4)
    outs_a = [a.train_round(*r) for r in rounds]
    outs_b = b.finalize_scan_metrics(b.train_rounds_scan(*_stack(rounds)))
    _assert_same_outs(outs_a, outs_b)
    assert [o["lr"] for o in outs_b] == [_sched(t) for t in range(4)]
    _assert_same_learners(a, b)


def test_scan_window_flushes_its_tail():
    _, params = _params()
    a, b = (_port(params, **CONFIGS["sketch"]) for _ in range(2))
    rounds = _rounds(7)
    outs_a = [a.train_round(*r, epoch_frac=0.5 * i)
              for i, r in enumerate(rounds)]
    window = b.scan_window(3)
    outs_b, sizes = [], []
    for i, (ids, cols, mask) in enumerate(rounds):
        got = window.push(ids, cols, mask, 0.5 * i)
        sizes.append(None if got is None else len(got))
        outs_b += got or []
    tail = window.flush()
    assert sizes == [None, None, 3, None, None, 3, None]
    assert len(tail) == 1 and window.flush() == []
    _assert_same_outs(outs_a, outs_b + tail)
    _assert_same_learners(a, b)


def test_window_reports_the_first_aborted_round():
    _, params = _params()
    a, b = (_port(params, **CONFIGS["uncompressed"]) for _ in range(2))
    rounds = _rounds(4, nan_round=1)
    a.train_round(*rounds[0])
    feed = RoundFeed(b, scan_k=4)
    outs = []
    for i, (ids, cols, mask) in enumerate(rounds):
        outs += feed.push(ids, cols, mask, i)
    assert [o["aborted"] for o in outs] == [False, True, True, True]
    assert first_abort(outs) is outs[1]
    assert all(o["round_s"] == outs[0]["round_s"] for o in outs)
    # the breach froze every round after it: the state is round 1's
    assert _same(a.state.weights, b.state.weights)
    assert int(b.state.round_idx) == 1
    assert all(o["upload_bytes"] == 0.0 for o in outs[1:])


def test_scanned_sketch_rounds_match_jax():
    jmodel, params = _params()
    kw = dict(CONFIGS["sketch"], k=20, num_cols=64)
    jl = JaxLearner(jmodel, JaxConfig(**dict(BASE, **kw)),
                    jax_cv_loss(jmodel), None, jax.random.PRNGKey(1),
                    np.zeros((1, 8), np.float32), init_params=params,
                    lr_schedule=_sched)
    tl = _port(params, **kw)
    stacked = _stack(_rounds(3))
    ref = jl.finalize_scan_metrics(jl.train_rounds_scan(*stacked))
    got = tl.finalize_scan_metrics(tl.train_rounds_scan(*stacked))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=1e-5)
        for key in ("download_bytes", "upload_bytes", "num_datapoints",
                    "aborted"):
            assert g[key] == r[key], key
        assert g["lr"] == pytest.approx(r["lr"], rel=1e-7)
    assert tl.rounds_done == jl.rounds_done == 3
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=1e-6)


def _raises_alike(fn_port, fn_ref, exc):
    with pytest.raises(exc) as got:
        fn_port()
    with pytest.raises(exc) as ref:
        fn_ref()
    assert str(got.value) == str(ref.value)


def test_finalize_mixups_raise_the_references_errors():
    jmodel, params = _params()
    kw = CONFIGS["uncompressed"]
    jl = JaxLearner(jmodel, JaxConfig(**dict(BASE, **kw)),
                    jax_cv_loss(jmodel), None, jax.random.PRNGKey(1),
                    np.zeros((1, 8), np.float32), init_params=params)
    tl = _port(params, **kw)
    (ids, cols, mask), = _rounds(1)
    raw_t, raw_j = (ln.train_round_async(ids, cols, mask) for ln in (tl, jl))
    _raises_alike(lambda: tl.finalize_scan_metrics(dict(raw_t)),
                  lambda: jl.finalize_scan_metrics(dict(raw_j)), TypeError)
    tl.finalize_round_metrics(raw_t)
    jl.finalize_round_metrics(raw_j)
    _raises_alike(lambda: tl.finalize_round_metrics(raw_t),
                  lambda: jl.finalize_round_metrics(raw_j), ValueError)
    stacked = _stack([(ids, cols, mask)] * 2)
    scan_t, scan_j = (ln.train_rounds_scan(*stacked) for ln in (tl, jl))
    _raises_alike(lambda: tl.finalize_round_metrics(dict(scan_t)),
                  lambda: jl.finalize_round_metrics(dict(scan_j)), TypeError)
    tl.finalize_scan_metrics(scan_t)
    jl.finalize_scan_metrics(scan_j)
    _raises_alike(lambda: tl.finalize_scan_metrics(scan_t),
                  lambda: jl.finalize_scan_metrics(scan_j), ValueError)


def test_scan_refused_under_offload_with_the_references_message():
    jmodel, params = _params()
    kw = dict(CONFIGS["local_topk"], client_state_offload=True)
    jl = JaxLearner(jmodel, JaxConfig(**dict(BASE, **kw)),
                    jax_cv_loss(jmodel), None, jax.random.PRNGKey(1),
                    np.zeros((1, 8), np.float32), init_params=params)
    tl = _port(params, **kw)
    _raises_alike(lambda: tl.scan_window(2), lambda: jl.scan_window(2),
                  ValueError)
    stacked = _stack(_rounds(2))
    _raises_alike(lambda: tl.train_rounds_scan(*stacked),
                  lambda: jl.train_rounds_scan(*stacked), ValueError)


def _cli(tmp_path, *extra):
    (tmp_path / "stats.json").write_text(
        '{"images_per_client": [16, 16, 16, 16, 16, 16, 16, 16, 16, 16], '
        '"num_val_images": 32}')
    args = build_parser().parse_args([
        "--model", "TinyMLP", "--mode", "sketch", "--error_type", "virtual",
        "--virtual_momentum", "0.9", "--num_workers", "4",
        "--local_batch_size", "8", "--k", "200", "--num_rows", "3",
        "--num_cols", "1000", "--valid_batch_size", "32", "--num_epochs",
        "1", "--dataset_dir", str(tmp_path), "--device", "cpu", *extra])
    return train(args, log=False)


def test_cli_scan_rounds_equals_single_rounds(tmp_path):
    """An epoch of 5 rounds: windows of 2, 2 and a tail of 1 against the
    pipelined loop, bitwise; below 1 means 1."""
    a, row_a = _cli(tmp_path, "--scan_rounds", "2")
    b, row_b = _cli(tmp_path, "--scan_rounds", "1")
    c, row_c = _cli(tmp_path, "--scan_rounds", "0")
    assert len(row_a["rounds"]) == 5
    for row in (row_b, row_c):
        assert [(r["loss"], r["upload_bytes"], r["download_bytes"])
                for r in row_a["rounds"]] == [
            (r["loss"], r["upload_bytes"], r["download_bytes"])
            for r in row["rounds"]]
        assert row["test_loss"] == row_a["test_loss"]
    _assert_same_learners(a, b)
    _assert_same_learners(b, c)
