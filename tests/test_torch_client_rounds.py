"""Whole rounds of the client-state and transmit layers: the port against
the JAX reference on the CPU, and the port against itself.

Against JAX, 3 rounds from the same weights and batches (loss rtol 1e-5,
bytes and ``client_last_round`` exact, weights and client rows atol
1e-6): local_topk with ``--client_k_dist``; bucketed true_topk,
local_topk and sketch; ``--sketch_scheme global``; sparse (truncating)
and sketched local_topk; and the offload pipeline at depths 1, 2 and 3
over the reference's scenario with a padded tail and an abort round
(``tests/test_offload_async.py``).

Within the port, bitwise: offload against device-resident rows in every
codec; dense offload against sparse offload at k >= d/2 (the sparse codec
is exact there); bucketed dense modes against unbucketed ones; the
gather-ahead, the pending-row reads and an idempotent flush.
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
from commefficient_tpu_torch.federated.client_store import gather_rows
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models.toy import TinyMLP
from commefficient_tpu_torch.utils.params import params_from_jax

N, W, B = 8, 3, 4
MLP = dict(num_classes=2, hidden=16)          # d = 178
BASE = dict(weight_decay=1e-3, num_workers=W, num_clients=N, lr_scale=0.05)
LOCAL = dict(mode="local_topk", error_type="local", local_momentum=0.9,
             k=20)


def _params(seed=1):
    jmodel = JaxTinyMLP(**MLP)
    return jmodel, jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8)), train=False)["params"])


def _port(params, **kw):
    model = TinyMLP(**MLP, in_channels=8, image_size=1)
    model.load_state_dict(params_from_jax(params))
    return FedLearner(model, FedConfig(**dict(BASE, **kw)),
                      make_cv_loss(model), device="cpu")


def _pair(**kw):
    jmodel, params = _params()
    jl = JaxLearner(jmodel, JaxConfig(**dict(BASE, **kw)),
                    jax_cv_loss(jmodel), None, jax.random.PRNGKey(1),
                    np.zeros((1, 8), np.float32), init_params=params)
    return jl, _port(params, **kw)


def _scenario(rounds=3, seed=0, nan_round=None, shared=False):
    """Rounds of (ids, batch, mask); round 2 has a padded tail slot. With
    ``shared`` consecutive rounds share a client (ids r, r+1, r+2 mod N);
    ``nan_round`` trips the device guard there."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rounds):
        ids = (np.arange(r, r + W) % N if shared
               else rng.choice(N, W, replace=False)).astype(np.int32)
        xs = rng.randn(W, B, 8).astype(np.float32)
        ys = rng.randint(0, 2, (W, B)).astype(np.int32)
        mask = np.ones((W, B), np.float32)
        if r == 2:
            mask[-1] = 0.0
        if r == nan_round:
            xs[0, 0, 0] = np.nan
        out.append((ids, (xs, ys), mask))
    return out


def _dense_rows(learner, field):
    """Every client's dense row of ``field`` (device state or arenas)."""
    if learner._offload:
        view = learner.host_clients[field]
        if view is None:
            return None
        rows = [view[i] for i in range(N)]
        enc = (torch.stack(rows) if torch.is_tensor(rows[0]) else
               {k: torch.stack([r[k] for r in rows]) for k in rows[0]})
        return learner.codec.decode_rows(enc)
    return gather_rows(getattr(learner.state.clients, field),
                       torch.arange(N), learner.codec)


def _jax_dense_rows(jl, field):
    codec = jl.codec
    if jl._offload:
        view = jl.host_clients[field]
        if view is None:
            return None
        rows = [view[i] for i in range(N)]
        if codec.host_side_offload:
            return np.stack([codec.decode_row_np(r) for r in rows])
        enc = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
        return np.asarray(codec.decode_rows(enc))
    storage = getattr(jl.state.clients, field)
    if storage is None:
        return None
    return np.asarray(codec.decode_rows(storage))


def _assert_round(got, ref, rtol=1e-5):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=rtol)
    for key in ("download_bytes", "upload_bytes", "num_datapoints",
                "aborted"):
        assert got[key] == ref[key], key


def _assert_state(tl, jl, atol=1e-6):
    np.testing.assert_allclose(tl.state.weights.numpy(),
                               np.asarray(jl.state.weights), rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(tl.state.client_last_round.numpy(),
                                  np.asarray(jl.state.client_last_round))
    for field in ("velocities", "errors", "weights"):
        mine, ref = _dense_rows(tl, field), _jax_dense_rows(jl, field)
        assert (mine is None) == (ref is None), field
        if ref is not None:
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=atol,
                                       err_msg=field)


PARITY = {
    "local_topk_kdist": dict(LOCAL, client_k_dist="uniform:0.25,1.0"),
    "true_topk_buckets": dict(mode="true_topk", error_type="virtual",
                              virtual_momentum=0.9, k=20, grad_buckets=3),
    "local_topk_buckets": dict(LOCAL, grad_buckets=4),
    "sketch_buckets": dict(mode="sketch", error_type="virtual",
                           virtual_momentum=0.9, k=20, num_rows=3,
                           num_cols=256, grad_buckets=2),
    "sketch_global": dict(mode="sketch", error_type="virtual",
                          virtual_momentum=0.9, k=20, num_rows=3,
                          num_cols=100, sketch_scheme="global"),
    "sketch_global_off": dict(mode="sketch", error_type="virtual",
                              k=20, num_rows=5, num_cols=64,
                              sketch_scheme="global", server_fused="off"),
    # the truncating encode keeps the cap largest |x|: a 1-ulp difference
    # swaps two near-equal entries at the cap, and XLA's FMA of g + rho*v
    # gives one at rho = 0.9 (ROADMAP C2), so these compare at an exact
    # rho
    "local_topk_sparse": dict(LOCAL, client_state="sparse",
                              local_momentum=0.5),
    "local_topk_sketched": dict(mode="local_topk", error_type="local",
                                k=20, client_state="sketched",
                                client_sketch_rows=3, client_sketch_cols=32),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_three_rounds_match_jax(name):
    jl, tl = _pair(**PARITY[name])
    if "buckets" in name:
        assert jl.grad_buckets is not None
        assert (tl.grad_buckets.offsets, tl.grad_buckets.sizes) == (
            jl.grad_buckets.offsets, jl.grad_buckets.sizes)
    for ids, batch, mask in _scenario():
        _assert_round(tl.train_round(ids, batch, mask),
                      jl.train_round(ids, batch, mask))
    _assert_state(tl, jl)
    if tl.cfg.mode == "sketch":
        for a, b in ((tl.state.opt.Vvelocity, jl.state.opt.Vvelocity),
                     (tl.state.opt.Verror, jl.state.opt.Verror)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_kdist_transmits_at_most_each_clients_budget():
    """Each client's transmit has min(k_i, nnz) nonzeros, k_i its own
    draw; the upload is still charged at k a client, as the reference's."""
    from commefficient_tpu_torch.federated import client as client_lib
    from commefficient_tpu_torch.federated.faults import cohort_client_ks
    cfg = dict(LOCAL, client_k_dist="uniform:0.25,1.0")
    tl = _port(_params()[1], **cfg)
    seen = []
    topk = client_lib.topk

    def spy(vec, k, row_k=None, use_kernel=None):
        out = topk(vec, k, row_k=row_k, use_kernel=use_kernel)
        seen.append(((vec != 0).sum(1), (out != 0).sum(1), row_k))
        return out
    client_lib.topk = spy
    try:
        for ids, batch, mask in _scenario():
            out = tl.train_round(ids, batch, mask)
            assert out["upload_bytes"] == 4 * 20 * int(mask.any(1).sum())
            nnz_in, nnz_out, row_k = seen.pop()
            ks = cohort_client_ks(21, ids, 20, "uniform:0.25,1.0")
            np.testing.assert_array_equal(row_k.numpy(), ks)
            np.testing.assert_array_equal(
                nnz_out.numpy(), np.minimum(ks, nnz_in.numpy()))
    finally:
        client_lib.topk = topk
    assert len(set(tl._client_k_memo.values())) > 1


# --- the offload pipeline against JAX's ------------------------------------

def _run_sync(ln, rounds):
    return [ln.train_round(ids, batch, mask) for ids, batch, mask in rounds]


def _run_async(ln, rounds):
    outs = []
    for r, (ids, batch, mask) in enumerate(rounds):
        nxt = rounds[r + 1][0] if r + 1 < len(rounds) else None
        outs.append(ln.finalize_round_metrics(ln.train_round_async(
            ids, batch, mask, next_client_ids=nxt)))
    ln.flush_offload()
    return outs


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_offload_pipeline_matches_jax_with_abort_and_padded_tail(depth):
    kw = dict(LOCAL, client_state_offload=True,
              offload_pipeline_depth=depth)
    jl, tl = _pair(**kw)
    rounds = _scenario(rounds=8, nan_round=4, shared=True)
    outs_j, outs_t = _run_async(jl, rounds), _run_async(tl, rounds)
    assert outs_t[4]["aborted"] and outs_t[-1]["aborted"]
    assert not outs_t[3]["aborted"]
    for got, ref in zip(outs_t[:4], outs_j[:4]):
        _assert_round(got, ref)
    for got, ref in zip(outs_t[4:], outs_j[4:]):
        assert got["aborted"] and ref["aborted"]
        assert got["upload_bytes"] == ref["upload_bytes"] == 0.0
    _assert_state(tl, jl)
    assert tl.total_upload_bytes == jl.total_upload_bytes
    assert tl.total_download_bytes == jl.total_download_bytes
    np.testing.assert_array_equal(tl.host_store.shard_writes,
                                  jl.host_store.shard_writes)
    for key in ("gathers", "prefetch_hits", "rows_from_pending",
                "flushed_rounds"):
        assert tl._offload_pipe.stats[key] == jl._offload_pipe.stats[key], \
            key


def test_sparse_offload_matches_jax_from_the_same_rows():
    """Both packages start from the same nonzero sparse rows (the
    reference's arenas after 3 rounds, bridged into the port's by
    ``host_store_from_arrays``), then run 3 more rounds of truncating
    sparse offload."""
    from commefficient_tpu_torch.utils.params import host_store_from_arrays
    kw = dict(LOCAL, client_state="sparse", client_state_offload=True,
              local_momentum=0.5)     # an exact rho, as above
    warm = _pair(**kw)[0]
    _run_sync(warm, _scenario(seed=3))
    jl, tl = _pair(**kw)
    host_store_from_arrays(tl.host_store, warm.host_clients)
    for field, view in warm.host_clients.items():
        for cid in range(N if view is not None else 0):
            jl.host_clients[field][cid] = jax.tree.map(np.array, view[cid])
    assert float(_dense_rows(tl, "errors").abs().sum()) > 0
    for ids, batch, mask in _scenario(seed=4):
        _assert_round(tl.train_round(ids, batch, mask),
                      jl.train_round(ids, batch, mask))
    _assert_state(tl, jl)


# --- the port against itself, bitwise --------------------------------------

def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_bitwise(la, lb, outs_a, outs_b):
    for a, b in zip(outs_a, outs_b):
        assert np.float32(a["loss"]).tobytes() == np.float32(
            b["loss"]).tobytes() or (np.isnan(a["loss"])
                                     and np.isnan(b["loss"]))
        for key in ("download_bytes", "upload_bytes", "aborted"):
            assert a[key] == b[key], key
    assert _same(la.state.weights, lb.state.weights)
    assert torch.equal(la.state.client_last_round,
                       lb.state.client_last_round)
    for field in ("velocities", "errors", "weights"):
        ra, rb = _dense_rows(la, field), _dense_rows(lb, field)
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert _same(ra, rb), field


OFFLOAD = {
    "local_topk": LOCAL,
    "topk_down": dict(mode="local_topk", error_type="local", k=20,
                      do_topk_down=True),
    "true_topk_vel": dict(mode="true_topk", error_type="virtual",
                          virtual_momentum=0.9, local_momentum=0.9, k=20),
    "sparse": dict(LOCAL, client_state="sparse"),
    "sketched": dict(mode="local_topk", error_type="local", k=20,
                     client_state="sketched", client_sketch_cols=32),
}


@pytest.mark.parametrize("name", list(OFFLOAD))
def test_offload_is_bitwise_device_resident(name):
    params = _params()[1]
    dev = _port(params, **OFFLOAD[name])
    off = _port(params, client_state_offload=True, **OFFLOAD[name])
    assert off.state.clients.errors is None and off._offload
    rounds = _scenario(rounds=8, nan_round=5, shared=True)
    _assert_bitwise(dev, off, _run_sync(dev, rounds), _run_async(off, rounds))


def test_dense_offload_is_bitwise_sparse_offload_at_half_d():
    params = _params()[1]
    kw = dict(LOCAL, k=89, client_state_offload=True)      # k = d / 2
    dense, sparse = _port(params, **kw), _port(params, client_state="sparse",
                                               **kw)
    assert 2 * sparse.codec.cap >= sparse.cfg.grad_dim
    rounds = _scenario(rounds=6, shared=True)
    _assert_bitwise(dense, sparse, _run_async(dense, rounds),
                    _run_async(sparse, rounds))
    # the arena holds (k,) pairs a row, not (d,) rows
    assert sparse.host_store.nbytes() == 2 * N * 89 * 4 * 2


@pytest.mark.parametrize("kw", [
    dict(mode="true_topk", error_type="virtual", virtual_momentum=0.9,
         k=20),
    LOCAL,
    dict(mode="uncompressed", virtual_momentum=0.9),
    dict(mode="fedavg", local_batch_size=-1, num_fedavg_epochs=2,
         fedavg_batch_size=2)], ids=["true_topk", "local_topk",
                                     "uncompressed", "fedavg"])
def test_bucketed_dense_modes_are_bitwise_unbucketed(kw):
    params = _params()[1]
    one, many = _port(params, **kw), _port(params, grad_buckets=5, **kw)
    assert one.grad_buckets is None and many.grad_buckets.num_buckets > 2
    rounds = _scenario(rounds=3)
    _assert_bitwise(one, many, _run_sync(one, rounds),
                    _run_sync(many, rounds))


def test_pipeline_reads_pending_rows_and_prefetches():
    ln = _port(_params()[1], client_state_offload=True, **LOCAL)
    rounds = _scenario(rounds=6, shared=True)
    _run_async(ln, rounds)
    stats = ln._offload_pipe.stats
    assert stats["rows_from_pending"] > 0
    assert stats["prefetch_hits"] == len(rounds) - 1
    assert stats["gathers"] == len(rounds)
    before = [ln.host_clients["errors"][i].clone() for i in range(N)]
    ln.flush_offload()                       # nothing pending: no-op
    for i in range(N):
        assert torch.equal(ln.host_clients["errors"][i], before[i])
    with pytest.raises(ValueError, match="offload_pipeline_depth"):
        _port(_params()[1], client_state_offload=True,
              offload_pipeline_depth=0, **LOCAL)
    with pytest.raises(ValueError, match="takes the clients' rows"):
        ln._round(ln.state, torch.zeros(W, dtype=torch.int32),
                  tuple(torch.from_numpy(c) for c in rounds[0][1]),
                  torch.ones(W, B), 0.1, 0)


def test_gpt2_cli_runs_sparse_offload(tmp_path):
    """The GPT2 entry point with the example's single-card flags
    (``--mode local_topk --error_type local --client_state sparse
    --client_state_offload``) on a gpt2-tiny: the arenas hold k pairs a
    row, and the upload is k floats a client."""
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    args = build_gpt2_parser().parse_args([
        "--model", "gpt2-tiny", "--max_seq_len", "32", "--mode",
        "local_topk", "--error_type", "local", "--local_momentum", "0.9",
        "--client_state", "sparse", "--client_state_offload", "--k", "500",
        "--num_epochs", "1", "--dataset_dir", str(tmp_path),
        "--synthetic_personas", "6", "--synthetic_dialogs", "2",
        "--device", "cpu"])
    learner, row = train(args, max_rounds=2, log=False)
    assert len(row["rounds"]) == 2
    assert all(np.isfinite(r["loss"]) and r["upload_bytes"] == 2 * 4 * 500
               for r in row["rounds"])
    assert learner.host_store.nbytes() == 2 * 6 * 500 * 8
    assert learner._offload_pipe.stats["flushed_rounds"] == 2
    assert not learner._offload_pipe._pending
    assert np.isfinite(row["nll"])
