"""The client-state and transmit layers of the port against the JAX
reference on the CPU, piece by piece:

* ``--client_k_dist``: ``parse_k_dist`` (values and error messages),
  ``client_k_for`` and ``cohort_client_ks``, bitwise;
* ``make_grad_buckets``: the same plans over several leaf-size lists at
  ``align`` 1 and 128, the degenerate ``None`` cases and the plan's own
  validation messages;
* the global CountSketch: hashes, ``sketch_range`` at offsets, the
  batched ``sketch_rows``, ``sketch_sparse``, estimates, ``unsketch`` and
  ``unsketch_values_indices`` (fused and not), bitwise; estimates with
  denormal inputs held to a numpy median that keeps them (XLA's CPU
  min/max flush them, ROADMAP C7);
* the row codecs: sparse exact below its cap and truncating above it,
  with rows whose squares tie where their magnitudes do not (the encode
  ranks by |x|); sketched tables and decodes; ``make_codec``; gather,
  scatter and ``select_rows`` with the sink row;
* ``HostArenaStore``: owner routing, row views, per-shard read and write
  counters and ``nbytes`` equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated import client_store as jax_store
from commefficient_tpu.federated import faults as jax_faults
from commefficient_tpu.federated.state import GradBuckets as JaxBuckets
from commefficient_tpu.federated.state import \
    make_grad_buckets as jax_make_buckets
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client_store as store
from commefficient_tpu_torch.federated import faults
from commefficient_tpu_torch.federated.state import (GradBuckets,
                                                     make_grad_buckets)
from commefficient_tpu_torch.ops.countsketch import CountSketch


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# --- --client_k_dist ------------------------------------------------------

@pytest.mark.parametrize("seed,spec,k", [(21, "uniform:0.25,1.0", 50_000),
                                         (7, "uniform:0.5,0.5", 1_000),
                                         (2 ** 40 + 3, "uniform:0.01,1", 3)])
def test_cohort_client_ks_bitwise(seed, spec, k):
    ids = np.array([0, 5, 99, 5, 1_000_003, 17], np.int64)
    memo, jmemo = {}, {}
    got = faults.cohort_client_ks(seed, ids, k, spec, memo=memo)
    ref = jax_faults.cohort_client_ks(seed, ids, k, spec, memo=jmemo)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert memo == jmemo
    # a chronic per-client draw: any order, with or without the memo
    assert faults.client_k_for(seed, 99, k, spec) == got[2]
    np.testing.assert_array_equal(
        faults.cohort_client_ks(seed, ids[::-1], k, spec), got[::-1])
    assert faults.parse_k_dist(spec) == jax_faults.parse_k_dist(spec)


@pytest.mark.parametrize("spec", ["normal:0.1,1", "uniform:0.5", "uniform:a,b",
                                  "uniform:0,1", "uniform:0.9,0.1", ""])
def test_parse_k_dist_errors_match_jax(spec):
    with pytest.raises(ValueError) as ref:
        jax_faults.parse_k_dist(spec)
    with pytest.raises(ValueError) as got:
        faults.parse_k_dist(spec)
    assert str(got.value) == str(ref.value)


def test_config_checks_k_dist_at_validate():
    with pytest.raises(ValueError, match="only mode='local_topk'"):
        FedConfig(mode="sketch", client_k_dist="uniform:0.5,1").validate()
    with pytest.raises(ValueError, match="lo <= hi"):
        FedConfig(mode="local_topk", client_k_dist="uniform:0.9,0.1"
                  ).validate()


# --- --grad_buckets ---------------------------------------------------------

LEAF_LISTS = [
    [64, 8, 256, 16, 1000, 10],          # uneven leaves
    [6_000] * 7 + [3],                    # equal blocks, a tiny tail
    [10_000, 1, 1, 1, 1, 1],              # one dominant leaf
    [128] * 40,                           # cuts already aligned
]


@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("num_buckets", [2, 4, 7])
@pytest.mark.parametrize("leaves", range(len(LEAF_LISTS)))
def test_make_grad_buckets_matches_jax(leaves, num_buckets, align):
    sizes = LEAF_LISTS[leaves]
    d = sum(sizes)
    got = make_grad_buckets(sizes, d, num_buckets, align=align)
    ref = jax_make_buckets(sizes, d, num_buckets, align=align)
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.offsets, got.sizes) == (ref.offsets, ref.sizes)
        assert got.num_buckets == ref.num_buckets
        assert sum(got.sizes) == d
        if align > 1:
            assert all(o % align == 0 for o in got.offsets)


@pytest.mark.parametrize("sizes,d,k,align", [
    ([10, 20], 30, 1, 1),          # K = 1: the unbucketed round
    ([100], 100, 4, 1),            # one leaf: no interior cut
    ([50, 50], 100, 2, 128),       # d <= align
    ([10, 200], 210, 2, 128),      # the only cut snaps to 0
])
def test_make_grad_buckets_degenerates_to_none(sizes, d, k, align):
    assert jax_make_buckets(sizes, d, k, align=align) is None
    assert make_grad_buckets(sizes, d, k, align=align) is None


@pytest.mark.parametrize("offsets,sizes", [((), ()), ((1,), (5,)),
                                           ((0, 4), (3, 3)),
                                           ((0, 3), (3, 0))])
def test_grad_buckets_validation_matches_jax(offsets, sizes):
    with pytest.raises(ValueError) as ref:
        JaxBuckets(offsets=offsets, sizes=sizes)
    with pytest.raises(ValueError) as got:
        GradBuckets(offsets=offsets, sizes=sizes)
    assert str(got.value) == str(ref.value)


# --- the global CountSketch -----------------------------------------------

def _global_pair(d=3_000, c=211, r=3, seed=5):
    return (CountSketch(d=d, c=c, r=r, seed=seed, scheme="global"),
            JaxCS(d=d, c=c, r=r, seed=seed, scheme="global"))


def test_global_geometry_and_hashes():
    t, j = _global_pair(d=70_000, c=500, r=5)
    assert t.c_eff == j.c_eff == 500
    with pytest.raises(ValueError, match="no windows"):
        t.kernel_tables("cpu")
    idx = np.random.RandomState(0).randint(0, 70_000, 4_000)
    for row in range(5):
        ts, tb = t._row_hashes(row, torch.from_numpy(idx))
        js, jb = j._row_hashes(row, jnp.asarray(idx, jnp.int32))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    ts, tb = t._row_hashes(None, torch.from_numpy(idx))
    assert ts.shape == tb.shape == (5, 4_000)


@pytest.mark.parametrize("offset,n", [(0, 3_000), (1, 2_000), (129, 77),
                                      (2_999, 1)])
def test_global_sketch_range_at_offsets_bitwise(offset, n):
    t, j = _global_pair()
    x = np.random.RandomState(offset).randn(n).astype(np.float32)
    x[1::7] = 0.0
    x[3::11] = -0.0
    got = t.sketch_range(torch.from_numpy(x), offset)
    ref = j.sketch_range(jnp.asarray(x), offset)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_global_sketch_of_one_signed_zero():
    """A bucket's sum starts at +0.0, so a lone -0.0 contribution leaves
    +0.0, as XLA's segment_sum gives op by op and at every length >= 2.
    Jitted at a length of 1, XLA rewrites the one-element scatter-add
    and returns the -0.0 itself (ROADMAP C11): the one known difference."""
    t, j = _global_pair()
    x = np.asarray([-0.0], np.float32)
    got = t.sketch_range(torch.from_numpy(x), 5).numpy()
    assert not np.signbit(got).any()
    eager = jax.ops.segment_sum(jnp.asarray(x), jnp.zeros(1, jnp.int32),
                                num_segments=2)
    assert not np.signbit(np.asarray(eager)).any()
    jitted = np.asarray(j.sketch_range(jnp.asarray(x), 5))
    assert np.signbit(jitted).any()
    np.testing.assert_array_equal(np.abs(jitted), got)


def test_global_sketch_rows_and_buckets_add_up():
    """A batch of rows is each row's own table; per-bucket tables at their
    offsets add up to the whole (the bucketed global transmit)."""
    t, j = _global_pair()
    xs = np.random.RandomState(1).randn(4, 3_000).astype(np.float32)
    tabs = t.sketch_rows(torch.from_numpy(xs))
    for row, x in zip(tabs, xs):
        np.testing.assert_array_equal(_bits(row),
                                      _bits(j.sketch_vec(jnp.asarray(x))))
    whole = np.asarray(j.sketch_vec(jnp.asarray(xs[0])))
    parts = sum(t.sketch_range(torch.from_numpy(xs[0, o:o + n]), o).numpy()
                for o, n in ((0, 1_000), (1_000, 1_500), (2_500, 500)))
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-5)


def test_global_sketch_sparse_estimates_unsketch_bitwise():
    t, j = _global_pair(d=5_000, c=97, r=3)
    rng = np.random.RandomState(3)
    idx = rng.choice(5_000, 300, replace=False)
    val = rng.randn(300).astype(np.float32)
    got = t.sketch_sparse(torch.from_numpy(val), torch.from_numpy(idx))
    ref = j.sketch_sparse(jnp.asarray(val), jnp.asarray(idx))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    table = rng.randn(3, 97).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(t.estimates(torch.from_numpy(table))),
        _bits(j.estimates(jnp.asarray(table))))
    np.testing.assert_array_equal(
        _bits(t.estimates_rows(torch.from_numpy(np.stack([table, -table])))
              [1]), _bits(j.estimates(jnp.asarray(-table))))
    for k in (1, 40, 600):
        np.testing.assert_array_equal(
            _bits(t.unsketch(torch.from_numpy(table), k)),
            _bits(j.unsketch(jnp.asarray(table), k)))
        jv, ji = j.unsketch_values_indices(jnp.asarray(table), k)
        for fused in (True, False):
            tv, ti = t.unsketch_values_indices(torch.from_numpy(table), k,
                                               fused=fused)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(_bits(tv), _bits(jv))


def test_global_estimates_keep_denormals():
    """ROADMAP C7: the port's median keeps denormal inputs, as the card
    does; XLA's CPU min/max flush them, so JAX is held only on the
    coordinates whose three inputs are all normal or zero."""
    t, j = _global_pair(d=2_000, c=64, r=3)
    rng = np.random.RandomState(4)
    table = rng.randn(3, 64).astype(np.float32)
    table[:, ::5] = np.float32(3e-41) * rng.randint(1, 9, (3, 13))
    got = t.estimates(torch.from_numpy(table)).numpy()
    signs, buckets = (a.numpy() for a in
                      t._row_hashes(None, torch.arange(2_000)))
    rows = np.stack([table[row][buckets[row]] * signs[row]
                     for row in range(3)])
    a, b, c = rows
    want = np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (np.abs(got[got != 0]) < 1e-37).any()
    tiny = (np.abs(rows) < 1.2e-38) & (rows != 0)
    normal = ~tiny.any(axis=0)
    ref = np.asarray(j.estimates(jnp.asarray(table)))
    np.testing.assert_array_equal(_bits(got[normal]), _bits(ref[normal]))


# --- the row codecs --------------------------------------------------------

def _jax_enc(enc):
    return {k: np.asarray(v) for k, v in enc.items()}


def _assert_enc_equal(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].numpy().dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy().view(np.int32),
                                      ref[key].view(np.int32), err_msg=key)


def _sparse_rows(rng, W, d, nnz):
    rows = np.zeros((W, d), np.float32)
    for w in range(W):
        at = rng.choice(d, nnz, replace=False)
        rows[w, at] = rng.randn(nnz).astype(np.float32)
    rows[0, :3] = -0.0       # signed zeros keep their sign
    return rows


@pytest.mark.parametrize("nnz", [0, 5, 30])
def test_sparse_codec_exact_below_cap(nnz):
    rows = _sparse_rows(np.random.RandomState(nnz), 3, 200, nnz)
    got = store.SparseCodec(200, cap=40).encode_rows(torch.from_numpy(rows))
    ref = _jax_enc(jax_store.SparseCodec(200, cap=40).encode_rows(
        jnp.asarray(rows)))
    _assert_enc_equal(got, ref)
    back = store.SparseCodec(200, cap=40).decode_rows(got)
    np.testing.assert_array_equal(_bits(back), _bits(rows))


def test_sparse_codec_truncates_by_magnitude_not_square():
    """Squares that tie (or underflow to 0) where the magnitudes differ:
    the encode keeps the larger |x| as ``lax.top_k(|x|)`` does, and the
    decode is bitwise the reference's."""
    d = 64
    rows = np.zeros((2, d), np.float32)
    rows[0, [3, 9, 20, 40]] = [1e-23, -1.3e-23, 1.6e-23, 5e-24]  # x*x == 0
    rows[0, [50, 51]] = [1.0, -1.0]                           # true tie
    rows[1] = np.random.RandomState(2).randn(d).astype(np.float32)
    sq = torch.from_numpy(rows[0]) ** 2
    assert float(sq[3]) == float(sq[9]) == float(sq[20]) == 0.0 == float(
        sq[40])
    codec, jcodec = store.SparseCodec(d, cap=4), jax_store.SparseCodec(d,
                                                                       cap=4)
    got = codec.encode_rows(torch.from_numpy(rows))
    ref = _jax_enc(jcodec.encode_rows(jnp.asarray(rows)))
    _assert_enc_equal(got, ref)
    assert got["idx"][0].tolist() == [50, 51, 20, 9]
    np.testing.assert_array_equal(
        _bits(codec.decode_rows(got)),
        _bits(jcodec.decode_rows({k: jnp.asarray(v)
                                  for k, v in ref.items()})))
    # the reference's host codec (np.argsort on -|x|) keeps the same pairs
    host = jcodec.encode_row_np(rows[1])
    np.testing.assert_array_equal(got["idx"][1].numpy(), host["idx"])


def test_sketched_codec_tables_and_decode_bitwise():
    d, k = 4_000, 50
    rng = np.random.RandomState(6)
    rows = rng.randn(3, d).astype(np.float32)
    rows[1, rng.choice(d, 20, replace=False)] *= 100.0   # heavy hitters
    codec = store.SketchedCodec(d, r=3, c=128, k=k, seed=21)
    jcodec = jax_store.SketchedCodec(d, r=3, c=128, k=k, seed=21)
    assert codec.cs.seed == jcodec.cs.seed == 21 ^ 0xC11E57
    got = codec.encode_rows(torch.from_numpy(rows))
    ref = _jax_enc(jcodec.encode_rows(jnp.asarray(rows)))
    _assert_enc_equal(got, ref)
    # a (3, 128) table gives few distinct estimates: the top-k is decided
    # mostly by the lower-index tie rule
    dec = codec.decode_rows(got)
    jdec = jcodec.decode_rows({"table": jnp.asarray(ref["table"])})
    np.testing.assert_array_equal(_bits(dec), _bits(jdec))
    assert int((dec != 0).sum(dim=1).max()) <= k
    assert codec.row_floats() == jcodec.row_floats() == 3 * 128


@pytest.mark.parametrize("rep,kw,cls", [
    ("dense", dict(mode="local_topk", error_type="local"), "DenseCodec"),
    ("sparse", dict(mode="local_topk", error_type="local"), "SparseCodec"),
    ("sketched", dict(mode="local_topk", error_type="local",
                      client_sketch_rows=2, client_sketch_cols=16),
     "SketchedCodec")])
def test_make_codec_dispatch(rep, kw, cls):
    cfg = FedConfig(client_state=rep, k=7, **kw).finalize(300)
    jcfg = JaxConfig(client_state=rep, k=7, **kw).finalize(300)
    got, ref = store.make_codec(cfg), jax_store.make_codec(jcfg)
    assert type(got).__name__ == type(ref).__name__ == cls
    assert got.name == ref.name == rep
    assert got.row_floats() == ref.row_floats()


@pytest.mark.parametrize("rep", ["dense", "sparse", "sketched"])
def test_gather_scatter_select_rows_with_sink(rep):
    n, d, k = 6, 300, 12
    kw = dict(mode="local_topk", error_type="local", k=k, num_clients=n,
              client_state=rep)
    cfg = FedConfig(**kw).finalize(d)
    jcfg = JaxConfig(**kw).finalize(d)
    codec, jcodec = store.make_codec(cfg), jax_store.make_codec(jcfg)
    storage = store.init_client_storage(cfg, codec, torch.zeros(d)).errors
    jstorage = jax_store.init_client_storage(jcfg, jcodec,
                                             jnp.zeros(d)).errors
    rng = np.random.RandomState(8)
    rows = _sparse_rows(rng, 3, d, 10)
    # slot 1 is padded or guarded: it writes the sink (JAX drops it)
    ids = np.array([4, n, 0])
    storage = store.scatter_rows(storage, torch.from_numpy(ids),
                                 torch.from_numpy(rows), codec)
    jstorage = jax_store.scatter_rows(jstorage, jnp.asarray(ids),
                                      jnp.asarray(rows), jcodec)
    leaves = storage if isinstance(storage, dict) else {"": storage}
    jleaves = jstorage if isinstance(jstorage, dict) else {"": jstorage}
    for key in jleaves:
        np.testing.assert_array_equal(
            leaves[key][:n].numpy().view(np.int32),
            np.asarray(jleaves[key]).view(np.int32))
    got = store.gather_rows(storage, torch.tensor([0, 4, 2]), codec)
    ref = jax_store.gather_rows(jstorage, jnp.asarray([0, 4, 2]), jcodec)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert store.gather_rows(None, torch.tensor([0]), codec) is None
    assert store.scatter_rows(None, torch.tensor([0]), got, codec) is None
    # slot freeze on encodings: a frozen slot keeps its input bitwise
    old = codec.encode_rows(torch.from_numpy(rows))
    new = codec.encode_rows(torch.from_numpy(rows[::-1].copy()))
    keep = torch.tensor([True, False, True])
    sel = store.select_rows(keep, new, old)
    jsel = jax_store.select_rows(
        jnp.asarray(keep.numpy()),
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), new),
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), old))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), sel)),
                    jax.tree.leaves(jsel)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


def test_codecs_refuse_fill_and_config_rules():
    with pytest.raises(ValueError, match="cannot seed"):
        store.SparseCodec(10, cap=3).init_rows(2, fill=torch.ones(10))
    for bad, msg in ((dict(mode="true_topk", error_type="virtual",
                           client_state="sparse"), "keeps no k-sparse"),
                     (dict(mode="local_topk", error_type="none",
                           client_state="sketched"), "keeps no"),
                     (dict(mode="local_topk", error_type="local",
                           local_momentum=0.9, client_state="sketched"),
                      "local momentum"),
                     (dict(mode="local_topk", error_type="local",
                           client_state="sketched", client_sketch_cols=0),
                      "client_sketch_cols >= 1"),
                     (dict(mode="sketch", error_type="virtual",
                           grad_buckets=2, max_grad_norm=1.0),
                      "dense transmit"),
                     (dict(offload_pipeline_depth=0),
                      "offload_pipeline_depth")):
        with pytest.raises(ValueError) as ref:
            JaxConfig(**bad).validate()
        with pytest.raises(ValueError, match=msg) as got:
            FedConfig(**bad).validate()
        assert str(got.value) == str(ref.value)


# --- HostArenaStore --------------------------------------------------------

@pytest.mark.parametrize("rep,shards", [("dense", 1), ("sparse", 2),
                                        ("sketched", 3)])
def test_host_arena_store_routing_and_counters(rep, shards):
    n, d = 6, 200
    kw = dict(mode="local_topk", error_type="local", local_momentum=(
        0.9 if rep != "sketched" else 0.0), k=9, num_clients=n,
        client_state=rep, client_state_offload=True)
    cfg, jcfg = FedConfig(**kw).finalize(d), JaxConfig(**kw).finalize(d)
    got = store.HostArenaStore(cfg, store.make_codec(cfg), num_shards=shards)
    ref = jax_store.HostArenaStore(jcfg, jax_store.make_codec(jcfg),
                                   num_shards=shards)
    assert [got.owner(c) for c in range(n)] == [ref.owner(c)
                                                for c in range(n)]
    assert got.nbytes() == ref.nbytes()
    rng = np.random.RandomState(9)
    codec = store.make_codec(cfg)
    for field in ("velocities", "errors"):
        view, jview = got.view(field), ref.view(field)
        if jview is None:
            assert view is None
            continue
        assert len(view) == len(jview) == n
        for cid in (5, 0, 3, 5):
            enc = codec.encode_rows(torch.from_numpy(
                _sparse_rows(rng, 1, d, 7)))
            row = jax.tree.map(lambda t: t[0].numpy(), enc)
            view[cid] = row
            jview[cid] = row
        for cid in (5, 1):
            a, b = view[cid], jview[cid]
            for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, a)),
                            jax.tree.leaves(b)):
                np.testing.assert_array_equal(x, np.asarray(y))
        assert sum(1 for _ in view) == sum(1 for _ in jview) == n
    np.testing.assert_array_equal(got.shard_reads, ref.shard_reads)
    np.testing.assert_array_equal(got.shard_writes, ref.shard_writes)
    with pytest.raises(IndexError):
        got.row("errors", n)
    with pytest.raises(ValueError, match="divisible"):
        store.HostArenaStore(cfg, codec, num_shards=4)
