"""The serving stack of the port against the JAX package's, on the CPU:
``ops/attention`` decode and paged attention (float32 within 1e-5 of the
largest output), ``ops/kv_quant`` (bitwise), the KV-cached GPT2 forward
(logits within 2e-5 of the largest), ``DecodeEngine.generate`` (greedy
tokens identical), ``PagedKVCache`` (tables, refcounts and free list
identical after one admit/advance/truncate/release sequence), the
continuous-batching server's replies and ``stats()`` (identical, for the
dense, paged, disaggregated and greedy-speculative servers; the int8
and int4 servers agree with float32 as the reference's do),
``PersonalizationIndex`` (admit bitwise the reference's, evict bitwise
base) and the full-recompute ``sample_reply``.

One gpt2-tiny model, its weights from the reference's ``init`` carried
across by ``params_from_jax``; inputs from seeded numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.data.tokenizer import ByteTokenizer
from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.ops import attention as jatt
from commefficient_tpu.ops import kv_quant as jkvq
from commefficient_tpu.serving import ContinuousBatchingServer as JServer
from commefficient_tpu.serving import DecodeEngine as JEngine
from commefficient_tpu.serving import PagedKVCache as JPaged
from commefficient_tpu_torch.data.persona import build_input_from_segments
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.gpt2_generate import (
    sample_reply, sample_reply_cached)
from commefficient_tpu_torch.ops import attention as tatt
from commefficient_tpu_torch.ops import kv_quant as tkvq
from commefficient_tpu_torch.serving import (ContinuousBatchingServer,
                                             DecodeEngine, PagedKVCache,
                                             PersonalizationIndex,
                                             personalization_from_checkpoint,
                                             speculation_from_checkpoint)
from commefficient_tpu_torch.utils.params import params_from_jax

MAX_LEN = 48
PREFILL = 16


def _jax_params(model, seed):
    ids = np.zeros((1, 1, 8), np.int32)
    return model.init(jax.random.PRNGKey(seed), ids, ids,
                      np.zeros((1, 1), np.int32), train=False)["params"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    # tiny tensors: the suite's workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    tok = ByteTokenizer()
    eos = tok.convert_tokens_to_ids("<eos>")
    jmodel = JModel(JConfig.tiny(vocab_size=tok.vocab_size))
    jparams = _jax_params(jmodel, 0)
    tmodel = GPT2DoubleHeads(GPT2Config.tiny(vocab_size=tok.vocab_size))
    tparams = params_from_jax(jparams)
    jeng = JEngine(jmodel, jparams, eos_id=eos, max_len=MAX_LEN)
    teng = DecodeEngine(tmodel, tparams, eos_id=eos, max_len=MAX_LEN)
    rng = np.random.RandomState(0)
    s1, s2 = (tok.convert_tokens_to_ids(t)
              for t in ("<speaker1>", "<speaker2>"))
    prompts = [(rng.randint(0, 256, L).tolist(),
                rng.choice([s1, s2], L).tolist())
               for L in (5, 9, 12, 3, 16, 7)]
    return dict(tok=tok, eos=eos, jmodel=jmodel, jparams=jparams,
                tmodel=tmodel, tparams=tparams, jeng=jeng, teng=teng,
                prompts=prompts, reply_type=s2)


def _close(a, b, rel):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


# ---- attention -----------------------------------------------------------


@pytest.mark.parametrize("tq", [1, 3])
def test_decode_attention_matches_reference(tq):
    rng = np.random.RandomState(1)
    B, S, H, D = 3, 20, 4, 16
    q = rng.randn(B, tq, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    pos = np.array([0, 7, S - tq], np.int32)
    ref = jatt.decode_attention(q, k, v, jnp.asarray(pos))
    got = tatt.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                torch.from_numpy(pos))
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_paged_attention_matches_reference(mode):
    rng = np.random.RandomState(2)
    B, Tq, H, D, N, P, M = 3, 2, 4, 16, 9, 4, 3
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    kf = rng.randn(N, P, H, D).astype(np.float32)
    vf = rng.randn(N, P, H, D).astype(np.float32)
    pt = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0]], np.int32)
    pos = np.array([5, 10, 2], np.int32)
    kw, tkw = {}, {}
    k, v = kf, vf
    if mode != "none":
        k, ks = (np.array(a) for a in jkvq.quantize_pages(kf, mode))
        v, vs = (np.array(a) for a in jkvq.quantize_pages(vf, mode))
        kw = dict(k_scale=ks, v_scale=vs)
        tkw = {n: torch.from_numpy(a) for n, a in kw.items()}
    ref = jatt.paged_verify_attention(q, k, v, pt, pos, **kw)
    got = tatt.paged_verify_attention(
        *(torch.from_numpy(x) for x in (q, k, v, pt, pos)), **tkw)
    _close(got.numpy(), ref, 1e-5)
    if Tq == 1:
        return
    one = tatt.paged_decode_attention(
        *(torch.from_numpy(x) for x in (q[:, :1], k, v, pt, pos)), **tkw)
    _close(one.numpy(), np.asarray(ref)[:, :1], 1e-5)


# ---- kv_quant -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_kv_quant_bitwise(mode):
    rng = np.random.RandomState(3)
    x = (rng.randn(5, 4, 3, 8) * rng.rand(5, 1, 3, 1)).astype(np.float32)
    x[2] = 0.0                                    # an all-zero page
    jq, js = (np.array(a) for a in jkvq.quantize_pages(x, mode))
    tq, ts = tkvq.quantize_pages(torch.from_numpy(x), mode)
    assert np.array_equal(tq.numpy(), jq) and tq.numpy().dtype == jq.dtype
    assert np.array_equal(ts.numpy(), js)
    deq = tkvq.dequantize_pages(tq, ts, mode).numpy()
    assert np.array_equal(deq, np.asarray(jkvq.dequantize_pages(jq, js,
                                                                mode)))
    assert not deq[2].any()
    if mode == "int4":
        n = rng.randint(-7, 8, (6, 8)).astype(np.int32)
        packed = tkvq._pack_int4(torch.from_numpy(n))
        assert np.array_equal(packed.numpy(),
                              np.asarray(jkvq._pack_int4(jnp.asarray(n))))
        assert np.array_equal(tkvq._unpack_int4(packed).numpy(), n)
    # requantize-on-write of a 3-token window into rows on distinct pages
    vals = rng.randn(2, 3, 3, 8).astype(np.float32)
    phys = np.array([[1, 1, 3], [4, 4, 4]], np.int32)
    off = np.array([[0, 1, 0], [1, 2, 3]], np.int32)
    jp, jsc = (np.asarray(a) for a in jkvq.insert_tokens(
        *(jnp.asarray(a) for a in (jq, js, vals, phys, off)), mode))
    tp, tsc = tkvq.insert_tokens(tq.clone(), ts.clone(),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(phys),
                                 torch.from_numpy(off), mode)
    assert np.array_equal(tp.numpy(), jp) and np.array_equal(tsc.numpy(),
                                                             jsc)
    args = (33, 16, 12, 64, 12)
    for m in ("none", mode):
        assert tkvq.pool_bytes(*args, m) == jkvq.pool_bytes(*args, m)
        assert tkvq.capacity_multiplier_vs_f32(*args, m) == \
            jkvq.capacity_multiplier_vs_f32(*args, m)
    assert tkvq.infer_mode(tq, 8) == mode
    assert tkvq.packed_head_dim(8, mode) == jkvq.packed_head_dim(8, mode)
    with pytest.raises(ValueError, match="kv_quant must be one of"):
        tkvq.validate_mode("fp8")


# ---- the cached forward and the engine --------------------------------


def _padded(prompts, P):
    ids = np.zeros((len(prompts), P), np.int32)
    types = np.zeros((len(prompts), P), np.int32)
    last = np.zeros((len(prompts),), np.int32)
    for i, (a, b) in enumerate(prompts):
        ids[i, :len(a)], types[i, :len(a)], last[i] = a, b, len(a) - 1
    return ids, types, last


def test_prefill_and_decode_logits_match_reference(pair):
    jeng, teng = pair["jeng"], pair["teng"]
    ids, types, last = _padded(pair["prompts"], PREFILL)
    B = ids.shape[0]
    jl, jc = jeng.prefill(pair["jparams"], jeng.init_cache(B), ids, types,
                          last)
    tc = teng.init_cache(B)
    tl, tc = teng.prefill(pair["tparams"], tc, torch.from_numpy(ids),
                          torch.from_numpy(types), torch.from_numpy(last))
    _close(tl.numpy(), jl, 2e-5)
    for layer in range(2):
        _close(tc[layer]["k"].numpy(), jc[layer]["k"], 2e-5)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    typ = np.full((B,), pair["reply_type"], np.int32)
    pos = last + 1
    done = np.zeros((B,), bool)
    jout = jeng.step(pair["jparams"], jc, tok, typ, pos,
                     jax.random.PRNGKey(0), done)
    tout = teng.step(pair["tparams"], tc, *(torch.from_numpy(x) for x in (
        tok, typ, pos)), teng.new_generator(0), torch.from_numpy(done))
    assert np.array_equal(tout[1].numpy(), np.asarray(jout[1]))
    assert np.array_equal(tout[2].numpy(), np.asarray(jout[2]))
    for layer in range(2):
        _close(tout[0][layer]["v"].numpy(), jout[0][layer]["v"], 2e-5)


def test_generate_tokens_identical_to_reference(pair):
    prompts = pair["prompts"]
    types = [pair["reply_type"]] * len(prompts)
    ref = pair["jeng"].generate(prompts, types, max_new=20)
    got = pair["teng"].generate(prompts, types, max_new=20)
    assert got == ref
    assert any(len(r) > 1 for r in got)
    # one request alone decodes as it does in the batch
    assert pair["teng"].generate(prompts[2:3], types[:1],
                                 max_new=20) == got[2:3]


def test_sample_reply_full_recompute_matches_cached(pair):
    tok = pair["tok"]
    persona = [tok.encode("i like tea."), tok.encode("my cat is old.")]
    history = [tok.encode("hello there"), tok.encode("what do you do?")]
    from commefficient_tpu.models.gpt2_generate import \
        sample_reply as jsample
    ref = jsample(pair["jmodel"], pair["jparams"], tok, persona, history,
                  max_seq_len=96, max_reply_len=12)
    full = sample_reply(pair["tmodel"], pair["tparams"], tok, persona,
                        history, max_seq_len=96, max_reply_len=12)
    cached = sample_reply_cached(pair["tmodel"], pair["tparams"], tok,
                                 persona, history, max_seq_len=96,
                                 max_reply_len=12)
    assert full == ref == cached
    inst = build_input_from_segments(persona, history, [], tok,
                                     with_eos=False)
    assert len(inst["input_ids"]) + len(full) <= 96
    drawn = sample_reply(pair["tmodel"], pair["tparams"], tok, persona,
                         history, max_seq_len=64, max_reply_len=6,
                         method="topk", seed=1)
    assert len(drawn) <= 6 and all(0 <= t < tok.vocab_size for t in drawn)


# ---- the page table -----------------------------------------------------


def test_paged_cache_tables_identical_to_reference():
    kw = dict(slots=3, max_len=32, prefill_len=16, page_size=4,
              num_pages=14)
    caches = (JPaged(**kw), PagedKVCache(**kw))
    shared = list(range(10))
    log = []
    for c in caches:
        out = [c.admit(0, shared, [1] * 10).tolist(),
               c.admit(1, shared + [5, 6], [1] * 12).tolist(),
               c.admit(2, [9] * 7, [2] * 7, shareable=False).tolist()]
        for _ in range(6):
            for s in range(3):
                c.ensure_frontier(s)
                c.advance(s)
        c.ensure_range(1, int(c.pos[1]) + 5)
        c.truncate(1, int(c.pos[1]) + 1)
        c.release(0)
        out.append(c.admit(0, shared, [1] * 10).tolist())
        c.release(2)
        log.append((out, c.table.tolist(), c.pos.tolist(),
                    c.refcount.tolist(), list(c._free), c.shared_hits,
                    c.pages_in_use))
    assert log[0] == log[1]
    t = caches[1].device_table()
    assert t.dtype == torch.int32 and t.tolist() == caches[1].table.tolist()
    # exhausting the pool raises, as in the reference
    small = PagedKVCache(slots=2, max_len=16, prefill_len=16, page_size=4,
                         num_pages=5)
    small.admit(0, list(range(16)), [1] * 16, shareable=False)
    with pytest.raises(RuntimeError, match="exhausted"):
        small.admit(1, list(range(16)), [1] * 16, shareable=False)


# ---- the server ---------------------------------------------------------

SERVERS = {
    "fixed": dict(kv_cache="fixed"),
    "paged": dict(kv_cache="paged", page_size=4),
    "paged_disagg": dict(kv_cache="paged", page_size=4, disaggregate=True),
    "fixed_spec": dict(kv_cache="fixed", speculate_k=3),
    "paged_spec": dict(kv_cache="paged", page_size=4, speculate_k=2),
    "paged_spec_drafter": dict(kv_cache="paged", page_size=4,
                               speculate_k=2, drafter=True),
}


def _serve(server_cls, engine, stream, kw):
    srv = server_cls(engine, slots=3, prefill_len=PREFILL, **kw)
    rids = [srv.submit(ids, types, rt, mx) for ids, types, rt, mx in stream]
    replies = srv.run()
    return [replies[r] for r in rids], srv


@pytest.mark.parametrize("name", list(SERVERS))
def test_server_replies_and_stats_match_reference(pair, name):
    kw = dict(SERVERS[name])
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("drafter", False):
        # a 2-layer drafter of its own random weights
        dcfg = JConfig.tiny(vocab_size=pair["tok"].vocab_size)
        dmodel = JModel(dcfg)
        dparams = _jax_params(dmodel, 1)
        jkw = dict(kw, drafter_model=dmodel, drafter_params=dparams)
        tkw = dict(kw, drafter_model=GPT2DoubleHeads(GPT2Config.tiny(
            vocab_size=pair["tok"].vocab_size)),
            drafter_params=params_from_jax(dparams))
    rt = pair["reply_type"]
    stream = [(ids, types, rt, mx) for (ids, types), mx in
              zip(pair["prompts"] * 2, [10, 3, 14, 1, 8, 12] * 2)]
    ref, jsrv = _serve(JServer, pair["jeng"], stream, jkw)
    got, tsrv = _serve(ContinuousBatchingServer, pair["teng"], stream, tkw)
    assert got == ref
    assert tsrv.stats() == jsrv.stats()
    solo = pair["teng"].generate([stream[0][:2]], [rt], max_new=10)
    assert got[0] == solo[0]
    if tsrv.pager is not None:
        assert tsrv.pager.pages_in_use == 0
    if name == "paged_spec":
        assert tsrv.stats()["acceptance_rate"] == 1.0
    if name == "paged_spec_drafter":
        st = tsrv.stats()
        assert 0 < st["accepted"] < st["drafted"]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_server_agrees_with_float_and_reference_stats(pair, mode):
    """The reference's contract (tests/test_serving_kv_quant.py): at tiny
    scale the int8 and int4 greedy streams agree with float32 on at least
    90% of the tokens, and the pools hold 3x / 7x the users. Quantized
    replies are not held to the reference's token for token: a value on a
    rounding edge may quantize to the neighbouring level on either side."""
    rt = pair["reply_type"]
    budgets = [8, 3, 6, 5, 2, 7]
    stream = [(ids, types, rt, mx)
              for (ids, types), mx in zip(pair["prompts"], budgets)]
    kw = dict(kv_cache="paged", page_size=8)
    f32, _ = _serve(ContinuousBatchingServer, pair["teng"], stream, kw)
    got, srv = _serve(ContinuousBatchingServer, pair["teng"], stream,
                      dict(kw, kv_quant=mode))
    same = sum(a == b for x, y in zip(got, f32) for a, b in zip(x, y))
    total = sum(len(r) for r in f32)
    assert same / total >= 0.9, (mode, same, total)
    _, jsrv = _serve(JServer, pair["jeng"], stream, dict(kw, kv_quant=mode))
    st = srv.stats()
    assert st == jsrv.stats()
    assert st["kv_capacity_multiplier_vs_f32"] >= (3 if mode == "int8"
                                                    else 7)
    assert srv.pager.pages_in_use == 0


def test_stochastic_speculation_self_drafts(pair):
    eng = DecodeEngine(pair["tmodel"], pair["tparams"], eos_id=pair["eos"],
                       max_len=MAX_LEN, method="topk")
    rt = pair["reply_type"]
    stream = [(ids, types, rt, 8) for ids, types in pair["prompts"]]
    replies, srv = _serve(ContinuousBatchingServer, eng, stream,
                          dict(kv_cache="paged", page_size=4,
                               speculate_k=2))
    assert srv.spec.stochastic
    assert srv.stats()["acceptance_rate"] > 0.95
    assert all(len(r) <= 8 for r in replies)
    assert srv.pager.pages_in_use == 0
    with pytest.raises(ValueError, match="speculate_k must be >= 1"):
        ContinuousBatchingServer(eng, slots=2, prefill_len=PREFILL,
                                 speculate_k=-1)


def test_checkpoint_gates_warn_and_degrade():
    cfg = GPT2Config.tiny()
    with pytest.warns(UserWarning, match="no drafter record"):
        assert speculation_from_checkpoint({}, cfg, speculate_k=3) == 0
    from commefficient_tpu_torch.serving.speculative import \
        drafter_fingerprint
    assert speculation_from_checkpoint(
        {"drafter": drafter_fingerprint(cfg)}, cfg, speculate_k=3) == 3
    with pytest.warns(UserWarning, match="unpersonalized"):
        assert personalization_from_checkpoint({}, None, {}) is None
    with pytest.raises(ValueError, match="client_state sparse"):
        personalization_from_checkpoint({"client_state": "dense"}, None, {})


# ---- personalization -----------------------------------------------------


def _stores(pair, num_shards, seed=4, users=(1, 2)):
    """The reference's and the port's sparse ``HostArenaStore`` over the
    tiny model's d, with the same seeded rows for ``users``."""
    from commefficient_tpu.config import FedConfig as JFed
    from commefficient_tpu.federated.client_store import HostArenaStore \
        as JStore
    from commefficient_tpu.federated.client_store import make_codec \
        as jcodec
    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.client_store import (
        HostArenaStore, make_codec)
    d = sum(int(np.prod(np.shape(x)))
            for x in jax.tree_util.tree_leaves(pair["jparams"]))
    kw = dict(mode="local_topk", error_type="local", client_state="sparse",
              num_clients=4, k=64)
    jcfg = JFed(**kw).finalize(d)
    tcfg = FedConfig(**kw).finalize(d)
    jstore = JStore(jcfg, jcodec(jcfg), num_shards=num_shards)
    tstore = HostArenaStore(tcfg, make_codec(tcfg), num_shards=num_shards)
    rng = np.random.RandomState(seed)
    for cid in users:
        idx = rng.choice(d, 64, replace=False).astype(np.int32)
        row = {"idx": idx, "val": rng.randn(64).astype(np.float32)}
        jstore.set_row("errors", cid, row)
        tstore.set_row("errors", cid, row)
    return jstore, tstore


def test_sharded_personalized_server_matches_reference(pair):
    """Owner-affine admission over a store of 2 shards: users 0-1 on
    shard 0, 2-3 on shard 1, anonymous requests spilling anywhere; the
    replies (each user decoded under base + its delta) and the routing
    counters equal the reference's, and base comes back bitwise."""
    from commefficient_tpu.serving import PersonalizationIndex as JIndex
    jstore, tstore = _stores(pair, 2, users=(0, 1, 2, 3))
    rt = pair["reply_type"]
    users = [0, 2, None, 3, 1, None, 2, 0]
    stream = [(ids, types, rt, 6, u) for (ids, types), u in
              zip(pair["prompts"] + pair["prompts"][:2], users)]
    out = []
    for server_cls, eng, index in (
            (JServer, pair["jeng"], JIndex(pair["jparams"], jstore)),
            (ContinuousBatchingServer, pair["teng"],
             PersonalizationIndex(pair["tparams"], tstore))):
        srv = server_cls(eng, slots=4, prefill_len=PREFILL,
                         kv_cache="paged", page_size=4, personalize=index)
        rids = [srv.submit(ids, types, r, mx, user_id=u)
                for ids, types, r, mx, u in stream]
        replies = srv.run()
        out.append(([replies[r] for r in rids], srv.stats(), eng.params))
    (ref, jst, _), (got, tst, params) = out
    assert got == ref
    assert tst == jst
    assert tst["num_shards"] == 2 and sum(tst["spilled_per_shard"]) > 0
    assert all(torch.equal(params[n], pair["tparams"][n])
               for n in pair["tparams"])


def test_personalize_admit_matches_reference_and_evict_restores(pair):
    from commefficient_tpu.serving import PersonalizationIndex as JIndex
    jstore, tstore = _stores(pair, 1)
    base = pair["tparams"]
    jidx = JIndex(pair["jparams"], jstore, scale=0.5)
    tidx = PersonalizationIndex(base, tstore, scale=0.5)
    jp = jidx.admit(pair["jparams"], 1)
    tp = tidx.admit(base, 1)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert all(torch.equal(tp[n], want[n]) for n in want)
    assert sum(not torch.equal(tp[n], base[n]) for n in base) > 1
    tp = tidx.admit(tp, 2)
    tp = tidx.evict(tp, 1)
    tp = tidx.evict(tp, 2)
    assert all(torch.equal(tp[n], base[n]) for n in base)
    assert tidx.admit(base, 0) is base          # an all-zero row
    with pytest.raises(KeyError):
        tidx.evict(base, 3)
