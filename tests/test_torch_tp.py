"""A12's ``model`` axis on ``torch.distributed`` against the reference's
GSPMD tensor parallelism, on the CPU.

One module-scoped launch of 4 gloo ranks (``tools/mesh_cases.py`` on a
``make_mesh(4, model=2)`` mesh: two client shards of a 2-way model axis)
runs every multi-rank case on gpt2-tiny (``n_head`` 4, ``n_embd`` 128, 2
layers, T 16; the reference's ``tests/test_mesh.py:87-112`` problem, its
initial weights from the reference's learner) and writes each rank's
arrays; each test reads them:

* (a) ``gpt2_tp_specs`` leaf for leaf against the reference's, and the
  head-sliced qkv shards joining back into the kernel;
* (b) one worker's loss and flat gradient on the model axis against
  tp = 1 within 1e-6 of the largest entry, at dropout 0 and with
  ``tpu_bits`` dropout (the head-sharded sites draw the unsharded bits),
  for both attention forms; the flash plain versions' head map;
* (c) ``uncompressed`` and ``sketch``, 3 rounds, against the reference's
  ``make_mesh(4, model=2)`` round at rtol 2e-4 / atol 2e-5: the pads
  exactly 0, each rank storing only its coordinate block, the whole
  replicated state bitwise equal on all 4 ranks every round;
* (d) ``true_topk``, ``local_topk`` and ``fedavg`` against the port's
  one-process round at the same tolerance;
* (e) a 2-D checkpoint loaded across the packages both ways;
* (f) the fixed, paged, personalized and speculative servers at tp = 2
  token-identical to the reference's tp = 1 engine
  (``__graft_entry__.py:339-420``'s prompts and budgets), int8 and int4
  pools at C16's contract;
* (g) the refusals and the reference's ValueErrors (offload and the
  buffered server run on the model axis since A12 1b:
  ``tests/test_torch_tp_1b.py``; MoE blocks since A12's expert slice);
* (h) the GPT2 entry point's ``--mesh clients=2,model=2 --moe_experts 4``
  round at capacity factor 1.25 (each MoE block whole on every model
  rank, routed over the clients axis) against the reference's
  ``make_mesh(4, model=2)`` round from the same initial weights, at
  (c)'s tolerances, the ranks bitwise every round.

Every rank and the test process run one intra-op thread.
"""

import os

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_gpt2_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.parallel import make_mesh as jax_make_mesh
from commefficient_tpu.parallel.tp import gpt2_tp_specs as jax_tp_specs
from commefficient_tpu.utils import checkpoint as jax_ckpt
from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.ops import flash_attention as fa
from commefficient_tpu_torch.parallel import tp as tp_lib
from commefficient_tpu_torch.tools import mesh_cases as mc
from commefficient_tpu_torch.utils.params import flax_path, params_from_jax

RANKS, MODEL = 4, 2
MESH_TOL = dict(rtol=2e-4, atol=2e-5)
TP_CASES = ("tp_grad", "tp_modes", "tp_ckpt", "tp_serve", "tp_cli",
            "tp_moe")
#: the reference's byte tokenizer (the CLI's vocab without a local cache)
BYTE_VOCAB = 261
SEED = 21
JAX_MODES = ("uncompressed", "sketch")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Wrap:
    """The reference's ``_gpt2_fed_problem`` module wrapper."""

    def __init__(self, model):
        self.model = model

    def init(self, rng, sample_in, train):
        return self.model.init(rng, *sample_in, train=train)

    def apply(self, *a, **k):
        return self.model.apply(*a, **k)


@pytest.fixture(scope="module")
def jax_problem():
    gcfg = JConfig.tiny()
    gcfg.n_positions = mc.TP_T
    model = JModel(gcfg)
    batch, mask = mc.tp_problem()
    batch = tuple(c.astype(np.int32) for c in batch)
    ids, mc_ids, _, _, types = batch
    sample_in = (ids[0][:1], types[0][:1], mc_ids[0][:1])
    return _Wrap(model), jax_gpt2_loss(model), sample_in, batch, mask


def _jax_learner(jax_problem, mode_kw, mesh=None, cls=JaxLearner, **kw):
    wrap, loss, sample_in, _, _ = jax_problem
    cfg = JaxConfig(num_workers=mc.TP_W, num_clients=mc.TP_CLIENTS,
                    lr_scale=0.05, weight_decay=0, max_seq_len=mc.TP_T,
                    **mode_kw)
    specs = None
    if mesh is not None:
        probe = JaxLearner(wrap, JaxConfig(
            num_workers=mc.TP_W, num_clients=mc.TP_CLIENTS,
            max_seq_len=mc.TP_T), loss, None, jax.random.PRNGKey(0),
            sample_in)
        specs = jax_tp_specs(probe.unflatten(probe.state.weights))
    return cls(wrap, cfg, loss, None, jax.random.PRNGKey(0), sample_in,
               mesh=mesh, param_specs=specs, **kw)


def _jax_rounds(jl, jax_problem, rounds):
    _, _, _, batch, mask = jax_problem
    return np.asarray([[float(m[k]) for k in mc.ROUND_KEYS] for m in (
        jl.train_round(np.arange(mc.TP_W), batch, mask)
        for _ in range(rounds))])


@pytest.fixture(scope="module")
def jparams(jax_problem):
    jl = _jax_learner(jax_problem, mc.TP_MODES["uncompressed"])
    return jax.device_get(jl.unflatten(jl.state.weights))


def _serve_jparams():
    from commefficient_tpu.data.tokenizer import ByteTokenizer
    model = JModel(JConfig.tiny(vocab_size=ByteTokenizer().vocab_size))
    ids = np.zeros((1, 1, 8), np.int32)
    params = model.init(jax.random.PRNGKey(4), ids, ids,
                        np.zeros((1, 1), np.int32), train=False)["params"]
    return model, params


def _ref_moe_cli_init():
    """The reference GPT2 entry point's initial weights for the MoE
    problem (gpt2-tiny with 4 experts on the byte tokenizer, ``--seed``),
    as port arrays."""
    cfg = JConfig.tiny(vocab_size=BYTE_VOCAB)
    cfg.moe_experts = mc.MOE_EXPERTS
    ids = np.zeros((1, 2, mc.SEQ_T), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    params = JModel(cfg).init(init_rng, ids, ids, np.zeros((1, 2), np.int32),
                              train=False)["params"]
    return {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(params)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_problem, jparams):
    """The launch: every tensor-parallel case on 4 ranks (2 x 2)."""
    out = str(tmp_path_factory.mktemp("tp"))
    init = {k: v.numpy() for k, v in params_from_jax(jparams).items()}
    np.savez(os.path.join(out, "tp_init.npz"), **init)
    _, sparams = _serve_jparams()
    np.savez(os.path.join(out, "serve_init.npz"), **{
        k: v.numpy() for k, v in params_from_jax(
            jax.device_get(sparams)).items()})
    # the reference's 2-D file, for the port's mesh to load
    jl = _jax_learner(jax_problem, mc.TP_CKPT_KW, jax_make_mesh(4, model=2))
    _jax_rounds(jl, jax_problem, 2)
    fn = jax_ckpt.save_checkpoint(os.path.join(out, "ref"), jl, "ref")
    os.replace(fn, os.path.join(out, "ref_tp_ckpt.npz"))
    np.savez(os.path.join(out, "moe_cli_init.npz"), **_ref_moe_cli_init())
    mc.launch(out, TP_CASES, ranks=RANKS, model=MODEL)
    return {"dir": out, "init": init,
            "ref_ckpt_weights": np.asarray(jl.state.weights)}


def _load(runs, case, rank=0):
    return dict(np.load(os.path.join(runs["dir"], f"{case}_rank{rank}.npz")))


# --------------------------------------------------------------------------
# (a) the layout
# --------------------------------------------------------------------------


def test_specs_match_reference_leaf_for_leaf(jparams):
    tparams = params_from_jax(jparams)
    got = tp_lib.gpt2_tp_specs(tparams)
    ref = jax_tp_specs(jparams)
    assert set(got) == set(tparams)
    for name, spec in got.items():
        node = ref
        for key in flax_path(name):
            node = node[key]
        assert spec == tuple(node), name
    assert sum(s != () for s in got.values()) == 4 * 2


def test_qkv_head_slices_round_trip(jparams):
    """Each rank's qkv piece is its heads' columns of q, k and v (flax
    (in, out) columns [h0 hd, h1 hd) of each third); the pieces of every
    rank join back into every cut leaf."""
    tparams = params_from_jax(jparams)
    H, C = 4, 128
    hd = C // H
    layout = tp_lib.TPLayout({n: tuple(t.shape) for n, t in tparams.items()},
                             H, MODEL)
    name = "Block_0.CausalSelfAttention_0.Dense_0.weight"
    kernel = np.asarray(jparams["Block_0"]["CausalSelfAttention_0"]
                        ["Dense_0"]["kernel"])
    for m in range(MODEL):
        piece = tp_lib.shard_params_tp(tparams, m, MODEL, H)[name].numpy().T
        h0, h1 = m * H // MODEL, (m + 1) * H // MODEL
        want = np.concatenate([kernel[:, t * C + h0 * hd:t * C + h1 * hd]
                               for t in range(3)], axis=1)
        np.testing.assert_array_equal(piece, want)
    for name in layout.cuts:
        full = torch.zeros_like(tparams[name])
        for m in range(MODEL):
            piece = layout.shard(tparams, m)[name]
            full.index_copy_(tp_lib.cut_dim(layout.cuts[name]),
                             layout.index(name, m), piece)
        assert torch.equal(full, tparams[name]), name


# --------------------------------------------------------------------------
# (b) the forward and gradient at tp = 2
# --------------------------------------------------------------------------


@pytest.mark.parametrize("attn,rate", mc.TP_GRAD_CONFIGS)
def test_tp_gradient_equals_tp1(runs, attn, rate):
    one = mc.case_tp_grad(None, "cpu", runs["init"])
    tag = f"{attn}_{rate}"
    want = one[f"{tag}/grad"]
    for r in range(RANKS):
        got = _load(runs, "tp_grad", r)
        assert abs(float(got[f"{tag}/loss"]) - float(one[f"{tag}/loss"])) \
            <= 1e-6 * abs(float(one[f"{tag}/loss"]))
        np.testing.assert_allclose(got[f"{tag}/grad"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_head_offset_rows_equal_unsharded(rate):
    """The flash plain versions with a head map: a slice of heads [h0,
    h0 + 2) of 4 gives the unsharded call's rows of those heads, bitwise,
    forward and backward (the dropout bits are the global heads')."""
    rng = np.random.RandomState(3)
    B, H, T, D = 2, 4, 40, 16
    q, k, v, do = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32))
                   for _ in range(4))
    seed = 77
    full = fa.flash_attention(*(x.requires_grad_(True) for x in (q, k, v)),
                              dropout_rate=rate, dropout_seed=seed,
                              block_q=16, block_k=16)
    gq, gk, gv = torch.autograd.grad(full, (q, k, v), do)
    for h0 in (0, 2):
        sl = slice(h0, h0 + 2)
        qs, ks, vs = (x.detach()[:, :, sl].clone().requires_grad_(True)
                      for x in (q, k, v))
        part = fa.flash_attention(qs, ks, vs, dropout_rate=rate,
                                  dropout_seed=seed, block_q=16, block_k=16,
                                  head_offset=h0, num_heads=H)
        assert torch.equal(part, full.detach()[:, :, sl])
        for g, want in zip(torch.autograd.grad(part, (qs, ks, vs),
                                               do[:, :, sl]),
                           (gq, gk, gv)):
            assert torch.equal(g, want[:, :, sl])
    keep = fa.dropout_keep_reference((5, 9), B * 2, T, dropout_rate=0.5,
                                     block_q=16, block_k=16, heads=(2, 2, 4))
    whole = fa.dropout_keep_reference((5, 9), B * H, T, dropout_rate=0.5,
                                      block_q=16, block_k=16)
    assert torch.equal(keep, whole.view(B, H, *whole.shape[1:])[:, 2:]
                       .reshape(keep.shape))


# --------------------------------------------------------------------------
# (c), (d) the rounds
# --------------------------------------------------------------------------


_ONE = {}


def _one_process(runs, mode):
    if mode not in _ONE:
        ln = mc.tp_build(mc.TP_MODES[mode], None, "cpu", runs["init"])
        _ONE[mode] = mc.tp_rounds(ln, mc.ROUNDS)
    return _ONE[mode]


@pytest.mark.parametrize("mode", list(mc.TP_MODES))
def test_tp_modes_store_blocks_and_agree_across_ranks(runs, mode):
    recs = [_load(runs, "tp_modes", r) for r in range(RANKS)]
    held = recs[0][f"{mode}/held"]
    d, d_pad = int(held[3]), int(held[4])
    assert d_pad == d + (d % 2) and d_pad % MODEL == 0
    # each rank stores its coordinate block only
    assert held[0] == held[1] == d_pad // MODEL
    if mode != "sketch":
        assert held[2] == d_pad // MODEL
    if mode == "local_topk":
        # (2 clients + the sink, d_pad / 2) rows a rank
        assert recs[0][f"{mode}/rows_shape"].tolist() == [3, d_pad // MODEL]
    for rec in recs:
        np.testing.assert_array_equal(rec[f"{mode}/digests"],
                                      recs[0][f"{mode}/digests"])
        np.testing.assert_array_equal(rec[f"{mode}/metrics"],
                                      recs[0][f"{mode}/metrics"])
        assert np.all(rec[f"{mode}/weights"][d:] == 0.0)


@pytest.mark.parametrize("mode", JAX_MODES)
def test_tp_round_matches_reference_2d_mesh(runs, jax_problem, mode):
    jl = _jax_learner(jax_problem, mc.TP_MODES[mode],
                      jax_make_mesh(4, model=2))
    ref = _jax_rounds(jl, jax_problem, mc.ROUNDS)
    got = _load(runs, "tp_modes")
    m = got[f"{mode}/metrics"]
    # loss and download bytes at the mesh tolerance: a coordinate whose
    # round-1 gradient is exactly 0 in XLA's sums and not in torch's (or
    # the reverse) moves the count by one, unsharded too
    np.testing.assert_allclose(m[:, :2], ref[:, :2], **MESH_TOL)
    np.testing.assert_array_equal(m[:, 2:], ref[:, 2:])
    w_ref = np.asarray(jl.state.weights)
    assert w_ref.shape == got[f"{mode}/weights"].shape
    np.testing.assert_allclose(got[f"{mode}/weights"], w_ref, **MESH_TOL)


@pytest.mark.parametrize("mode", ["true_topk", "local_topk", "fedavg"])
def test_tp_round_matches_one_process(runs, mode):
    one = _one_process(runs, mode)
    got = _load(runs, "tp_modes", 1)
    d = one["weights"].shape[0]
    m = got[f"{mode}/metrics"]
    np.testing.assert_allclose(m[:, 0], one["metrics"][:, 0], **MESH_TOL)
    np.testing.assert_array_equal(m[:, 1:], one["metrics"][:, 1:])
    np.testing.assert_allclose(got[f"{mode}/weights"][:d], one["weights"],
                               **MESH_TOL)
    np.testing.assert_allclose(got[f"{mode}/Vvelocity"][:d],
                               one["Vvelocity"], **MESH_TOL)


def test_gpt2_entry_point_train_on_the_2d_mesh(runs):
    """The GPT2 entry point's ``train`` on the 2 x 2 mesh: the rounds and
    the whole weights of one process at the mesh tolerance, the ranks
    bitwise each other."""
    one = mc.cli_rounds("gpt2", mc.cli_args("gpt2", runs["dir"],
                                            *mc.TP_CLI_ARGS), None, 2)
    recs = [_load(runs, "tp_cli", r) for r in range(RANKS)]
    for rec in recs:
        assert str(rec["gpt2/digest"]) == str(recs[0]["gpt2/digest"])
    got = recs[0]
    d = one["weights"].shape[0]
    np.testing.assert_allclose(got["gpt2/metrics"][:, :2],
                               one["metrics"][:, :2], **MESH_TOL)
    np.testing.assert_array_equal(got["gpt2/metrics"][:, 2:],
                                  one["metrics"][:, 2:])
    assert got["gpt2/weights"].shape == (d + d % 2,)
    np.testing.assert_allclose(got["gpt2/weights"][:d], one["weights"],
                               **MESH_TOL)


def test_gpt2_main_launches_clients_times_model_ranks(tmp_path, monkeypatch):
    """``--mesh clients=2,model=2`` makes ``main`` start 4 ranks of
    ``mesh_rank_main`` with a 2-way model axis."""
    from commefficient_tpu_torch.training import gpt2
    seen = []
    monkeypatch.setattr(gpt2.distributed, "run",
                        lambda target, n, args, **kw: seen.append(
                            (target, n, args[1:])))
    assert gpt2.main(["--device", "cpu", "--mesh", "clients=2,model=2",
                      "--model", "gpt2-tiny", "--dataset_dir",
                      str(tmp_path)]) == 0
    assert seen == [(gpt2.mesh_rank_main, 4, (4, 2))]


# --------------------------------------------------------------------------
# (e) the 2-D checkpoint across the packages
# --------------------------------------------------------------------------


def test_tp_checkpoint_loads_across_packages(runs, jax_problem):
    got = _load(runs, "tp_ckpt", 3)
    # the reference's 2-D file on the port's mesh
    np.testing.assert_array_equal(got["loaded/weights"],
                                  runs["ref_ckpt_weights"])
    assert got["loaded/held"].tolist() == [got["loaded/weights"].size
                                           // MODEL]
    # the port's file on the reference's 2-D mesh
    jl = _jax_learner(jax_problem, mc.TP_CKPT_KW, jax_make_mesh(4, model=2))
    jax_ckpt.load_checkpoint(os.path.join(runs["dir"], "tp_ckpt", "tp.npz"),
                             jl)
    np.testing.assert_array_equal(np.asarray(jl.state.weights),
                                  got["saved/weights"])
    np.testing.assert_array_equal(np.asarray(jl.state.opt.Vvelocity),
                                  got["saved/Vvelocity"])
    assert int(jl.state.round_idx) == int(got["saved/round_idx"]) == 2


# --------------------------------------------------------------------------
# (f) tensor-parallel serving
# --------------------------------------------------------------------------


def _ref_replies(mode):
    """The reference's tp = 1 run of ``__graft_entry__`` part 10."""
    from commefficient_tpu.data.tokenizer import ByteTokenizer
    from commefficient_tpu.federated.client_store import (HostArenaStore,
                                                          make_codec)
    from commefficient_tpu.serving import (ContinuousBatchingServer,
                                           DecodeEngine,
                                           PersonalizationIndex)
    from jax.flatten_util import ravel_pytree
    tok = ByteTokenizer()
    model, params = _serve_jparams()
    eng = DecodeEngine(model, params, eos_id=tok.convert_tokens_to_ids(
        "<eos>"), max_len=48, method="greedy")
    kw = {}
    if mode != "fixed":
        kw.update(kv_cache="paged", page_size=8)
    if mode == "personalized":
        flat, _ = ravel_pytree(params)
        cfg = JaxConfig(mode="local_topk", error_type="local",
                        client_state="sparse", k=4,
                        num_clients=4).finalize(flat.shape[0])
        kw["personalize"] = PersonalizationIndex(
            eng.params, HostArenaStore(cfg, make_codec(cfg), num_shards=2))
    if mode == "speculative":
        kw["speculate_k"] = 2
    srv = ContinuousBatchingServer(eng, slots=2, prefill_len=32, **kw)
    prompts = [(tok.encode(t), [1] * len(tok.encode(t)))
               for t in mc.SERVE_TEXTS]
    rids = [srv.submit(i, t, reply_type=1, max_new=3 + n,
                       user_id=(n if mode == "personalized" else None))
            for n, (i, t) in enumerate(prompts)]
    replies = srv.run()
    return [replies[r] for r in rids]


def _tp_replies(rec, mode):
    return [[int(t) for t in row if t >= 0] for row in rec[f"{mode}/replies"]]


@pytest.mark.parametrize("mode", ["fixed", "paged", "personalized",
                                  "speculative"])
def test_tp_serving_token_identical_to_reference_tp1(runs, mode):
    want = _ref_replies(mode)
    for r in range(RANKS):
        rec = _load(runs, "tp_serve", r)
        assert int(rec[f"{mode}/tp"]) == MODEL
        assert _tp_replies(rec, mode) == want


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_tp_quantized_pools_meet_the_float_stream(runs, quant):
    """C16: a quantized server agrees with the float32 stream on at least
    90% of tokens; a rank's pools are half the model's."""
    rec = _load(runs, "tp_serve")
    ref = [t for row in _tp_replies(rec, "paged") for t in row]
    got = [t for row in _tp_replies(rec, quant) for t in row]
    n = max(len(ref), len(got))
    agree = sum(a == b for a, b in zip(ref, got)) / n
    assert agree >= 0.9, (quant, agree)
    total, per_rank = rec[f"{quant}/pool_bytes"].tolist()
    assert per_rank * MODEL == total


# --------------------------------------------------------------------------
# (g) the refusals and the reference's ValueErrors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(serve_tp=2),
    dict(serve_tp=2, mesh_shape=(1, 4), mesh_axis_names=("clients",
                                                         "model")),
    dict(serve_tp=2, mesh_shape=(1, 2), mesh_axis_names=("clients",
                                                         "model"),
         kv_quant="int8", model_checkpoint="gpt2-xl")])
def test_serve_tp_value_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref:
        JaxConfig(**kw).finalize(1000)
    with pytest.raises(ValueError) as got:
        FedConfig(**kw).finalize(1000)
    assert str(got.value) == str(ref.value)
    ok = dict(serve_tp=2, mesh_shape=(1, 2),
              mesh_axis_names=("clients", "model"))
    assert FedConfig(**ok).finalize(1000).serve_tp == 2


@pytest.mark.parametrize("kw", [
    dict(mode="local_topk", error_type="local", client_state_offload=True),
    dict(server_mode="buffered")])
def test_model_axis_offload_and_buffered_are_a12_1b(kw):
    """Both run on a model axis since A12 1b (``tests/test_torch_tp_1b.py``
    holds their rounds against the reference): the config takes them, with
    the model axis and without."""
    mesh = dict(mesh_shape=(2, 2), mesh_axis_names=("clients", "model"))
    assert FedConfig(**kw, **mesh).finalize(1000).model_axis == 2
    assert FedConfig(**kw).finalize(1000).model_axis == 1


@pytest.mark.parametrize("extra,exc,match", [
    pytest.param(["--client_state_offload", "--mode", "local_topk",
                  "--error_type", "local"], None, None,
                 id="extra0-NotImplementedError-A12 1b"),
    pytest.param(["--server_mode", "buffered"], None, None,
                 id="extra1-NotImplementedError-A12 1b"),
    pytest.param(["--moe_experts", "2"], None, None,
                 id="extra2-NotImplementedError-A12, the expert axis")])
def test_gpt2_cli_model_axis_refusals(tmp_path, monkeypatch, extra, exc,
                                      match):
    """Offloaded rows and the buffered server run on a model axis since
    A12 1b, MoE blocks since A12's expert slice: ``main`` launches the 2
    ranks of ``mesh_rank_main`` (their rounds: ``tests/test_torch_tp_1b.py``
    and (h) above)."""
    from commefficient_tpu_torch.training import gpt2
    argv = ["--device", "cpu", "--model", "gpt2-tiny", "--mesh",
            "clients=1,model=2", "--dataset_dir", str(tmp_path), *extra]
    gpt2.build_gpt2_parser().parse_args(argv)
    if exc is not None:
        with pytest.raises(exc, match=match):
            gpt2.main(argv)
        return
    seen = []
    monkeypatch.setattr(gpt2.distributed, "run",
                        lambda target, n, args, **kw: seen.append(
                            (target, n, args[1:])))
    assert gpt2.main(argv) == 0
    assert seen == [(gpt2.mesh_rank_main, 2, (2, 2))]


def test_cv_model_axis_keeps_reference_valueerror(tmp_path):
    from commefficient_tpu_torch.training import cv
    from commefficient_tpu_torch.training.args import build_parser
    args = build_parser().parse_args([
        "--device", "cpu", "--mesh", "clients=2,model=2", "--dataset_dir",
        str(tmp_path)])
    with pytest.raises(ValueError, match="CV models have no TP layout"):
        cv.train(args, max_rounds=1, log=False)


class _Dim:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


class _FakeMesh:
    mesh_dim_names = ("model",)

    def __getitem__(self, axis):
        return _Dim(3)


def test_engine_and_model_refuse_what_does_not_shard():
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.serving import DecodeEngine
    model = GPT2DoubleHeads(GPT2Config.tiny())
    params = dict(model.named_parameters())
    with pytest.raises(ValueError, match="n_head 4 must be divisible by "
                                         "the 'model' mesh axis size 3"):
        DecodeEngine(model, params, eos_id=0, max_len=16, mesh=_FakeMesh())
    # MoE blocks run on a model axis since A12's expert slice: every MoE
    # leaf stays whole in the compute layout
    cfg = GPT2Config.tiny()
    cfg.moe_experts = 2
    moe = GPT2DoubleHeads(cfg)
    tp_lib.attach(moe, tp_lib.TPContext(group=None, rank=0, size=2))
    assert moe.config.tp.size == 2
    layout = tp_lib.TPLayout({n: tuple(p.shape)
                              for n, p in moe.named_parameters()}, 4, 2)
    assert not [n for n in layout.cuts if ".moe." in n]
    assert len(layout.cuts) == 2 * 3
    ring = GPT2Config.tiny()
    ring.attn_impl = "ring"
    z = torch.zeros((1, 1, 4), dtype=torch.int32)
    # ring attention runs on a seq axis since A12's seq axis; outside one
    # it raises a ValueError naming the seq mesh
    with pytest.raises(ValueError, match="seq mesh axis"):
        GPT2DoubleHeads(ring)(z, z, torch.zeros((1, 1), dtype=torch.int32),
                              train=False)


def test_kv_specs_shard_heads_and_keep_the_page_table():
    cache = ({"k": torch.zeros(5, 4, 6, 8), "v": torch.zeros(5, 4, 6, 8),
              "k_scale": torch.zeros(5, 6), "v_scale": torch.zeros(5, 6),
              "pt": torch.zeros(2, 3, dtype=torch.int32)},)
    specs = tp_lib.kv_cache_specs(cache)
    assert specs == ({"k": (None, None, "model"), "v": (None, None, "model"),
                      "k_scale": (None, "model"),
                      "v_scale": (None, "model"), "pt": ()},)


# --------------------------------------------------------------------------
# (h) MoE blocks on the model axis
# --------------------------------------------------------------------------


def _ref_model_moe_round(tmp_path_factory, mode, capacity):
    """The reference's ``--mesh clients=2,model=2`` MoE round of the
    problem: (rounds' metrics, final weights, validation nll)."""
    from commefficient_tpu.training.args import parse_mesh as jax_parse
    from commefficient_tpu.training.args import \
        round_up_workers_for_mesh as jax_round_up
    from commefficient_tpu.training.gpt2 import build_gpt2_parser, train
    rounds = []
    saved = JaxLearner.finalize_round_metrics

    def recording(self, raw):
        out = saved(self, raw)
        rounds.append([float(out[k]) for k in mc.ROUND_KEYS])
        return out
    JaxLearner.finalize_round_metrics = recording
    try:
        args = build_gpt2_parser().parse_args(mc.moe_cli_argv(
            mode, capacity, str(tmp_path_factory.mktemp("ref_moe")))
            + ["--mesh", "clients=2,model=2"])
        mesh = jax_parse(args.mesh)
        jax_round_up(args, mesh)
        np.random.seed(args.seed)
        learner, row = train(args, mesh=mesh, max_rounds=mc.MOE_CLI_ROUNDS,
                             log=False)
    finally:
        JaxLearner.finalize_round_metrics = saved
    return (np.asarray(rounds), np.asarray(learner.state.weights),
            float(row["nll"]))


def test_moe_round_on_the_model_axis_matches_reference(runs,
                                                       tmp_path_factory):
    recs = [_load(runs, "tp_moe", r) for r in range(RANKS)]
    for rec in recs:
        for key in ("digests", "weights", "metrics"):
            np.testing.assert_array_equal(rec[key], recs[0][key])
    rounds, w_ref, nll_ref = _ref_model_moe_round(tmp_path_factory,
                                                  *mc.TP_MOE_RUN)
    got = recs[0]
    np.testing.assert_allclose(got["metrics"][:, :2], rounds[:, :2],
                               **MESH_TOL)
    np.testing.assert_array_equal(got["metrics"][:, 2:], rounds[:, 2:])
    assert got["weights"].shape == w_ref.shape
    np.testing.assert_allclose(got["weights"], w_ref, **MESH_TOL)
    assert float(got["nll"]) == pytest.approx(nll_ref, abs=1e-3)
