"""A12's ``seq`` axis on ``torch.distributed`` (ring attention, GPT2
sequence parallelism) against the reference's ``shard_map`` ring on the
CPU.

One module-scoped launch of 4 gloo ranks (``tools/mesh_cases.py`` on a
``make_mesh(4, seq=2)`` mesh: two client shards of a 2-way seq axis)
runs every multi-rank case; each test reads the ranks' arrays:

* ``ring_attention`` on the 4 ranks as one seq axis against the
  reference's ``ring_attention_sharded`` on its 4-device CPU mesh, causal
  and not and with a key mask, at 1e-5 (``tests/test_attention.py:
  44-63``); its gradient against the port's full attention;
* ``seq_parallel_apply`` of a ring gpt2-tiny against the reference's at
  1e-5, LM and MC logits (``tests/test_attention.py:89-115``);
* one worker's loss and flat gradient on ``clients=2,seq=2`` at dropout 0
  against the port's full attention with no mesh, within 1e-6 of the
  largest entry (the seq gradient is the unsharded one, not S times it),
  and ``seq_dp_lm_train_step``'s loss and gradient on both axes likewise;
* the GPT2 entry point's ``--mesh clients=2,seq=2 --attn_impl ring``
  round, uncompressed and sketch, against the reference's seq round of
  ``tests/test_cli_mesh.py:87-116``'s problem (its initial weights):
  weights at atol 2e-4, nll within 1e-3, every rank's state bitwise every
  round;
* the reference's ValueErrors (``tests/test_cli_mesh.py:118-147``) and
  the refusals that stay (stage, expert).

Every rank and the test process run one intra-op thread.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.ops.attention import \
    ring_attention_sharded as jax_ring
from commefficient_tpu.parallel.seq import \
    seq_parallel_apply as jax_seq_apply
from commefficient_tpu_torch.ops.attention import full_attention
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.tools import mesh_cases as mc
from commefficient_tpu_torch.training.args import (build_parser, parse_mesh,
                                                   resolve_fused_ce)
from commefficient_tpu_torch.utils.params import params_from_jax

RANKS, SEQ = 4, 2
CASES = ("seq_ring", "seq_apply", "seq_grad", "seq_cli")
#: the reference's byte tokenizer (the CLI's vocab without a local cache)
BYTE_VOCAB = 261
SEED = 21


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_seq_mesh():
    return Mesh(np.array(jax.devices()[:RANKS]), ("seq",))


@pytest.fixture(scope="module")
def apply_params():
    ids, types, mcp = (x.astype(np.int32) for x in mc.seq_apply_inputs())
    cfg = JConfig.tiny()
    cfg.n_positions = mc.SEQ_T
    return jax.device_get(JModel(cfg).init(
        jax.random.PRNGKey(0), ids, types, mcp, train=False)["params"])


def _ref_cli_init():
    """The reference GPT2 entry point's initial weights for the
    ``seq_cli`` problem (gpt2-tiny on the byte tokenizer, ``--seed``)."""
    cfg = JConfig.tiny(vocab_size=BYTE_VOCAB)
    ids = np.zeros((1, 2, mc.SEQ_T), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    return jax.device_get(JModel(cfg).init(
        init_rng, ids, ids, np.zeros((1, 2), np.int32),
        train=False)["params"])


def _npz(params):
    return {k: v.numpy() for k, v in params_from_jax(params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, apply_params):
    """The launch: the seq cases on 4 ranks (clients 2 x seq 2)."""
    out = str(tmp_path_factory.mktemp("seq"))
    np.savez(os.path.join(out, "seq_apply_init.npz"), **_npz(apply_params))
    np.savez(os.path.join(out, "seq_init.npz"), **_npz(_ref_cli_init()))
    mc.launch(out, CASES, ranks=RANKS, seq=SEQ)
    return {"dir": out, "recs": {c: [
        dict(np.load(os.path.join(out, f"{c}_rank{r}.npz")))
        for r in range(RANKS)] for c in CASES}}


# --------------------------------------------------------------------------
# ring attention and the sequence-parallel forward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal,masked", mc.RING_CASES)
def test_ring_attention_matches_reference(runs, causal, masked):
    q, k, v, g, km = mc.ring_inputs()
    ref = np.asarray(jax_ring(_jax_seq_mesh(), q, k, v, causal=causal,
                              kv_mask=km if masked else None))
    tag = f"ring/{int(causal)}{int(masked)}"
    for rec in runs["recs"]["seq_ring"]:
        np.testing.assert_allclose(rec[f"{tag}/out"], ref, rtol=1e-5,
                                   atol=1e-5)
    # the ring's backward (the cotangents sent back around the ring)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    full = full_attention(*leaves, causal=causal,
                          kv_mask=torch.from_numpy(km) if masked else None)
    want = torch.autograd.grad(full, leaves, torch.from_numpy(g))
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(runs["recs"]["seq_ring"][0][
            f"{tag}/d{name}"], w.numpy(), rtol=1e-5, atol=1e-5)


def test_seq_parallel_apply_matches_reference(runs, apply_params):
    ids, types, mcp = (x.astype(np.int32) for x in mc.seq_apply_inputs())
    cfg = JConfig.tiny()
    cfg.n_positions = mc.SEQ_T
    cfg.attn_impl = "ring"
    lm, mcl = jax_seq_apply(_jax_seq_mesh(), JModel(cfg), apply_params,
                            ids, types, mcp, train=False)
    for rec in runs["recs"]["seq_apply"]:
        np.testing.assert_allclose(rec["lm"], np.asarray(lm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["mc"], np.asarray(mcl), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the gradient and the round
# --------------------------------------------------------------------------


def test_seq_gradient_equals_unsharded(runs):
    one = mc.case_seq_grad(None, "cpu", None)
    want = one["grad"]
    for rec in runs["recs"]["seq_grad"]:
        assert abs(float(rec["loss"]) - float(one["loss"])) \
            <= 1e-6 * abs(float(one["loss"]))
        np.testing.assert_allclose(rec["grad"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        # seq_dp_lm_train_step: rows over clients, T over seq
        assert abs(float(rec["dp/loss"]) - float(one["dp/loss"])) \
            <= 1e-6 * abs(float(one["dp/loss"]))
        np.testing.assert_allclose(rec["dp/grad"], one["dp/grad"], rtol=0,
                                   atol=1e-6 * np.abs(one["dp/grad"]).max())


_REF_CLI = {}


def _ref_seq_round(tmp_path_factory, mode):
    """The reference's ``--mesh clients=2,seq=2`` ring round of the
    problem (its ``train``; rounds read through the learner)."""
    if mode in _REF_CLI:
        return _REF_CLI[mode]
    from commefficient_tpu.federated.api import FedLearner as JaxLearner
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
        args = build_gpt2_parser().parse_args(mc.seq_cli_argv(
            mode, str(tmp_path_factory.mktemp("ref_persona")))
            + ["--attn_impl", "ring", "--mesh", "clients=2,seq=2"])
        mesh = jax_parse(args.mesh)
        jax_round_up(args, mesh)
        np.random.seed(args.seed)
        learner, row = train(args, mesh=mesh, max_rounds=mc.SEQ_CLI_ROUNDS,
                             log=False)
    finally:
        JaxLearner.finalize_round_metrics = saved
    _REF_CLI[mode] = (np.asarray(rounds), np.asarray(learner.state.weights),
                      float(row["nll"]))
    return _REF_CLI[mode]


@pytest.mark.parametrize("mode", list(mc.SEQ_CLI_MODES))
def test_seq_round_matches_reference(runs, tmp_path_factory, mode):
    recs = runs["recs"]["seq_cli"]
    for rec in recs:
        assert len(rec[f"{mode}/digests"]) == mc.SEQ_CLI_ROUNDS
        np.testing.assert_array_equal(rec[f"{mode}/digests"],
                                      recs[0][f"{mode}/digests"])
        np.testing.assert_array_equal(rec[f"{mode}/weights"],
                                      recs[0][f"{mode}/weights"])
        np.testing.assert_array_equal(rec[f"{mode}/metrics"],
                                      recs[0][f"{mode}/metrics"])
    rounds, w_ref, nll_ref = _ref_seq_round(tmp_path_factory, mode)
    got = recs[0]
    # the loss and download bytes at the mesh tolerance: a coordinate
    # whose gradient is exactly 0 in XLA's sums and not in torch's moves
    # the download count (test_torch_tp.py), the rest exact
    np.testing.assert_allclose(got[f"{mode}/metrics"][:, :2], rounds[:, :2],
                               rtol=2e-4)
    np.testing.assert_array_equal(got[f"{mode}/metrics"][:, 2:],
                                  rounds[:, 2:])
    np.testing.assert_allclose(got[f"{mode}/weights"], w_ref, atol=2e-4)
    assert float(got[f"{mode}/nll"]) == pytest.approx(nll_ref, abs=1e-3)


# --------------------------------------------------------------------------
# the reference's ValueErrors and the refusals that stay
# --------------------------------------------------------------------------


def _gpt2_args(tmp_path, *extra):
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    return build_gpt2_parser().parse_args(
        ["--device", "cpu", "--max_seq_len", "32", "--dataset_name",
         "SyntheticPersona", "--dataset_dir", str(tmp_path), *extra])


def test_gpt2_seq_mesh_rejects_incompatible_modes(tmp_path):
    """The reference's message, word for word."""
    from commefficient_tpu.training.args import parse_mesh as jax_parse
    from commefficient_tpu.training.gpt2 import build_gpt2_parser as jp
    from commefficient_tpu.training.gpt2 import train as jax_train
    from commefficient_tpu_torch.training.gpt2 import train
    argv = ["--mode", "local_topk", "--error_type", "local", "--k", "10",
            "--local_momentum", "0.9", "--num_workers", "4",
            "--max_seq_len", "32", "--dataset_name", "SyntheticPersona"]
    with pytest.raises(ValueError, match="seq=2 requires the fused") as ref:
        jax_train(jp().parse_args(argv + ["--dataset_dir",
                                          str(tmp_path / "r")]),
                  mesh=jax_parse("clients=4,seq=2"), log=False)
    args = _gpt2_args(tmp_path / "p", *argv)
    with pytest.raises(ValueError) as got:
        train(args, mesh=parse_mesh("clients=4,seq=2"), log=False)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("extra,mesh,match", [
    (["--attn_impl", "ring"], "", "requires --mesh ...,seq=N>1"),
    (["--attn_impl", "blockwise"], "clients=2,seq=2",
     "blockwise cannot shard the sequence"),
    (["--max_seq_len", "30"], "clients=2,seq=4",
     "--max_seq_len 30 must be divisible by the seq axis"),
    (["--moe_experts", "2"], "clients=2,seq=2",
     "do not\ncollect|do not collect")])
def test_gpt2_seq_gate_value_errors(tmp_path, extra, mesh, match):
    from commefficient_tpu_torch.training.gpt2 import train
    args = _gpt2_args(tmp_path, *extra, *(["--mesh", mesh] if mesh else []))
    with pytest.raises(ValueError, match=match):
        train(args, mesh=parse_mesh(mesh), log=False)


def test_cv_cli_rejects_seq_axis(tmp_path):
    from commefficient_tpu_torch.training.cv import main
    with pytest.raises(ValueError, match="no sequence axis"):
        main(["--device", "cpu", "--test", "--mesh", "clients=4,seq=2",
              "--dataset_name", "Synthetic", "--dataset_dir",
              str(tmp_path)])


def test_gpt2_main_launches_clients_times_seq_ranks(tmp_path, monkeypatch):
    """``--mesh clients=2,seq=2`` makes ``main`` start 4 ranks of
    ``mesh_rank_main``, which build the seq axis from ``--mesh``."""
    from commefficient_tpu_torch.training import gpt2
    seen = []
    monkeypatch.setattr(gpt2.distributed, "run",
                        lambda target, n, args, **kw: seen.append(
                            (target, n, args[1:], args[0].mesh)))
    assert gpt2.main(["--device", "cpu", "--mesh", "clients=2,seq=2",
                      "--max_seq_len", "32", "--dataset_dir",
                      str(tmp_path)]) == 0
    assert seen == [(gpt2.mesh_rank_main, 4, (4, 1), "clients=2,seq=2")]


def test_make_mesh_keeps_the_other_inner_axes_refused(monkeypatch):
    """Two inner axes stay refused with the reference's ValueError;
    ``stage`` and ``expert`` build ``("clients", "stage")`` and
    ``("clients", "expert")`` meshes (here over a stand-in 4-rank group:
    rank 1 sits at (0, 1), its inner group ranks 0-1, its clients group
    ranks 1 and 3)."""
    with pytest.raises(ValueError, match="choose ONE inner axis"):
        mesh_lib.make_mesh(4, seq=2, model=2)
    dist = mesh_lib.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    mesh = mesh_lib.make_mesh(4, stage=2)
    assert mesh.mesh_dim_names == ("clients", "stage")
    assert mesh.shape == {"clients": 2, "stage": 2}
    assert (mesh_lib.stage_rank(mesh), mesh_lib.clients_rank(mesh)) == (1, 0)
    assert mesh_lib.stage_group(mesh) == (0, 1)
    assert mesh_lib.clients_group(mesh) == (1, 3)
    mesh = mesh_lib.make_mesh(4, expert=2)
    assert mesh.mesh_dim_names == ("clients", "expert")
    assert (mesh_lib.expert_rank(mesh), mesh_lib.clients_rank(mesh)) == (1, 0)
    assert mesh_lib.expert_group(mesh) == (0, 1)
    assert mesh_lib.clients_group(mesh) == (1, 3)


def test_ring_model_value_errors():
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads,
                                                     init_decode_cache)
    cfg = GPT2Config.tiny()
    cfg.attn_impl = "ring"
    z = torch.zeros((1, 1, 4), dtype=torch.int32)
    zc = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="seq mesh axis"):
        GPT2DoubleHeads(cfg)(z, z, zc, train=False)
    with pytest.raises(ValueError, match="does not compose with"):
        GPT2DoubleHeads(cfg)(z, z, zc, train=False,
                             cache=init_decode_cache(cfg, 1, 8),
                             position=torch.zeros(1, dtype=torch.int64))
    cfg.fused_lm_head = True
    with pytest.raises(ValueError, match="fused_lm_head is not supported"):
        GPT2DoubleHeads(cfg)(z, z, zc, train=False)


def test_fused_ce_auto_is_off_on_a_seq_axis():
    args = build_parser().parse_args([])
    args.fused_ce, args.fused_lm_head = "auto", False
    args.attn_impl, args.max_seq_len = "full", 512
    assert resolve_fused_ce(args) is True
    assert resolve_fused_ce(args, parse_mesh("clients=2,seq=2")) is False
    args.fused_ce = "on"
    assert resolve_fused_ce(args, parse_mesh("clients=2,seq=2")) is True
