"""A12's ``stage`` axis on ``torch.distributed`` (the GPipe pipeline of
GPT2) against the reference's ``shard_map`` pipeline on the CPU.

One module-scoped launch of 4 gloo ranks (``tools/mesh_cases.py`` on a
``make_mesh(4, stage=2)`` mesh: two client shards of a 2-stage pipeline)
runs every multi-rank case; each test reads the ranks' arrays:

* ``gpt2_pp_lm_apply`` of gpt2-tiny against the reference's on its CPU
  stage mesh: 2 stages (B 4, T 16, 2 microbatches;
  ``tests/test_attention.py:214-258``), also with the rows split over the
  clients axis, and 4 stages (the 4 ranks as one stage axis: 4 layers, B
  6, T 8, 3 microbatches; ``:261-279``): logits at 1e-5, the flat
  gradient of mean(lm ** 2) within 1e-5 of its largest entry; GPT-1's
  post-LN arch (``:443-470``) and MoE blocks at capacity 100
  (``tests/test_moe.py:182-204``): logits at 1e-5; with ``remat``, bitwise
  the 2-stage problem's logits and gradient;
* the dropout contract (``tests/test_attention.py:405-440``): no seed
  raises, one seed gives the same logits, another seed and ``train=False``
  others;
* one worker's loss and flat gradient on ``clients=2,stage=2`` at dropout
  0 against the port's unpipelined LM-only loss, within 1e-6 of the
  largest entry (the shared head, final LayerNorm and ``wte`` count once);
* the GPT2 entry point's ``--mesh clients=2,stage=2 --mc_coef 0`` round,
  uncompressed and sketch, against the reference's stage round of
  ``tests/test_cli_mesh.py:286-315``'s problem (its initial weights):
  weights at atol 2e-4, nll within 1e-3, every rank's state bitwise every
  round, and a run resumed from the step file of round 1 bitwise the
  uninterrupted round 2;
* the reference's ValueErrors in its order (``tests/test_cli_mesh.py:
  278-345``), and the gate's ``--fused_ce on``, ``--dropout_impl`` and
  ``--pp_microbatches`` refusals.

Every rank and the test process run one intra-op thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.parallel.pp import gpt2_pp_lm_apply as jax_pp_apply
from commefficient_tpu.parallel.pp import \
    stack_block_params as jax_stack_block_params
from commefficient_tpu_torch.parallel import pp
from commefficient_tpu_torch.tools import mesh_cases as mc
from commefficient_tpu_torch.training.args import (build_parser, parse_mesh,
                                                   resolve_fused_ce)
from commefficient_tpu_torch.utils.params import params_from_jax

RANKS, STAGES = 4, 2
CASES = ("pp_apply", "pp_grad", "pp_cli")
#: the reference's byte tokenizer (the CLI's vocab without a local cache)
BYTE_VOCAB = 261
SEED = 21


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_problem(tag):
    """``PP_APPLY[tag]``'s reference model, ids, types and initial
    params."""
    spec = mc.PP_APPLY[tag]
    cfg = JConfig.tiny()
    cfg.n_positions = spec["T"]
    for k, v in spec["cfg"].items():
        setattr(cfg, k, v)
    model = JModel(cfg)
    ids, types = (x.astype(np.int32) for x in mc.pp_apply_inputs(tag))
    params = jax.device_get(model.init(
        jax.random.PRNGKey(spec["key"]), ids[:, None], types[:, None],
        np.zeros((spec["B"], 1), np.int32), train=False)["params"])
    return model, ids, types, params


def _jax_stage_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("stage",))


def _npz(params):
    return {k: v.numpy() for k, v in params_from_jax(params).items()}


def _ref_cli_init():
    """The reference GPT2 entry point's initial weights for the
    ``pp_cli`` problem (gpt2-tiny on the byte tokenizer, ``--seed``)."""
    cfg = JConfig.tiny(vocab_size=BYTE_VOCAB)
    ids = np.zeros((1, 2, mc.SEQ_T), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    return jax.device_get(JModel(cfg).init(
        init_rng, ids, ids, np.zeros((1, 2), np.int32),
        train=False)["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launch: the stage cases on 4 ranks (clients 2 x stage 2)."""
    out = str(tmp_path_factory.mktemp("pp"))
    for tag in (t for t, spec in mc.PP_APPLY.items() if "init" not in spec):
        np.savez(os.path.join(out, f"pp_{tag}_init.npz"),
                 **_npz(_jax_problem(tag)[3]))
    np.savez(os.path.join(out, "pp_cli_init.npz"), **_npz(_ref_cli_init()))
    mc.launch(out, CASES, ranks=RANKS, stage=STAGES)
    return {"dir": out, "recs": {c: [
        dict(np.load(os.path.join(out, f"{c}_rank{r}.npz")))
        for r in range(RANKS)] for c in CASES}}


# --------------------------------------------------------------------------
# the pipeline's forward and gradient
# --------------------------------------------------------------------------


def _flat_in_torch_order(tag, tree):
    """A reference params-shaped tree flattened in the port model's
    parameter order."""
    names = [k for k, _ in mc._model_from(mc.pp_config(tag), None)
             .named_parameters()]
    flat = params_from_jax(tree)
    return np.concatenate([flat[k].numpy().reshape(-1) for k in names])


@pytest.mark.parametrize("tag", ["two", "four", "post_ln", "moe"])
def test_pp_apply_matches_reference(runs, tag):
    spec = mc.PP_APPLY[tag]
    model, ids, types, params = _jax_problem(tag)
    mesh = _jax_stage_mesh(spec["stages"])
    train = spec.get("train", True)
    ref = np.asarray(jax_pp_apply(mesh, model, params, ids, types,
                                  n_micro=spec["n_micro"], train=train))
    recs = runs["recs"]["pp_apply"]
    for rec in recs:
        np.testing.assert_allclose(rec[f"{tag}/lm"], ref, rtol=1e-5,
                                   atol=1e-5)
        if spec.get("dp"):
            np.testing.assert_allclose(rec[f"{tag}/dp_lm"], ref, rtol=1e-5,
                                       atol=1e-5)
    if not spec.get("grad"):
        return

    def loss(p):
        return jnp.mean(jax_pp_apply(mesh, model, p, ids, types,
                                     n_micro=spec["n_micro"]) ** 2)
    want = _flat_in_torch_order(tag, jax.grad(loss)(params))
    for rec in recs:
        np.testing.assert_array_equal(rec[f"{tag}/grad"],
                                      recs[0][f"{tag}/grad"])
        np.testing.assert_allclose(rec[f"{tag}/grad"], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_pp_remat_is_bitwise(runs):
    """``remat`` recomputes each stage's blocks in the backward: the
    logits and the gradient are bitwise the problem's without it."""
    for rec in runs["recs"]["pp_apply"]:
        for key in ("lm", "grad"):
            np.testing.assert_array_equal(rec[f"remat/{key}"],
                                          rec[f"two/{key}"])


def test_pp_dropout_contract(runs):
    """No seed at dropout > 0 raises; a seed's logits repeat, another
    seed's and ``train=False``'s differ."""
    model = mc._model_from(mc.pp_config("dropout"), None)
    ids, types = (torch.as_tensor(x) for x in mc.pp_apply_inputs("dropout"))
    with pytest.raises(ValueError,
                       match="silently drop the configured regularization"):
        pp.gpt2_pp_lm_apply(None, model, dict(model.named_parameters()),
                            ids, types, 2)
    for rec in runs["recs"]["pp_apply"]:
        a1, a2, b = (rec[f"dropout/seed{i}"] for i in range(3))
        np.testing.assert_array_equal(a1, a2)
        assert not np.array_equal(a1, b)
        assert not np.array_equal(a1, rec["dropout/eval"])
        assert np.isfinite(a1).all()


def test_pp_gradient_equals_unsharded(runs):
    one = mc.run_one_process("pp_grad", runs["dir"])
    want = one["grad"]
    for rec in runs["recs"]["pp_grad"]:
        assert abs(float(rec["loss"]) - float(one["loss"])) \
            <= 1e-6 * abs(float(one["loss"]))
        np.testing.assert_allclose(rec["grad"], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_stack_block_params_matches_reference():
    _, _, _, params = _jax_problem("four")
    stacked, rest = pp.stack_block_params(
        {k: v for k, v in params_from_jax(params).items()}, 4)
    j_stacked, j_rest = jax_stack_block_params(params, 4)
    assert set(rest) == set(params_from_jax(j_rest))
    for i in range(4):
        # the reference's layer i, as the port names and lays out a block
        want = params_from_jax({"Block_0": jax.tree_util.tree_map(
            lambda leaf: leaf[i], j_stacked)})
        assert set(want) == {f"Block_0.{k}" for k in stacked}
        for k, v in stacked.items():
            np.testing.assert_array_equal(v[i].numpy(),
                                          want[f"Block_0.{k}"].numpy())


# --------------------------------------------------------------------------
# the round
# --------------------------------------------------------------------------


_REF_CLI = {}


def _ref_stage_round(tmp_path_factory, mode):
    """The reference's ``--mesh clients=2,stage=2 --mc_coef 0`` round of
    the problem (its ``train``; rounds read through the learner)."""
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
        args = build_gpt2_parser().parse_args(mc.pp_cli_argv(
            mode, str(tmp_path_factory.mktemp("ref_persona")))
            + ["--mesh", "clients=2,stage=2"])
        mesh = jax_parse(args.mesh)
        jax_round_up(args, mesh)
        np.random.seed(args.seed)
        learner, row = train(args, mesh=mesh, max_rounds=mc.PP_CLI_ROUNDS,
                             log=False)
    finally:
        JaxLearner.finalize_round_metrics = saved
    _REF_CLI[mode] = (np.asarray(rounds), np.asarray(learner.state.weights),
                      float(row["nll"]))
    return _REF_CLI[mode]


@pytest.mark.parametrize("mode", list(mc.SEQ_CLI_MODES))
def test_pp_round_matches_reference(runs, tmp_path_factory, mode):
    recs = runs["recs"]["pp_cli"]
    for rec in recs:
        assert len(rec[f"{mode}/digests"]) == mc.PP_CLI_ROUNDS
        for key in ("digests", "weights", "metrics"):
            np.testing.assert_array_equal(rec[f"{mode}/{key}"],
                                          recs[0][f"{mode}/{key}"])
        # a step file written after round 1 moves nothing, and a run
        # resumed from it is the uninterrupted round 2
        np.testing.assert_array_equal(rec[f"{mode}/saved/digests"],
                                      rec[f"{mode}/digests"])
        np.testing.assert_array_equal(rec[f"{mode}/resumed/digests"],
                                      rec[f"{mode}/digests"][1:])
        np.testing.assert_array_equal(rec[f"{mode}/resumed/weights"],
                                      rec[f"{mode}/weights"])
        np.testing.assert_array_equal(rec[f"{mode}/resumed/metrics"],
                                      rec[f"{mode}/metrics"][1:])
    rounds, w_ref, nll_ref = _ref_stage_round(tmp_path_factory, mode)
    got = recs[0]
    # the loss and download bytes at the mesh tolerance (ROADMAP.md C19),
    # the rest exact
    np.testing.assert_allclose(got[f"{mode}/metrics"][:, :2], rounds[:, :2],
                               rtol=2e-4)
    np.testing.assert_array_equal(got[f"{mode}/metrics"][:, 2:],
                                  rounds[:, 2:])
    np.testing.assert_allclose(got[f"{mode}/weights"], w_ref, atol=2e-4)
    assert float(got[f"{mode}/nll"]) == pytest.approx(nll_ref, abs=1e-3)


# --------------------------------------------------------------------------
# the gate: the reference's ValueErrors in its order
# --------------------------------------------------------------------------


def _gpt2_args(tmp_path, *extra):
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    return build_gpt2_parser().parse_args(
        ["--device", "cpu", "--mode", "uncompressed", "--error_type",
         "none", "--max_seq_len", "32", "--dataset_name", "SyntheticPersona",
         "--dataset_dir", str(tmp_path), *extra])


def test_parse_mesh_stage_axis_grammar():
    assert dict(parse_mesh("clients=2,stage=2").shape) == {"clients": 2,
                                                           "stage": 2}
    with pytest.raises(ValueError, match="ONE inner axis"):
        parse_mesh("clients=2,stage=2,seq=2")


@pytest.mark.parametrize("extra,match", [
    ([], "mc_coef 0"),
    (["--mode", "local_topk", "--error_type", "local", "--k", "10",
      "--local_momentum", "0.9", "--mc_coef", "0"],
     "stage=2 requires the fused"),
    (["--mc_coef", "0", "--fused_ce", "on"], "--fused_ce on is not plumbed"),
    (["--mc_coef", "0", "--dropout_impl", "xla_rbg"],
     "--dropout_impl xla_rbg is not plumbed"),
    (["--mc_coef", "0", "--pp_microbatches", "-1"],
     "--pp_microbatches must be >= 0"),
    (["--mc_coef", "0", "--moe_experts", "2"], "do not\ncollect|do not "
     "collect")])
def test_gpt2_stage_gate_value_errors(tmp_path, extra, match):
    """Each of the reference's messages, word for word."""
    from commefficient_tpu.training.args import parse_mesh as jax_parse
    from commefficient_tpu.training.gpt2 import build_gpt2_parser as jp
    from commefficient_tpu.training.gpt2 import train as jax_train
    from commefficient_tpu_torch.training.gpt2 import train
    argv = ["--mode", "uncompressed", "--error_type", "none",
            "--max_seq_len", "32", "--dataset_name", "SyntheticPersona",
            *extra]
    with pytest.raises(ValueError, match=match) as ref:
        jax_train(jp().parse_args(argv + ["--dataset_dir",
                                          str(tmp_path / "r")]),
                  mesh=jax_parse("clients=2,stage=2"), log=False)
    args = _gpt2_args(tmp_path / "p", "--mesh", "clients=2,stage=2", *extra)
    with pytest.raises(ValueError) as got:
        train(args, mesh=parse_mesh("clients=2,stage=2"), log=False)
    assert str(got.value) == str(ref.value)


def test_gpt2_stage_gate_refuses_tpu_bits(tmp_path):
    """``dropout_impl = "tpu_bits"`` (set on the namespace: no CLI value
    selects it) is refused with the reference's message."""
    from commefficient_tpu_torch.training.gpt2 import train
    args = _gpt2_args(tmp_path, "--mc_coef", "0")
    args.dropout_impl = "tpu_bits"
    with pytest.raises(ValueError, match="--dropout_impl tpu_bits is not "
                       "plumbed through the pipeline's blocks"):
        train(args, mesh=parse_mesh("clients=2,stage=2"), log=False)


def test_cv_cli_rejects_stage_axis(tmp_path):
    from commefficient_tpu_torch.training.cv import main
    with pytest.raises(ValueError, match="no stacked block trunk"):
        main(["--device", "cpu", "--test", "--mesh", "clients=2,stage=2",
              "--dataset_name", "Synthetic", "--dataset_dir",
              str(tmp_path)])


def test_gpt2_main_launches_clients_times_stage_ranks(tmp_path, monkeypatch):
    """``--mesh clients=2,stage=2 --mc_coef 0`` makes ``main`` start 4
    ranks of ``mesh_rank_main``, which build the stage axis from
    ``--mesh``."""
    from commefficient_tpu_torch.training import gpt2
    seen = []
    monkeypatch.setattr(gpt2.distributed, "run",
                        lambda target, n, args, **kw: seen.append(
                            (target, n, args[1:], args[0].mesh)))
    assert gpt2.main(["--device", "cpu", "--mesh", "clients=2,stage=2",
                      "--mc_coef", "0", "--max_seq_len", "32",
                      "--dataset_dir", str(tmp_path)]) == 0
    assert seen == [(gpt2.mesh_rank_main, 4, (4, 1), "clients=2,stage=2")]


def test_fused_ce_auto_is_off_on_a_stage_axis():
    args = build_parser().parse_args([])
    args.fused_ce, args.fused_lm_head = "auto", False
    args.attn_impl, args.max_seq_len = "full", 512
    assert resolve_fused_ce(args) is True
    assert resolve_fused_ce(args, parse_mesh("clients=2,stage=2")) is False


def test_collective_clock_times_the_hops_and_restores_them(monkeypatch):
    """``mesh_run``'s collective clock (the card's mesh_pp_gpt2 reads it)
    books a hop's sent bytes under ``stage_send`` and a receive under
    ``stage_recv``, and puts every patched function back on exit."""
    from commefficient_tpu_torch.tools.mesh_run import _CollectiveClock
    monkeypatch.setattr(pp.StageContext, "send",
                        lambda self, x, step, tag: None)
    monkeypatch.setattr(pp.StageContext, "recv",
                        lambda self, shape, dtype, device, step, tag:
                        torch.zeros(shape, dtype=dtype))
    before = (torch.distributed.all_reduce, pp.StageContext.send,
              pp.StageContext.recv)
    ctx = pp.StageContext(None, 0, 2)
    with _CollectiveClock() as clock:
        assert pp.StageContext.send is not before[1]
        ctx.send(torch.ones(3, 4), 1, 0)
        got = ctx.recv((2, 5), torch.float32, "cpu", -1, 0)
    assert got.shape == (2, 5)
    kinds = clock.snapshot()[3]
    assert kinds["stage_send"][1:] == [48, 1]
    assert kinds["stage_recv"][1:] == [0, 1]
    assert (torch.distributed.all_reduce, pp.StageContext.send,
            pp.StageContext.recv) == before
