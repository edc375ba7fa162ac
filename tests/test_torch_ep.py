"""A12's ``expert`` axis on ``torch.distributed`` (MoE expert parallelism
for GPT2) against the reference's GSPMD expert sharding on the CPU.

One module-scoped launch of 4 gloo ranks (``tools/mesh_cases.py`` on a
``make_mesh(4, expert=2)`` mesh: two client shards of a 2-way expert
axis) runs every multi-rank case; each test reads the ranks' arrays:

* the layer, as the reference's ``tests/test_moe.py:64-80``:
  ``moe_ep_specs`` and the shard shapes equal the reference's, the
  output within 2e-4 of the reference's unsharded layer;
* the binding-capacity trajectory of ``tests/test_moe.py:83-142`` (the
  capacity binding, asserted): losses at rtol 2e-4, the weights at atol
  2e-5;
* gpt2-tiny with 4 experts: the logits within 1e-5 of the reference's,
  one worker's flat gradient within 1e-6 of its largest entry against
  the port's unsharded gradient;
* the GPT2 entry point's ``--mesh clients=2,expert=2 --moe_experts 4``
  round, uncompressed and sketch, at capacity factors 1.25 and 100,
  against the reference's ``make_mesh(4, expert=2)`` round of
  ``tests/test_cli_mesh.py:353-385``'s problem (its initial weights):
  weights at atol 2e-4, nll within 1e-3, every rank's state bitwise every
  round, and (at 1.25) a run resumed from round 1's step file bitwise
  the uninterrupted round 2;
* the buffered server under a fault schedule and ``--grad_buckets 3``
  on the expert axis: the ranks bitwise every round, the rounds and
  weights of the port's one-process run at the mesh tolerance;
* the reference's ValueErrors in its order, ``main``'s launch, the
  mesh's layout and the collective clock's expert kinds.

Every rank and the test process run one intra-op thread.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.ops.moe import MoEFFN as JaxMoE
from commefficient_tpu.ops.moe import moe_ep_specs as jax_ep_specs
from commefficient_tpu.ops.moe import shard_params_ep as jax_shard_ep
from commefficient_tpu_torch.ops import moe as moe_lib
from commefficient_tpu_torch.parallel import ep as ep_lib
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.tools import mesh_cases as mc
from commefficient_tpu_torch.training.args import parse_mesh
from commefficient_tpu_torch.utils.params import params_from_jax

RANKS, EXPERT = 4, 2
CASES = ("ep_layer", "ep_gpt2", "ep_cli", "ep_flags")
#: the reference's byte tokenizer (the CLI's vocab without a local cache)
BYTE_VOCAB = 261
SEED = 21


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_layer(tag):
    """``EP_LAYER[tag]``'s reference layer, params and tokens (the
    reference test's ``_init``)."""
    spec = mc.EP_LAYER[tag]
    x, tgt = mc.moe_layer_inputs(tag)
    layer = JaxMoE(num_experts=spec["E"], d_ff=spec["ff"],
                   capacity_factor=spec["cap"])
    params = jax.device_get(layer.init(jax.random.PRNGKey(spec["seed"]),
                                       jnp.asarray(x))["params"])
    return layer, params, x, tgt


@functools.lru_cache(maxsize=None)
def _jax_gpt2():
    cfg = JConfig.tiny()
    cfg.moe_experts = mc.MOE_EXPERTS
    model = JModel(cfg)
    ids, types = (a.astype(np.int32) for a in mc.pp_apply_inputs("two"))
    params = jax.device_get(model.init(
        jax.random.PRNGKey(3), ids[:, None], types[:, None],
        np.zeros((ids.shape[0], 1), np.int32), train=False)["params"])
    return model, params, ids, types


def _ref_moe_cli_init():
    """The reference GPT2 entry point's initial weights for the MoE
    problem (gpt2-tiny with 4 experts on the byte tokenizer,
    ``--seed``)."""
    cfg = JConfig.tiny(vocab_size=BYTE_VOCAB)
    cfg.moe_experts = mc.MOE_EXPERTS
    ids = np.zeros((1, 2, mc.SEQ_T), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    return jax.device_get(JModel(cfg).init(
        init_rng, ids, ids, np.zeros((1, 2), np.int32),
        train=False)["params"])


def _npz(params):
    return {k: v.numpy() for k, v in params_from_jax(params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launch: the expert cases on 4 ranks (clients 2 x expert 2)."""
    out = str(tmp_path_factory.mktemp("ep"))
    for tag in mc.EP_LAYER:
        np.savez(os.path.join(out, f"ep_{tag}_init.npz"),
                 **_npz(_jax_layer(tag)[1]))
    np.savez(os.path.join(out, "ep_gpt2_init.npz"), **_npz(_jax_gpt2()[1]))
    np.savez(os.path.join(out, "moe_cli_init.npz"),
             **_npz(_ref_moe_cli_init()))
    mc.launch(out, CASES, ranks=RANKS, expert=EXPERT)
    return {"dir": out, "recs": {c: [
        dict(np.load(os.path.join(out, f"{c}_rank{r}.npz")))
        for r in range(RANKS)] for c in CASES}}


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------


def test_ep_specs_and_shard_shapes_match_reference():
    """``moe_ep_specs`` leaf for leaf, on the layer and on gpt2-tiny with
    experts, and ``shard_params_ep``'s blocks of the reference's shard
    shapes on a 4-way expert axis."""
    _, params, _, _ = _jax_layer("layer")
    _, gparams, _, _ = _jax_gpt2()
    for tree in (params, gparams):
        got = moe_lib.moe_ep_specs(params_from_jax(tree))
        ref = params_from_jax(jax.tree_util.tree_map(
            lambda s: np.asarray(tuple(s) == ("expert",)),
            jax_ep_specs(tree), is_leaf=lambda s: isinstance(
                s, jax.sharding.PartitionSpec)))
        assert set(got) == set(ref)
        for name, spec in got.items():
            assert spec == (("expert",) if bool(ref[name]) else ()), name
        assert sum(s != () for s in got.values()) == 4 * (
            1 if tree is params else 2)
    mesh = Mesh(np.array(jax.devices()[:4]), ("expert",))
    sharded = jax_shard_ep(params, mesh)
    tparams = params_from_jax(params)
    for r in range(4):
        mine = moe_lib.shard_params_ep(tparams, r, 4)
        for name, leaf in params_from_jax(jax.tree_util.tree_map(
                lambda a: np.zeros(a.sharding.shard_shape(a.shape)),
                sharded)).items():
            assert tuple(mine[name].shape) == tuple(leaf.shape), name
        want = tparams["moe_w1"][r:r + 1]
        assert torch.equal(mine["moe_w1"], want)


def test_ep_layer_matches_reference(runs):
    layer, params, x, _ = _jax_layer("layer")
    y_ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    recs = runs["recs"]["ep_layer"]
    for rec in recs:
        np.testing.assert_array_equal(rec["layer/y"], recs[0]["layer/y"])
        np.testing.assert_allclose(rec["layer/y"], y_ref, rtol=2e-4,
                                   atol=2e-4)


def test_ep_binding_capacity_trajectory_matches_reference(runs):
    """The reference's 4 SGD steps at capacity factor 1.25 with an
    expert overflowing (asserted): the expert-parallel losses and final
    weights against its single-device trajectory."""
    layer, params, x, tgt = _jax_layer("traj")
    spec = mc.EP_LAYER["traj"]
    cap = max(1, int(spec["cap"] * spec["N"] / spec["E"]))
    logits = x @ params["router"]["kernel"] + params["router"]["bias"]
    counts = np.bincount(logits.argmax(-1), minlength=spec["E"])
    assert counts.max() > cap, (counts, cap)

    def step(p):
        def loss(p):
            y = layer.apply({"params": p}, jnp.asarray(x))
            return jnp.mean((y - jnp.asarray(tgt)) ** 2)
        val, g = jax.value_and_grad(loss)(p)
        return val, jax.tree_util.tree_map(lambda a, b: a - spec["lr"] * b,
                                           p, g)
    jstep = jax.jit(step)
    p_ref, losses = params, []
    for _ in range(spec["steps"]):
        val, p_ref = jstep(p_ref)
        losses.append(float(val))
    want = params_from_jax(jax.device_get(p_ref))
    for rec in runs["recs"]["ep_layer"]:
        np.testing.assert_allclose(rec["traj/losses"], losses, rtol=2e-4,
                                   atol=1e-6)
        for name, w in want.items():
            np.testing.assert_allclose(rec[f"traj/{name}"], w.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=name)


# --------------------------------------------------------------------------
# gpt2-tiny with experts
# --------------------------------------------------------------------------


def test_ep_gpt2_logits_and_gradient(runs):
    model, params, ids, types = _jax_gpt2()
    lm_ref, _ = model.apply({"params": params}, ids[:, None],
                            types[:, None],
                            np.zeros((ids.shape[0], 1), np.int32),
                            train=False)
    lm_ref = np.asarray(lm_ref[:, 0])
    one = mc.run_one_process("ep_gpt2", runs["dir"])
    recs = runs["recs"]["ep_gpt2"]
    for rec in recs:
        np.testing.assert_allclose(rec["lm"], lm_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rec["grad"], recs[0]["grad"])
        assert abs(float(rec["loss"]) - float(one["loss"])) \
            <= 1e-6 * abs(float(one["loss"]))
        np.testing.assert_allclose(rec["grad"], one["grad"], rtol=0,
                                   atol=1e-6 * np.abs(one["grad"]).max())


# --------------------------------------------------------------------------
# the round
# --------------------------------------------------------------------------


_REF_CLI = {}


def _ref_expert_round(tmp_path_factory, mode, capacity):
    """The reference's ``--mesh clients=2,expert=2`` MoE round of the
    problem (its ``train``; rounds read through the learner)."""
    key = (mode, capacity)
    if key in _REF_CLI:
        return _REF_CLI[key]
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
        args = build_gpt2_parser().parse_args(mc.moe_cli_argv(
            mode, capacity, str(tmp_path_factory.mktemp("ref_persona")))
            + ["--mesh", "clients=2,expert=2"])
        mesh = jax_parse(args.mesh)
        jax_round_up(args, mesh)
        np.random.seed(args.seed)
        learner, row = train(args, mesh=mesh, max_rounds=mc.MOE_CLI_ROUNDS,
                             log=False)
    finally:
        JaxLearner.finalize_round_metrics = saved
    _REF_CLI[key] = (np.asarray(rounds), np.asarray(learner.state.weights),
                     float(row["nll"]))
    return _REF_CLI[key]


@pytest.mark.parametrize("run", list(mc.EP_CLI_RUNS))
def test_ep_round_matches_reference(runs, tmp_path_factory, run):
    mode, capacity, resume = mc.EP_CLI_RUNS[run]
    recs = runs["recs"]["ep_cli"]
    for rec in recs:
        assert len(rec[f"{run}/digests"]) == mc.MOE_CLI_ROUNDS
        for key in ("digests", "weights", "metrics"):
            np.testing.assert_array_equal(rec[f"{run}/{key}"],
                                          recs[0][f"{run}/{key}"])
        if not resume:
            continue
        # a step file written after round 1 moves nothing, and a run
        # resumed from it is the uninterrupted round 2
        np.testing.assert_array_equal(rec[f"{run}/saved/digests"],
                                      rec[f"{run}/digests"])
        np.testing.assert_array_equal(rec[f"{run}/resumed/digests"],
                                      rec[f"{run}/digests"][1:])
        np.testing.assert_array_equal(rec[f"{run}/resumed/weights"],
                                      rec[f"{run}/weights"])
        np.testing.assert_array_equal(rec[f"{run}/resumed/metrics"],
                                      rec[f"{run}/metrics"][1:])
    rounds, w_ref, nll_ref = _ref_expert_round(tmp_path_factory, mode,
                                               capacity)
    got = recs[0]
    # the loss and download bytes at the mesh tolerance (ROADMAP.md C19),
    # the rest exact
    np.testing.assert_allclose(got[f"{run}/metrics"][:, :2], rounds[:, :2],
                               rtol=2e-4)
    np.testing.assert_array_equal(got[f"{run}/metrics"][:, 2:],
                                  rounds[:, 2:])
    np.testing.assert_allclose(got[f"{run}/weights"], w_ref, atol=2e-4)
    assert float(got[f"{run}/nll"]) == pytest.approx(nll_ref, abs=1e-3)


@pytest.mark.parametrize("run", list(mc.EP_FLAG_RUNS))
def test_ep_composed_flags_match_one_process(runs, run):
    """The flags the reference composes with the expert axis run on it:
    the ranks bitwise every round, the rounds against one process's at
    the mesh tolerance (bytes exact)."""
    recs = runs["recs"]["ep_flags"]
    for rec in recs:
        for key in ("digests", "weights", "metrics"):
            np.testing.assert_array_equal(rec[f"{run}/{key}"],
                                          recs[0][f"{run}/{key}"])
    one = _ONE.setdefault("ep_flags", mc.run_one_process("ep_flags",
                                                         runs["dir"]))
    got = recs[0]
    np.testing.assert_allclose(got[f"{run}/metrics"][:, 0],
                               one[f"{run}/metrics"][:, 0], rtol=2e-4)
    np.testing.assert_array_equal(got[f"{run}/metrics"][:, 2:],
                                  one[f"{run}/metrics"][:, 2:])
    np.testing.assert_allclose(got[f"{run}/weights"], one[f"{run}/weights"],
                               rtol=2e-4, atol=2e-5)


_ONE = {}


# --------------------------------------------------------------------------
# the gate, the launch, the layout
# --------------------------------------------------------------------------


def _gpt2_args(tmp_path, *extra):
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    return build_gpt2_parser().parse_args(
        ["--device", "cpu", "--mode", "uncompressed", "--error_type",
         "none", "--max_seq_len", "32", "--dataset_name", "SyntheticPersona",
         "--dataset_dir", str(tmp_path), *extra])


@pytest.mark.parametrize("extra,match", [
    ([], "pass --moe_experts > 0"),
    (["--moe_experts", "4", "--mode", "local_topk", "--error_type",
      "local", "--k", "10", "--local_momentum", "0.9"],
     "expert=2 requires the fused"),
    (["--moe_experts", "4", "--max_grad_norm", "1.0"],
     "expert=2 requires the fused")])
def test_gpt2_expert_gate_value_errors(tmp_path, extra, match):
    """Each of the reference's messages, word for word, in its order."""
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
                  mesh=jax_parse("clients=2,expert=2"), log=False)
    args = _gpt2_args(tmp_path / "p", "--mesh", "clients=2,expert=2", *extra)
    with pytest.raises(ValueError) as got:
        train(args, mesh=parse_mesh("clients=2,expert=2"), log=False)
    assert str(got.value) == str(ref.value)


def test_gpt2_main_launches_clients_times_expert_ranks(tmp_path,
                                                       monkeypatch):
    """``--mesh clients=2,expert=2 --moe_experts 4`` makes ``main`` start
    4 ranks of ``mesh_rank_main``, which build the expert axis from
    ``--mesh``."""
    from commefficient_tpu_torch.training import gpt2
    seen = []
    monkeypatch.setattr(gpt2.distributed, "run",
                        lambda target, n, args, **kw: seen.append(
                            (target, n, args[1:], args[0].mesh)))
    assert gpt2.main(["--device", "cpu", "--mesh", "clients=2,expert=2",
                      "--moe_experts", "4", "--max_seq_len", "32",
                      "--dataset_dir", str(tmp_path)]) == 0
    assert seen == [(gpt2.mesh_rank_main, 4, (4, 1), "clients=2,expert=2")]


def test_make_mesh_lays_out_the_expert_axis(monkeypatch):
    """``make_mesh(4, expert=2)`` is a ``("clients", "expert")`` mesh (here
    over a stand-in 4-rank group: rank 1 sits at (0, 1), its expert group
    ranks 0-1, its clients group ranks 1 and 3)."""
    dist = mesh_lib.dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    mesh = mesh_lib.make_mesh(4, expert=2)
    assert mesh.mesh_dim_names == ("clients", "expert")
    assert mesh.shape == {"clients": 2, "expert": 2}
    assert (mesh_lib.expert_rank(mesh), mesh_lib.clients_rank(mesh)) == (1, 0)
    assert mesh_lib.expert_size(mesh) == 2
    assert mesh_lib.expert_group(mesh) == (0, 1)
    assert mesh_lib.clients_group(mesh) == (1, 3)
    ctx = ep_lib.EPContext.from_mesh(mesh)
    assert (ctx.group, ctx.rank, ctx.size) == ((0, 1), 1, 2)
    with pytest.raises(ValueError, match="choose ONE inner axis"):
        mesh_lib.make_mesh(4, expert=2, model=2)


def test_collective_clock_times_the_expert_kinds(monkeypatch):
    """``mesh_run``'s collective clock (the card's mesh_ep_gpt2 reads it)
    books the expert group's all-reduces and gradient join under their
    kinds, the all-reduce inside each once, and puts everything back."""
    from commefficient_tpu_torch.tools.mesh_run import _CollectiveClock
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda t, group=None: calls.append(t.numel()))
    monkeypatch.setattr(torch.distributed, "all_gather",
                        lambda parts, t, group=None: calls.append(t.numel()))
    before = (ep_lib.combine_sum, ep_lib.grad_sum, ep_lib.gather_grads)
    with _CollectiveClock() as clock:
        ep_lib.combine_sum(torch.ones(3, 4), None)
        ep_lib.grad_sum(torch.ones(5), None)
        ep_lib.gather_grads(torch.ones(2, 2), None, 2)
    kinds = clock.snapshot()[3]
    assert kinds["expert_combine"][1:] == [48, 1]
    assert kinds["expert_grad"][1:] == [20, 1]
    assert kinds["expert_join"][1:] == [16, 1]
    assert kinds["all_reduce"][2] == kinds["all_gather"][2] == 0
    assert calls == [12, 5, 4]
    assert (ep_lib.combine_sum, ep_lib.grad_sum,
            ep_lib.gather_grads) == before
