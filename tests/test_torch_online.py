"""Train-while-serve of the port (``commefficient_tpu_torch/online/``) on
the CPU, against the JAX package's:

* ``run_online`` with the reference's own argv (tests/test_online.py's
  ``_ONLINE_ARGV``) from the reference's initial weights agrees with the
  reference's run on the cohorts, applies, swaps and steps, the replies
  served before the first swap token for token, and the held-out nll
  within 1e-4 relative;
* each package loads the other's online checkpoint (the learner state
  and the online loop's cursor);
* the port's entry point runs ``--serve_online`` with ``--device cpu``;
* the hot swap: replies admitted before it finish under the old weights,
  resubmitted leftovers are served the new weights, and a foreign
  fingerprint is refused before anything is drained;
* the collector routes by the store's owner and its cursor round-trips.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu_torch.data.tokenizer import ByteTokenizer
from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                 GPT2DoubleHeads)
from commefficient_tpu_torch.online import (HotSwapCoordinator,
                                            InteractionCollector)
from commefficient_tpu_torch.serving import (ContinuousBatchingServer,
                                             DecodeEngine)
from commefficient_tpu_torch.utils.params import params_from_jax

# the reference's tests/test_online.py::_ONLINE_ARGV
ONLINE_ARGV = [
    "--mode", "local_topk", "--error_type", "local",
    "--client_state", "sparse", "--k", "16",
    "--server_mode", "buffered", "--serve_personalized", "--serve_online",
    "--serve_slots", "4", "--online_train_every", "2",
    "--online_swap_every", "1", "--max_seq_len", "64",
    "--lr_scale", "0.5", "--num_epochs", "1", "--seed", "3",
]


def _ref_init_params(seed: int, max_seq_len: int):
    """The reference learner's initial weights under ``--seed``:
    ``model.init`` on the first half of ``split(PRNGKey(seed))``."""
    tok = ByteTokenizer()
    cfg = JConfig.tiny(vocab_size=tok.vocab_size)
    cfg.n_positions = max(cfg.n_positions, max_seq_len)
    ids = np.zeros((1, 1, max_seq_len), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    return JModel(cfg).init(init_rng, ids, ids, np.zeros((1, 1), np.int32),
                            train=False)["params"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    # tiny tensors: the suite's workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``run_online`` on ``ONLINE_ARGV``, each writing its
    swap-boundary checkpoints, the port from the reference's weights."""
    from commefficient_tpu.online import run_online as ref_run
    from commefficient_tpu.training.gpt2 import \
        build_gpt2_parser as ref_parser
    from commefficient_tpu_torch.online import run_online
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    base = tmp_path_factory.mktemp("online")
    ds = str(base / "ds")
    out = {}
    ref_args = ref_parser().parse_args(ONLINE_ARGV + [
        "--dataset_dir", ds, "--checkpoint_path", str(base / "ref_ckpt"),
        "--checkpoint_every_rounds", "1"])
    out["ref"] = ref_run(ref_args, log=False) + (ref_args,)
    init = params_from_jax(_ref_init_params(3, 64))
    orig = GPT2DoubleHeads.reset_parameters

    def from_reference(self, generator=None):
        self.load_state_dict(init)
        return self

    GPT2DoubleHeads.reset_parameters = from_reference
    try:
        args = build_gpt2_parser().parse_args(ONLINE_ARGV + [
            "--dataset_dir", ds, "--device", "cpu", "--checkpoint_path",
            str(base / "port_ckpt"), "--checkpoint_every_rounds", "1"])
        out["port"] = run_online(args, log=False) + (args,)
    finally:
        GPT2DoubleHeads.reset_parameters = orig
    return out


KEYS = ("swaps", "dirty_swaps", "refused_swaps", "steps", "interactions",
        "rounds", "applies", "collected", "heldout_improved", "preempted")


def test_run_online_agrees_with_reference(runs):
    _, rloop, rres, _ = runs["ref"]
    learner, loop, res, _ = runs["port"]
    assert {k: res[k] for k in KEYS} == {k: rres[k] for k in KEYS}
    assert res["swaps"] == 2 and res["applies"] >= 2
    assert res["dirty_swaps"] == 0 and res["refused_swaps"] == 0
    np.testing.assert_allclose(res["train_losses"], rres["train_losses"],
                               rtol=1e-4)
    for a, b in zip(res["heldout_trajectory"], rres["heldout_trajectory"]):
        assert a["swaps"] == b["swaps"]
        np.testing.assert_allclose(
            [a["mean_nll"], a["mean_nll_base"]],
            [b["mean_nll"], b["mean_nll_base"]], rtol=1e-4)
    assert sorted(loop.replies) == sorted(rloop.replies)
    # the replies served before the first swap come from the same weights
    first = [r for r in sorted(rloop.replies) if r < 4]
    assert first and all(loop.replies[r] == rloop.replies[r]
                         for r in first)
    same = sum(loop.replies[r] == rloop.replies[r] for r in rloop.replies)
    assert same >= len(rloop.replies) // 2
    assert res["server_stats"] == rres["server_stats"]


def test_online_checkpoint_loads_across_packages(runs):
    from commefficient_tpu.training.preempt import \
        config_fingerprint as ref_fp
    from commefficient_tpu.utils.checkpoint import \
        find_latest_checkpoint as ref_find
    from commefficient_tpu.utils.checkpoint import \
        load_checkpoint as ref_load
    from commefficient_tpu_torch.training.preempt import config_fingerprint
    from commefficient_tpu_torch.utils.checkpoint import (
        find_latest_checkpoint, load_checkpoint)
    rlearner, rloop, _, rargs = runs["ref"]
    learner, loop, _, args = runs["port"]
    assert config_fingerprint(args, "gpt2_online") == \
        ref_fp(rargs, "gpt2_online")
    # the last checkpoint is the last swap's, and no apply follows it
    port_w = learner.state.weights.clone()
    ref_fn = ref_find(rargs.checkpoint_path, rargs.model)
    port_fn = find_latest_checkpoint(args.checkpoint_path, args.model)
    assert ref_fn and port_fn
    # the reference's file into the port's learner and loop
    info = load_checkpoint(ref_fn, learner,
                           expect_fingerprint=config_fingerprint(
                               args, "gpt2_online"))
    cur = info["cursor"]
    assert cur["entry"] == "gpt2_online" and cur["data"] is None
    loop.restore_cursor(cur["online"])
    assert loop.cursor() == cur["online"]
    want = np.asarray(rlearner.state.weights)
    assert np.array_equal(learner.state.weights.numpy(), want)
    # the port's file into the reference's learner and loop
    info = ref_load(port_fn, rlearner,
                    expect_fingerprint=ref_fp(rargs, "gpt2_online"))
    rloop.restore_cursor(info["cursor"]["online"])
    assert rloop.cursor() == info["cursor"]["online"]
    assert rloop.swaps == 2 and rloop.collector.collected > 0
    assert np.array_equal(np.asarray(rlearner.state.weights),
                          port_w.numpy())


def test_online_entry_point_runs_on_cpu(tmp_path, capsys):
    from commefficient_tpu_torch.training.gpt2 import main
    assert main(ONLINE_ARGV + ["--device", "cpu", "--dataset_dir",
                               str(tmp_path / "ds")]) == 0
    text = capsys.readouterr().out
    assert "online done: swaps=2" in text
    assert "'swaps': 2" in text and "'dirty_swaps': 0" in text


@pytest.fixture(scope="module")
def own_engine():
    tok = ByteTokenizer()
    cfg = GPT2Config.tiny(vocab_size=tok.vocab_size)
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0))
    params = {n: p.detach() for n, p in model.named_parameters()}
    eos = tok.convert_tokens_to_ids("<eos>")
    return tok, DecodeEngine(model, params, eos_id=eos, max_len=48)


def _prompts(tok, n):
    texts = ["hello there", "do you like fish", "the weather is nice",
             "tell me a story", "what is your name", "where are you from"]
    return [(tok.encode(t), [1] * len(tok.encode(t))) for t in texts[:n]]


def _solo(engine, prompts, max_new=8):
    return [engine.generate([(ids, types)], [types[-1]], max_new=max_new)[0]
            for ids, types in prompts]


def test_swap_parity_and_fingerprint_gate(own_engine):
    tok, engine = own_engine
    prompts = _prompts(tok, 6)
    old = engine.params
    solo_old = _solo(engine, prompts)
    srv = ContinuousBatchingServer(engine, slots=4, prefill_len=32,
                                   kv_cache="paged")
    rids = [srv.submit(ids, types, types[-1], 8) for ids, types in prompts]
    srv.step()                                  # 4 admitted, 2 queued
    fp = {"seed": 1, "mode": "local_topk"}
    gate = HotSwapCoordinator(srv, expect_fingerprint=fp)
    with pytest.raises(ValueError, match="hot swap refused"):
        gate.swap(old, fingerprint=dict(fp, seed=2))
    assert gate.refused == 1 and srv.swaps_done == 0
    with pytest.raises(RuntimeError, match="active"):
        srv.swap_base_params(old)
    new = {n: t + 0.1 * torch.sin(torch.arange(t.numel(),
                                               dtype=torch.float32)
                                  ).reshape(t.shape)
           for n, t in old.items()}
    replies, leftovers = HotSwapCoordinator(srv).swap(new)
    assert srv.swaps_done == 1 and len(replies) == 4 and len(leftovers) == 2
    assert [replies[r] for r in rids[:4]] == solo_old[:4]
    late = srv.run()
    solo_new = _solo(engine, prompts)
    assert solo_new != solo_old
    assert sorted(map(tuple, late.values())) == \
        sorted(map(tuple, solo_new[4:]))
    assert srv.stats()["swaps_done"] == 1 and srv.dirty_swaps == 0
    srv.swap_base_params(old)


class _Store:
    num_shards = 2

    @staticmethod
    def owner(cid):
        return int(cid) // 4


def test_collector_routes_by_owner_and_cursor_round_trips():
    col = InteractionCollector(8, 16, store=_Store(), eos_id=257,
                               max_per_user=2)
    assert col.record(1, [5, 6], [1, 1], [7, 8], 2)
    assert col.record(6, [5], [1], [9], 2, label_ids=[3, 4])
    assert not col.record(2, [5], [1], [], 2)
    for _ in range(2):
        col.record(1, [5, 6], [1, 1], [7], 2)
    assert col.pending_per_shard() == [2, 1]
    assert (col.collected, col.dropped, col.evicted) == (4, 1, 1)
    ids, cols, mask = col.sample_round(2, 2)
    assert ids.tolist() == [1, 6] and mask.tolist() == [[1, 1], [1, 0]]
    assert cols[2][1, 0, 0].tolist()[:4] == [-1, 3, 4, 257]
    twin = InteractionCollector(8, 16, store=_Store(), eos_id=257)
    twin.restore_cursor(copy.deepcopy(col.cursor()))
    assert twin.cursor() == col.cursor()


SERVE_FLAGS = ("serve_slots", "serve_sample", "serve_personalized",
               "serve_disagg", "kv_quant", "speculate_k",
               "online_train_every", "online_swap_every", "serve_online",
               "serve_tp")
BAD = [
    ["--serve_personalized"],
    ["--serve_disagg", "--serve_slots", "1"],
    ["--serve_online", "--serve_personalized", "--client_state", "sparse",
     "--mode", "local_topk", "--error_type", "local"],
    ["--online_train_every", "0"],
    ["--speculate_k", "-1"],
    ["--serve_slots", "0"],
]


@pytest.mark.parametrize("bad", BAD, ids=lambda b: " ".join(b))
def test_serve_flags_parse_and_validate_as_the_reference(bad):
    """The serve and online flags: the reference's defaults, and each
    invalid combination refused with a ValueError by both configs."""
    from commefficient_tpu.training.args import \
        args_to_config as ref_config
    from commefficient_tpu.training.gpt2 import \
        build_gpt2_parser as ref_parser
    from commefficient_tpu_torch.training.args import args_to_config
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    port = build_gpt2_parser().parse_args([])
    ref = ref_parser().parse_args([])
    assert {f: getattr(port, f) for f in SERVE_FLAGS} == \
        {f: getattr(ref, f) for f in SERVE_FLAGS}
    ref_config(ref, num_clients=8).finalize(64)    # the defaults are valid
    args_to_config(port).finalize(64)
    with pytest.raises(ValueError):
        ref_config(ref_parser().parse_args(bad), num_clients=8).finalize(64)
    with pytest.raises(ValueError):
        args_to_config(build_gpt2_parser().parse_args(bad)).finalize(64)
    # --serve_tp above 1 needs a model mesh axis, in both packages
    with pytest.raises(ValueError) as ref_err:
        ref_config(ref_parser().parse_args(["--serve_tp", "2"]),
                   num_clients=8).finalize(64)
    with pytest.raises(ValueError) as got:
        args_to_config(build_gpt2_parser().parse_args(
            ["--serve_tp", "2"])).finalize(64)
    assert str(got.value) == str(ref_err.value)
