"""The ``clients`` mesh on ``torch.distributed`` against the reference's
``jax.sharding.Mesh`` round on the 8-device CPU mesh.

Every multi-rank run is one module-scoped launch
(``commefficient_tpu_torch.tools.mesh_cases``: 2 gloo ranks for every
case, 4 for the row exchange) that writes each rank's arrays to ``.npz``
files; each test reads them:

* the five modes of ``tests/test_mesh.py`` (TinyMLP, W = 8 over 8
  clients, 3 rounds, a permuted cohort a round, the last one padded and
  ragged; three classes, since two give exactly mirrored gradient pairs
  whose top-k order the summation order decides) against the
  reference's ``make_mesh(2)`` round at ``test_torch_modes.py``'s
  tolerances (loss rtol 1e-5, bytes exact,
  weights atol 1e-6, rows rtol 1e-5 / atol 1e-6), and against the port's
  one-process round at the reference's mesh tolerance (rtol 2e-4, atol
  2e-5);
* every rank's replicated state bitwise the others' after every round;
* the row exchange on 4 ranks, offload on a mesh, the buffered server on
  a mesh, the mesh checkpoint across packages and a resume, and both
  entry points' ``train`` on a mesh with a scan window;
* (ROADMAP.md C20) the GPT2 entry point's ``--mesh clients=2
  --moe_experts 4`` round at capacity factor 1.25 on gpt2-tiny, the
  capacity binding: round 1's drop set token for token the one-process
  round's (the reference's fused round routes every client's tokens as
  one call), and the rounds against the reference's ``make_mesh(2)``
  round (weights atol 2e-4, nll within 1e-3).

The grammar of ``--mesh`` and the refusals run in this process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.losses import make_cv_loss as jax_cv_loss
from commefficient_tpu.models import TinyMLP as JaxTinyMLP
from commefficient_tpu.parallel import make_mesh as jax_make_mesh
from commefficient_tpu.training.args import parse_mesh as jax_parse_mesh
from commefficient_tpu.training.args import \
    round_up_workers_for_mesh as jax_round_up
from commefficient_tpu.utils import checkpoint as jax_ckpt
from commefficient_tpu_torch.parallel.mesh import clients_size
from commefficient_tpu_torch.tools import mesh_cases
from commefficient_tpu_torch.training import cv as port_cv
from commefficient_tpu_torch.training.args import (build_parser, parse_mesh,
                                                   round_up_workers_for_mesh)
from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
from commefficient_tpu_torch.training.gpt2 import main as gpt2_main
from commefficient_tpu_torch.utils import checkpoint as port_ckpt
from commefficient_tpu_torch.utils.params import params_from_jax

CASES_2 = ("modes", "offload", "buffered", "ckpt", "cli")
#: in the same launch; its routing records are each rank's own tokens'
C20_CASE = "moe_c20"
#: the reference's byte tokenizer (the CLI's vocab without a local cache)
BYTE_VOCAB = 261
SEED = 21
MESH_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_learner(kw, mesh, params):
    model = JaxTinyMLP(num_classes=mesh_cases.CLASSES, hidden=8)
    cfg = JaxConfig(num_workers=mesh_cases.W, num_clients=mesh_cases.CLIENTS,
                    lr_scale=0.1, weight_decay=0, **kw)
    return JaxLearner(model, cfg, jax_cv_loss(model), None,
                      jax.random.PRNGKey(0), np.zeros((1, 8), np.float32),
                      mesh=mesh, init_params=params)


def _jax_rounds(jl, problem):
    out = []
    for ids, (X, y), mask in problem:
        m = jl.train_round(ids.astype(np.int32), (X, y.astype(np.int32)),
                           mask)
        out.append([float(m[k]) for k in mesh_cases.ROUND_KEYS])
    return np.asarray(out)


@pytest.fixture(scope="module")
def params():
    model = JaxTinyMLP(num_classes=mesh_cases.CLASSES, hidden=8)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)),
                      train=False)["params"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, params):
    """The launches: every case on 2 ranks, the row exchange on 4."""
    out = str(tmp_path_factory.mktemp("mesh"))
    init = {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(params)).items()}
    np.savez(os.path.join(out, "init.npz"), **init)
    # a reference file for the port's mesh to load
    jl = _jax_learner(mesh_cases.CKPT_KW, None, params)
    ref_rounds = _jax_rounds(jl, mesh_cases.make_problem()[:2])
    fn = jax_ckpt.save_checkpoint(os.path.join(out, "ref"), jl, "ref")
    os.replace(fn, os.path.join(out, "ref_ckpt.npz"))
    np.savez(os.path.join(out, "moe_cli_init.npz"), **_ref_moe_cli_init())
    mesh_cases.launch(out, CASES_2 + (C20_CASE,), ranks=2)
    mesh_cases.launch(out, ["rows"], ranks=4)
    return {"dir": out, "init": init, "ref_learner": jl,
            "ref_rounds": ref_rounds}


def _ref_moe_cli_init():
    """The reference GPT2 entry point's initial weights for the MoE
    problem (gpt2-tiny with 4 experts on the byte tokenizer, ``--seed``),
    as port arrays."""
    from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
    from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
    cfg = JConfig.tiny(vocab_size=BYTE_VOCAB)
    cfg.moe_experts = mesh_cases.MOE_EXPERTS
    ids = np.zeros((1, 2, mesh_cases.SEQ_T), np.int32)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    params = JModel(cfg).init(init_rng, ids, ids, np.zeros((1, 2), np.int32),
                              train=False)["params"]
    return {k: v.numpy() for k, v in
            params_from_jax(jax.device_get(params)).items()}


def _ref_moe_round(tmp_path_factory, mode, capacity, mesh_spec):
    """The reference entry point's MoE rounds of the problem on
    ``mesh_spec``: (rounds' metrics, final weights, validation nll)."""
    from commefficient_tpu.federated.api import FedLearner as JaxLearner
    from commefficient_tpu.training.gpt2 import build_gpt2_parser as jp
    from commefficient_tpu.training.gpt2 import train as jax_train
    rounds = []
    saved = JaxLearner.finalize_round_metrics

    def recording(self, raw):
        out = saved(self, raw)
        rounds.append([float(out[k]) for k in mesh_cases.ROUND_KEYS])
        return out
    JaxLearner.finalize_round_metrics = recording
    try:
        args = jp().parse_args(mesh_cases.moe_cli_argv(
            mode, capacity, str(tmp_path_factory.mktemp("ref_moe")))
            + ["--mesh", mesh_spec])
        mesh = jax_parse_mesh(args.mesh)
        jax_round_up(args, mesh)
        np.random.seed(args.seed)
        learner, row = jax_train(args, mesh=mesh,
                                 max_rounds=mesh_cases.MOE_CLI_ROUNDS,
                                 log=False)
    finally:
        JaxLearner.finalize_round_metrics = saved
    return (np.asarray(rounds), np.asarray(learner.state.weights),
            float(row["nll"]))


def _load(runs, case, rank=0):
    return dict(np.load(os.path.join(runs["dir"], f"{case}_rank{rank}.npz")))


_ONE = {}


def _one_process(runs, case):
    if case not in _ONE:
        _ONE[case] = mesh_cases.run_one_process(case, runs["dir"],
                                                init=runs["init"])
    return _ONE[case]


_JAX = {}


@pytest.fixture(scope="module")
def jax_mesh_modes(params):
    """The reference's make_mesh(2) round in each mode, on the cases'
    problem."""
    def get(mode):
        if mode not in _JAX:
            jl = _jax_learner(mesh_cases.MODES[mode], jax_make_mesh(2),
                              params)
            metrics = _jax_rounds(jl, mesh_cases.make_problem())
            _JAX[mode] = (jl, metrics)
        return _JAX[mode]
    return get


# --------------------------------------------------------------------------
# the grammar and the refusals (in process)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "clients=2", "clients=4", "clients=2,seq=1", "clients=2,model=1",
    "clients=1,stage=1,expert=1", "clients=2,model=2", "clients=2,seq=2",
    "clients", "clients=2,foo=1", "clients=0", "clients=2,seq=0",
    "clients=2,seq=2,model=2", "model=-1"])
def test_parse_mesh_matches_reference(spec):
    """The same strings parse to the same axis sizes, or raise the same
    error with the same message, as the reference's ``parse_mesh``."""
    try:
        ref = jax_parse_mesh(spec)
    except Exception as e:   # noqa: BLE001  (the reference's own type)
        with pytest.raises(type(e)) as got:
            parse_mesh(spec)
        assert str(got.value) == str(e)
        return
    got = parse_mesh(spec)
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)


@pytest.mark.parametrize("workers", [4, 5, 7])
def test_round_up_workers_matches_reference(workers, capsys):
    a = build_parser().parse_args(["--num_workers", str(workers)])
    b = build_parser().parse_args(["--num_workers", str(workers)])
    assert round_up_workers_for_mesh(a, parse_mesh("clients=4")) == \
        jax_round_up(b, jax_parse_mesh("clients=4")) == 4
    assert a.num_workers == b.num_workers
    assert clients_size(parse_mesh("clients=4")) == 4
    assert clients_size(None) == 1


@pytest.mark.parametrize("axis,message", [
    ("seq", "CV models have no sequence axis"),
    ("model", "CV models have no TP layout"),
    ("stage", "CV models have no stacked block trunk"),
    ("expert", "CV models have no MoE blocks")])
def test_cv_inner_axis_raises_reference_valueerror(tmp_path, axis, message):
    args = build_parser().parse_args([
        "--device", "cpu", "--mesh", f"clients=2,{axis}=2",
        "--dataset_dir", str(tmp_path)])
    with pytest.raises(ValueError, match=message):
        port_cv.train(args, max_rounds=1, log=False)


def test_gpt2_serve_online_with_mesh_raises_reference_valueerror(tmp_path):
    with pytest.raises(ValueError, match="drop the mesh"):
        gpt2_main(["--device", "cpu", "--serve_online", "--server_mode",
                   "buffered", "--mesh", "clients=2",
                   "--dataset_dir", str(tmp_path)])


def test_gpt2_inner_axis_is_a12(tmp_path):
    """The seq and stage axes run since A12's seq and stage axes
    (``tests/test_torch_seq.py``, ``tests/test_torch_pp.py``) and keep
    the reference's ValueErrors: blockwise attention on a seq axis, and a
    stage axis off the fused round."""
    from commefficient_tpu_torch.training.gpt2 import train
    args = build_gpt2_parser().parse_args([
        "--device", "cpu", "--mesh", "clients=2,stage=2", "--mode",
        "local_topk", "--error_type", "local", "--k", "10", "--mc_coef",
        "0", "--dataset_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="stage=2 requires the fused"):
        train(args, mesh=parse_mesh(args.mesh), max_rounds=1, log=False)
    args = build_gpt2_parser().parse_args([
        "--device", "cpu", "--mesh", "clients=2,seq=2", "--attn_impl",
        "blockwise", "--dataset_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="cannot shard the sequence"):
        train(args, mesh=parse_mesh(args.mesh), max_rounds=1, log=False)


# --------------------------------------------------------------------------
# the five modes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(mesh_cases.MODES))
def test_mesh_modes_match_jax_mesh(runs, jax_mesh_modes, mode):
    got = _load(runs, "modes")
    jl, ref = jax_mesh_modes(mode)
    m = got[f"{mode}/metrics"]
    np.testing.assert_allclose(m[:, 0], ref[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(m[:, 1:], ref[:, 1:])
    close = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[f"{mode}/weights"],
                               np.asarray(jl.state.weights), **close)
    for f in ("Vvelocity", "Verror"):
        np.testing.assert_allclose(got[f"{mode}/{f}"],
                                   np.asarray(getattr(jl.state.opt, f)),
                                   **close)
    np.testing.assert_array_equal(got[f"{mode}/last_changed"],
                                  np.asarray(jl.state.last_changed))
    np.testing.assert_array_equal(got[f"{mode}/client_last_round"],
                                  np.asarray(jl.state.client_last_round))
    for f in ("velocities", "errors"):
        if f"{mode}/rows_{f}" in got:
            np.testing.assert_allclose(
                got[f"{mode}/rows_{f}"],
                np.asarray(getattr(jl.state.clients, f)), rtol=1e-5,
                atol=1e-6)


@pytest.mark.parametrize("mode", list(mesh_cases.MODES))
def test_mesh_modes_match_one_process(runs, mode):
    got, one = _load(runs, "modes"), _one_process(runs, "modes")
    np.testing.assert_allclose(got[f"{mode}/metrics"][:, 0],
                               one[f"{mode}/metrics"][:, 0], rtol=2e-4)
    np.testing.assert_array_equal(got[f"{mode}/metrics"][:, 1:],
                                  one[f"{mode}/metrics"][:, 1:])
    for key in one:
        if key.startswith(f"{mode}/") and not key.endswith("digests"):
            np.testing.assert_allclose(got[key], one[key], **MESH_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("case", CASES_2)
def test_ranks_bitwise_every_round(runs, case):
    """Every rank's replicated state has the same bytes after every round,
    and the joined rows are the same arrays on both ranks."""
    a, b = _load(runs, case, 0), _load(runs, case, 1)
    digests = [k for k in a if k.endswith("digests") or k.endswith("digest")]
    assert digests
    for k in a:
        if k.endswith("shard_reads") or k.endswith("shard_writes"):
            continue
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_row_exchange_on_four_ranks(runs, jax_mesh_modes):
    """At 4 ranks a cohort's rows come from every owner: each rank holds
    its block of n/N rows (and its sink), and the joined rows match the
    reference's mesh rows."""
    per = mesh_cases.CLIENTS // 4
    jl, ref = jax_mesh_modes("local_topk")
    ranks = [_load(runs, "rows", r) for r in range(4)]
    for got in ranks:
        assert tuple(got["block_shape"]) == (per + 1,
                                             got["weights"].shape[0])
        np.testing.assert_array_equal(got["digests"], ranks[0]["digests"])
    got = ranks[0]
    np.testing.assert_allclose(got["metrics"][:, 0], ref[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(got["metrics"][:, 1:], ref[:, 1:])
    for f in ("velocities", "errors"):
        np.testing.assert_allclose(got[f"rows_{f}"],
                                   np.asarray(getattr(jl.state.clients, f)),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# offload and the buffered server on a mesh
# --------------------------------------------------------------------------


def test_offload_on_mesh_bitwise_device_rows(runs):
    got = _load(runs, "offload")
    np.testing.assert_array_equal(got["offload/digests"],
                                  got["device/digests"])
    for f in ("velocities", "errors"):
        np.testing.assert_array_equal(got[f"offload/rows_{f}"],
                                      got[f"device/rows_{f}"])


@pytest.mark.parametrize("tag", ["offload", "sparse"])
def test_offload_shards_count_their_own_rows(runs, tag):
    """Each rank's arena is its own shard: its reads and writes land there
    and nowhere else."""
    for r in range(2):
        got = _load(runs, "offload", r)
        reads, writes = got[f"{tag}/shard_reads"], got[f"{tag}/shard_writes"]
        assert reads[r] > 0 and writes[r] > 0
        assert reads[1 - r] == 0 and writes[1 - r] == 0


def test_sparse_offload_on_mesh_matches_one_process(runs):
    got, one = _load(runs, "offload"), _one_process(runs, "offload")
    for key in one:
        if key.startswith("sparse/") and not key.endswith("digests") \
                and "shard" not in key:
            np.testing.assert_allclose(got[key], one[key], **MESH_TOL,
                                       err_msg=key)


def test_lockstep_buffered_mesh_bitwise_sync_mesh(runs):
    got = _load(runs, "buffered")
    np.testing.assert_array_equal(got["lockstep/digests"],
                                  got["sync/digests"])
    np.testing.assert_array_equal(got["lockstep/metrics"],
                                  got["sync/metrics"])


def test_fault_schedule_device_count_independent(runs):
    """The fault model's schedule reads only the whole cohort: the mesh's
    is the one process's, and so is the trajectory, at mesh tolerance."""
    got, one = _load(runs, "buffered"), _one_process(runs, "buffered")
    np.testing.assert_array_equal(got["faults/schedule"],
                                  one["faults/schedule"])
    assert float(got["faults/sim_time"]) == float(one["faults/sim_time"])
    assert got["faults/schedule"][2] > 0   # a crash was drawn
    for key in ("weights", "rows_errors", "rows_velocities"):
        np.testing.assert_allclose(got[f"faults/{key}"],
                                   one[f"faults/{key}"], **MESH_TOL)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _saved_file(runs):
    return os.path.join(runs["dir"], "ckpt", "mesh.npz")


def test_mesh_checkpoint_loads_in_one_process_port(runs):
    saved = _load(runs, "ckpt")
    ln = mesh_cases.build(mesh_cases.CKPT_KW, None, init=runs["init"])
    port_ckpt.load_checkpoint(_saved_file(runs), ln)
    got = mesh_cases.final_state(ln)
    for key, val in got.items():
        np.testing.assert_array_equal(val, saved[f"saved/{key}"],
                                      err_msg=key)


def test_mesh_checkpoint_loads_in_jax(runs, params):
    saved = _load(runs, "ckpt")
    jl = _jax_learner(mesh_cases.CKPT_KW, None, params)
    jax_ckpt.load_checkpoint(_saved_file(runs), jl)
    np.testing.assert_array_equal(np.asarray(jl.state.weights),
                                  saved["saved/weights"])
    for f in ("velocities", "errors"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jl.state.clients, f)), saved[f"saved/rows_{f}"])
    assert int(jl.state.round_idx) == 2


def test_jax_checkpoint_loads_on_mesh(runs):
    got, jl = _load(runs, "ckpt"), runs["ref_learner"]
    np.testing.assert_array_equal(got["loaded/weights"],
                                  np.asarray(jl.state.weights))
    for f in ("velocities", "errors"):
        np.testing.assert_array_equal(
            got[f"loaded/rows_{f}"], np.asarray(getattr(jl.state.clients, f)))
    np.testing.assert_array_equal(got["loaded/last_changed"],
                                  np.asarray(jl.state.last_changed))


def test_resume_on_mesh_bitwise_uninterrupted(runs):
    got = _load(runs, "ckpt")
    np.testing.assert_array_equal(got["resumed/digests"],
                                  got["full/digests"][1:])
    for key in got:
        if key.startswith("full/") and not key.endswith("digests") \
                and not key.endswith("metrics"):
            np.testing.assert_array_equal(
                got[key.replace("full/", "resumed/")], got[key], err_msg=key)


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["cv", "gpt2"])
def test_entry_point_on_mesh_matches_one_process(runs, entry):
    """``train(args, mesh=...)`` of each entry point on 2 ranks against one
    process: bytes exact, loss at mesh tolerance."""
    got = _load(runs, "cli")
    args = mesh_cases.cli_args(entry, runs["dir"])
    if entry == "cv":
        args.do_test = False
    one = mesh_cases.cli_rounds(entry, args, None, 2)
    m = got[f"{entry}/metrics"]
    assert m.shape == (2, len(mesh_cases.ROUND_KEYS))
    np.testing.assert_allclose(m[:, 0], one["metrics"][:, 0], rtol=2e-4)
    np.testing.assert_array_equal(m[:, 1:], one["metrics"][:, 1:])
    np.testing.assert_allclose(got[f"{entry}/weights"], one["weights"],
                               **MESH_TOL)


def test_scan_window_on_mesh_bitwise_single_rounds(runs):
    got = _load(runs, "cli")
    assert got["cv_scan3/metrics"].shape[0] == 6
    np.testing.assert_array_equal(got["cv_scan3/metrics"],
                                  got["cv_scan1/metrics"])
    assert str(got["cv_scan3/digest"]) == str(got["cv_scan1/digest"])


def test_cv_cli_main_runs_on_mesh(tmp_path, capfd):
    """The CLI itself: ``main`` launches 2 gloo ranks on the CPU, and
    rank 0 alone prints."""
    rc = port_cv.main([
        "--device", "cpu", "--mesh", "clients=2", "--model", "TinyMLP",
        "--mode", "local_topk", "--error_type", "local", "--k", "50",
        "--num_workers", "3", "--local_batch_size", "4",
        "--dataset_dir", str(tmp_path), "--test"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "rounding num_workers 3 -> 4" in out
    assert out.count("final:") == 1 and out.count("round 1:") == 1


def test_sigterm_on_mesh_finishes_round_saves_and_exits(tmp_path):
    """The preemption contract on 2 ranks: SIGTERM to the CLI's launcher
    reaches both ranks, which finish the round in flight, agree to stop,
    write one step file (rank 0) and exit 0; the file loads in one
    process."""
    import signal
    import subprocess
    import sys
    import time

    ckpt = tmp_path / "ckpt"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    child = subprocess.Popen(
        [sys.executable, "-m", "commefficient_tpu_torch.training.cv",
         "--device", "cpu", "--mesh", "clients=2", "--model", "TinyMLP",
         "--mode", "local_topk", "--error_type", "local", "--k", "50",
         "--num_workers", "4", "--local_batch_size", "4",
         "--dataset_dir", str(tmp_path / "data"), "--num_epochs", "3",
         "--checkpoint", "--checkpoint_path", str(ckpt),
         "--checkpoint_every_rounds", "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        t0 = time.time()
        while not (ckpt / "TinyMLP.latest").exists():
            assert child.poll() is None, child.stdout.read()
            assert time.time() - t0 < 120
            time.sleep(0.05)
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == 0, out
    assert out.count("checkpoint:") >= 2 and "'preempted': True" in out
    assert out.count("signal 15") == 1   # rank 0 alone says so
    fn = port_ckpt.find_latest_checkpoint(str(ckpt), "TinyMLP")
    args = build_parser().parse_args([
        "--device", "cpu", "--model", "TinyMLP", "--mode", "local_topk",
        "--error_type", "local", "--k", "50", "--num_workers", "4",
        "--local_batch_size", "4", "--dataset_dir", str(tmp_path / "data"),
        "--num_epochs", "3", "--resume", fn])
    learner, row = port_cv.train(args, max_rounds=1, log=False)
    assert learner.rounds_done >= 3


# --------------------------------------------------------------------------
# C20: whole-batch MoE routing on a clients axis
# --------------------------------------------------------------------------


def test_moe_routing_on_clients_mesh_is_whole_batch(runs, tmp_path_factory):
    """``--mesh clients=2 --moe_experts 4`` at capacity factor 1.25: the
    capacity binds (an expert gets more tokens than its slots in round
    1, as ``tests/test_moe.py:83-99`` asserts), the ranks' keep masks of
    round 1 joined in rank order are the one-process round's token for
    token, the ranks are bitwise every round, and the rounds match the
    reference's ``make_mesh(2)`` round."""
    recs = [_load(runs, C20_CASE, r) for r in range(2)]
    one = _one_process(runs, C20_CASE)
    n_layer = mesh_cases.moe_gpt2_config().n_layer
    bound = 0
    for i in range(n_layer):
        cap = int(one[f"route{i}/capacity"])
        counts = np.bincount(one[f"route{i}/expert"],
                             minlength=mesh_cases.MOE_EXPERTS)
        bound += int(counts.max() > cap)
        for rec in recs:
            assert int(rec[f"route{i}/capacity"]) == cap
        for key in ("expert", "keep"):
            np.testing.assert_array_equal(
                np.concatenate([rec[f"route{i}/{key}"] for rec in recs]),
                one[f"route{i}/{key}"], err_msg=f"block {i} {key}")
    assert bound, "the capacity must bind in some block"
    for rec in recs:
        for key in ("digests", "weights", "metrics"):
            np.testing.assert_array_equal(rec[key], recs[0][key])
    rounds, w_ref, nll_ref = _ref_moe_round(
        tmp_path_factory, *mesh_cases.C20_RUN, "clients=2")
    got = recs[0]
    np.testing.assert_allclose(got["metrics"][:, :2], rounds[:, :2],
                               rtol=2e-4)
    np.testing.assert_array_equal(got["metrics"][:, 2:], rounds[:, 2:])
    np.testing.assert_allclose(got["weights"], w_ref, atol=2e-4)
    assert float(got["nll"]) == pytest.approx(nll_ref, abs=1e-3)
