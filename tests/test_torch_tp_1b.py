"""A12 item 1b on ``torch.distributed``: offloaded client rows, the
buffered server and ``--grad_buckets`` on the ``model`` axis, against the
reference's GSPMD layout on the CPU.

One module-scoped launch of 4 gloo ranks (``tools/mesh_cases.py``'s
``tp_1b`` case on a ``make_mesh(4, model=2)`` mesh: two client shards of
a 2-way model axis) runs gpt2-tiny (T 16, 2 workers of 4 clients, the
reference's ``tests/test_mesh.py:87-112`` problem, its initial weights
from the reference's learner), 4 rounds a run:

* lock-step buffered sketch mode, buffered local_topk under a seeded
  fault model (buffer_m 2), local_topk with dense and sparse
  ``--client_state_offload``, sketch and uncompressed with
  ``--grad_buckets 3``: against the reference's ``make_mesh(4,
  model=2)`` runs at rtol 2e-4 / atol 2e-5 (the fault schedule exactly),
  every rank's replicated state bitwise the others' every round;
* the offloaded rows bitwise their device-resident twins', each rank's
  arena holding its row shard (and, dense, its coordinate block);
* a buffered 2-D checkpoint loaded across the packages both ways, and
  the lock-step buffered and offloaded runs resumed from a step file
  after 2 rounds bitwise the uninterrupted 4.

Every rank and the test process run one intra-op thread.
"""

import os

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.config import FedConfig as JaxConfig
from commefficient_tpu.federated.api import FedLearner as JaxLearner
from commefficient_tpu.federated.buffer import \
    BufferedFedLearner as JaxBuffered
from commefficient_tpu.federated.faults import FaultModel as JaxFaults
from commefficient_tpu.federated.losses import \
    make_gpt2_train_loss as jax_gpt2_loss
from commefficient_tpu.models.gpt2 import GPT2Config as JConfig
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JModel
from commefficient_tpu.parallel import make_mesh as jax_make_mesh
from commefficient_tpu.parallel.tp import gpt2_tp_specs as jax_tp_specs
from commefficient_tpu.utils import checkpoint as jax_ckpt
from commefficient_tpu_torch.tools import mesh_cases as mc
from commefficient_tpu_torch.utils.params import params_from_jax

RANKS, MODEL = 4, 2
MESH_TOL = dict(rtol=2e-4, atol=2e-5)
#: the runs held against the reference (the device twins are held
#: against their offloaded runs)
REF_TAGS = ("lockstep", "faults", "offload_dense", "offload_sparse",
            "buckets_sketch", "buckets_uncompressed")


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


def _jax_learner(jax_problem, tag, mesh=True):
    """The reference's learner of ``mc.TP_1B[tag]`` (on its ``make_mesh(4,
    model=2)`` mesh, or one device with ``mesh`` False)."""
    wrap, loss, sample_in, _, _ = jax_problem
    mode, extra, kind = mc.TP_1B[tag]
    cfg = JaxConfig(num_workers=mc.TP_W, num_clients=mc.TP_CLIENTS,
                    lr_scale=0.05, weight_decay=0, max_seq_len=mc.TP_T,
                    **dict(mc.TP_MODES[mode], **extra))
    kw, specs = {}, None
    if kind == "faults":
        fm = mc.tp_fault_model()
        kw["fault_model"] = JaxFaults(
            fm.seed, mc.TP_CLIENTS, base_latency=fm.base_latency,
            latency_sigma=fm.latency_sigma,
            straggler_frac=fm.straggler_frac,
            straggler_mult=fm.straggler_mult,
            dropout_prob=fm.dropout_prob, crash_prob=fm.crash_prob)
    grid = jax_make_mesh(4, model=2) if mesh else None
    if mesh:
        probe = JaxLearner(wrap, JaxConfig(
            num_workers=mc.TP_W, num_clients=mc.TP_CLIENTS,
            max_seq_len=mc.TP_T), loss, None, jax.random.PRNGKey(0),
            sample_in)
        specs = jax_tp_specs(probe.unflatten(probe.state.weights))
    cls = JaxLearner if kind == "sync" else JaxBuffered
    return cls(wrap, cfg, loss, None, jax.random.PRNGKey(0), sample_in,
               mesh=grid, param_specs=specs, **kw)


def _jax_run(jl, jax_problem, tag):
    """``mc.TP_1B_ROUNDS`` rounds (or cohorts, then the flush): the
    per-round metrics rows."""
    _, _, _, batch, mask = jax_problem
    ids = np.arange(mc.TP_W)
    faults = mc.TP_1B[tag][2] == "faults"
    rows = []
    for _ in range(mc.TP_1B_ROUNDS):
        m = (jl.finalize_round_metrics(jl.train_round_async(ids, batch,
                                                            mask))
             if faults else jl.train_round(ids, batch, mask))
        rows.append([float(m[k]) for k in mc.ROUND_KEYS])
    if faults:
        jl.flush_faults()
    return np.asarray(rows)


@pytest.fixture(scope="module")
def refs(jax_problem):
    """The reference's run of every ``REF_TAGS`` entry."""
    out = {}
    for tag in REF_TAGS:
        jl = _jax_learner(jax_problem, tag)
        out[tag] = (jl, _jax_run(jl, jax_problem, tag))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_problem, refs):
    """The launch: ``tp_1b`` on 4 ranks (2 x 2), from the reference's
    initial weights, with the reference's buffered 2-D file to load."""
    out = str(tmp_path_factory.mktemp("tp_1b"))
    jl = _jax_learner(jax_problem, "lockstep", mesh=False)
    init = params_from_jax(jax.device_get(jl.unflatten(jl.state.weights)))
    np.savez(os.path.join(out, "tp_init.npz"),
             **{k: v.numpy() for k, v in init.items()})
    ref = refs["lockstep"][0]
    fn = jax_ckpt.save_checkpoint(os.path.join(out, "ref"), ref, "ref")
    os.replace(fn, os.path.join(out, "ref_tp_buffered.npz"))
    mc.launch(out, ["tp_1b"], ranks=RANKS, model=MODEL)
    return {"dir": out, "recs": [
        dict(np.load(os.path.join(out, f"tp_1b_rank{r}.npz")))
        for r in range(RANKS)]}


def _per_round(rec, tag):
    """The per-round digests (a buffered run under faults has one, after
    its flush)."""
    return rec.get(f"{tag}/digests", rec.get(f"{tag}/digest"))


@pytest.mark.parametrize("tag", REF_TAGS)
def test_1b_matches_reference_2d_mesh(runs, refs, tag):
    recs = runs["recs"]
    for rec in recs:
        np.testing.assert_array_equal(_per_round(rec, tag),
                                      _per_round(recs[0], tag))
        np.testing.assert_array_equal(rec[f"{tag}/weights"],
                                      recs[0][f"{tag}/weights"])
    got = recs[0]
    jl, ref = refs[tag]
    w_ref = np.asarray(jl.state.weights)
    assert got[f"{tag}/weights"].shape == w_ref.shape
    np.testing.assert_allclose(got[f"{tag}/weights"], w_ref, **MESH_TOL)
    np.testing.assert_array_equal(got[f"{tag}/client_last_round"],
                                  np.asarray(jl.state.client_last_round))
    assert int(got[f"{tag}/round_idx"]) == int(jl.state.round_idx)
    if mc.TP_1B[tag][2] == "faults":
        st = jl.fault_stats
        want = [st[k] for k in ("dispatched", "dropouts", "crashes",
                                "arrivals", "applies", "partial_applies")]
        assert got[f"{tag}/schedule"].tolist() == want + [jl.applies_done]
        assert float(got[f"{tag}/sim_time"]) == jl.sim_time
        assert st["dropouts"] + st["crashes"] > 0
        return
    m = got[f"{tag}/metrics"]
    # the loss and download bytes at the mesh tolerance (see
    # test_torch_tp.py: one coordinate's exact zero moves the count)
    np.testing.assert_allclose(m[:, :2], ref[:, :2], **MESH_TOL)
    np.testing.assert_array_equal(m[:, 2:], ref[:, 2:])


@pytest.mark.parametrize("codec", ["dense", "sparse"])
def test_offloaded_rows_bitwise_device_resident(runs, codec):
    d_pad = runs["recs"][0]["offload_dense/weights"].shape[0]
    for rec in runs["recs"]:
        off, dev = f"offload_{codec}", f"device_{codec}"
        keys = sorted(k for k in rec if k.startswith(off + "/rows_"))
        assert keys
        for k in keys:
            np.testing.assert_array_equal(rec[k], rec[k.replace(off, dev)])
        np.testing.assert_array_equal(rec[f"{off}/digests"],
                                      rec[f"{dev}/digests"])
        # a rank's arena: its 2 of the 4 clients' rows; the dense codec's
        # coordinate block of each, the sparse codec's k pairs whole
        want = ([2, d_pad // MODEL] if codec == "dense"
                else [2, mc.TP_MODES["local_topk"]["k"]])
        assert rec[f"{off}/arena_shape"].tolist() == want


def test_buffered_2d_checkpoint_loads_across_packages(runs, refs,
                                                      jax_problem):
    got = runs["recs"][3]
    # the reference's buffered 2-D file on the port's mesh
    ref = refs["lockstep"][0]
    np.testing.assert_array_equal(got["loaded/weights"],
                                  np.asarray(ref.state.weights))
    np.testing.assert_array_equal(got["loaded/Vvelocity"],
                                  np.asarray(ref.state.opt.Vvelocity))
    # the port's buffered 2-D file on the reference's mesh
    jl = _jax_learner(jax_problem, "lockstep")
    jax_ckpt.load_checkpoint(os.path.join(runs["dir"], "tp_1b_ckpt",
                                          "tp.npz"), jl)
    np.testing.assert_array_equal(np.asarray(jl.state.weights),
                                  got["lockstep/weights"])
    np.testing.assert_array_equal(np.asarray(jl.state.opt.Vvelocity),
                                  got["lockstep/Vvelocity"])
    assert int(jl.state.round_idx) == mc.TP_1B_ROUNDS


@pytest.mark.parametrize("tag", mc.TP_1B_RESUME)
def test_2d_resume_is_bitwise_the_uninterrupted_run(runs, tag):
    half = mc.TP_1B_ROUNDS // 2
    for rec in runs["recs"]:
        np.testing.assert_array_equal(rec[f"{tag}_resumed/digests"],
                                      rec[f"{tag}/digests"][half:])
        np.testing.assert_array_equal(rec[f"{tag}_resumed/metrics"],
                                      rec[f"{tag}/metrics"][half:])
        rows = sorted(k for k in rec if k.startswith(f"{tag}/rows_"))
        for k in rows:
            np.testing.assert_array_equal(
                rec[k.replace(f"{tag}/", f"{tag}_resumed/")], rec[k])
