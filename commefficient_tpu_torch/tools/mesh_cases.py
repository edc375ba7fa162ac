"""The meshes' cases, computed on every rank of one launch.

    python -m commefficient_tpu_torch.tools.mesh_cases --out DIR \
        [--ranks 2] [--model 1] [--device cpu] [--cases modes,offload,...]

Each rank runs the named cases and writes ``DIR/{case}_rank{r}.npz``:
the per-round metrics, a digest of the replicated state after every
round (weights, server momentum and error, round and byte bookkeeping:
every rank's must be the same bits), and the final state with the client
rows joined from every rank's block. The tests read these files against
the reference's ``jax.sharding.Mesh`` round and against one process; the
problem is ``tests/test_mesh.py``'s (TinyMLP, 8 workers over 8 clients)
with three classes, a permuted cohort a round so that rows cross owners,
and a padded, ragged last round. ``DIR/init.npz``, when present, holds
the initial weights (a torch state dict); else they are drawn from seed
0.

Cases: ``modes`` (the five modes), ``rows`` (local_topk's rows, for a
launch with 4 ranks), ``offload`` (local_topk's rows offloaded and
device-resident), ``buffered`` (lock-step and under a fault model),
``ckpt`` (a mesh file written, a file from ``DIR/ref_ckpt.npz`` loaded,
and a resume in process), ``cli`` (both entry points' ``train`` on the
mesh, and a scan window).

With ``--model M`` the launch is a 2-D ``clients x model`` mesh
(``make_mesh(ranks, model=M)``) and runs the tensor-parallel cases on
gpt2-tiny (``n_head`` 4, ``n_embd`` 128, 2 layers, T 16; the problem of
the reference's ``tests/test_mesh.py:87-112``, its initial weights from
``DIR/tp_init.npz``): ``tp_grad`` (one forward and gradient on the
model axis, at dropout 0 and with ``tpu_bits`` dropout, both attention
forms), ``tp_modes`` (3 rounds of the five modes, the pads and the
blocks each rank stores, and the whole replicated state's digest a
round), ``tp_ckpt`` (a 2-D file written and ``DIR/ref_tp_ckpt.npz``
loaded), ``tp_serve`` (the four serving modes and the int8/int4 pools
at tp = M, weights from ``DIR/serve_init.npz``), ``tp_cli`` (the GPT2
entry point's ``train``) and ``tp_1b`` (A12 1b: the buffered server,
lock-step and under faults, offloaded dense and sparse rows beside their
device-resident twins, ``--grad_buckets 3`` in sketch and uncompressed
mode, a buffered 2-D checkpoint both ways, and a buffered and an
offloaded run resumed from a step file halfway).

With ``--seq S`` the launch is a ``clients x seq`` mesh (``make_mesh(
ranks, seq=S)``): ``seq_ring`` (ring attention on every rank as one seq
axis, forward and gradient), ``seq_apply`` (``seq_parallel_apply`` of a
ring gpt2-tiny on every rank as one seq axis, weights from
``DIR/seq_apply_init.npz``), ``seq_grad`` (one worker's loss and
gradient summed over the seq axis) and ``seq_cli`` (the GPT2 entry
point's ``train`` with ring attention, initial weights from
``DIR/seq_init.npz``).

With ``--stage S`` the launch is a ``clients x stage`` mesh (``make_mesh(
ranks, stage=S)``): ``pp_apply`` (``gpt2_pp_lm_apply`` of gpt2-tiny on
the mesh's stage axis and, for 4 stages, on every rank as one: logits,
gradient, dropout; weights from ``DIR/pp_{tag}_init.npz``), ``pp_grad``
(one worker's LM loss and gradient summed over the stage axis) and
``pp_cli`` (the GPT2 entry point's ``train`` with ``--mc_coef 0``, and a
run saved after round 1 and resumed, initial weights from
``DIR/pp_cli_init.npz``).

With ``--expert E`` the launch is a ``clients x expert`` mesh
(``make_mesh(ranks, expert=E)``): ``ep_layer`` (the MoE layer's output
and a binding-capacity trajectory on the expert axis, weights from
``DIR/ep_{layer,traj}_init.npz``), ``ep_gpt2`` (gpt2-tiny with 4 experts:
logits and one worker's gradient, weights from ``DIR/ep_gpt2_init.npz``)
``ep_cli`` (the GPT2 entry point's MoE rounds at capacity factors 1.25
and 100, with a resume) and ``ep_flags`` (the buffered server under
faults and ``--grad_buckets`` there). ``tp_moe`` runs the MoE rounds on a model
axis and ``moe_c20`` on a clients mesh, with round 1's routing (initial
weights from ``DIR/moe_cli_init.npz``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.buffer import BufferedFedLearner
from commefficient_tpu_torch.federated.faults import FaultModel
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.federated.round import split_leaves
from commefficient_tpu_torch.federated.state import CLIENT_STATE_FIELDS
from commefficient_tpu_torch.models import TinyMLP
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as mesh_lib

W = CLIENTS = 8
ROUNDS = 3
#: the five modes of the reference's tests/test_mesh.py
MODES = {
    "uncompressed": dict(mode="uncompressed", virtual_momentum=0.9,
                         error_type="none"),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=20,
                      virtual_momentum=0.9),
    "local_topk": dict(mode="local_topk", error_type="local", k=20,
                       local_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=20, num_rows=3, num_cols=500),
    "fedavg": dict(mode="fedavg", error_type="none", local_batch_size=-1,
                   fedavg_batch_size=8),
}
#: the per-round metrics a case records
ROUND_KEYS = ("loss", "download_bytes", "upload_bytes", "num_datapoints",
              "aborted")


#: three classes: with two, the output layer's gradients come in exactly
#: mirrored pairs (dL/dz0 = -dL/dz1), and a top-k between two equal
#: magnitudes is decided by the last bit of their sums' order, which a
#: mesh rightly changes
CLASSES = 3


def make_problem(rounds: int = ROUNDS, seed: int = 0):
    """``rounds`` of (ids, (X (W, 16, 8), y (W, 16)), mask (W, 16)): a
    permuted cohort a round; in the last, one slot padded (mask 0) and
    one ragged. The label is the largest of the first ``CLASSES``
    features."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rounds):
        X = rng.randn(W, 16, 8).astype(np.float32)
        y = np.argmax(X[:, :, :CLASSES], axis=2).astype(np.int64)
        ids = rng.permutation(CLIENTS).astype(np.int64)
        mask = np.ones((W, 16), np.float32)
        if r == rounds - 1:
            mask[5] = 0
            mask[2, 9:] = 0
        out.append((ids, (X, y), mask))
    return out


def make_model(init: Optional[dict] = None) -> TinyMLP:
    model = TinyMLP(num_classes=CLASSES, hidden=8, in_channels=8,
                    image_size=1)
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init.items()})
    return model


def make_config(mode_kw: dict, **extra) -> FedConfig:
    return FedConfig(num_workers=W, num_clients=CLIENTS, lr_scale=0.1,
                     weight_decay=0, **dict(mode_kw, **extra))


def build(mode_kw: dict, mesh, device="cpu", init=None, cls=FedLearner,
          learner_kw=None, **cfg_extra):
    model = make_model(init)
    return cls(model, make_config(mode_kw, **cfg_extra), make_cv_loss(model),
               None, device=device, mesh=mesh, **(learner_kw or {}))


def host_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes on the host, for a hash (no extra copy)."""
    return memoryview(t.detach().cpu().contiguous().reshape(-1)
                      .numpy()).cast("B")


def state_digest(learner) -> str:
    """sha256 of the replicated state's bytes. On a model axis each rank
    hashes the blocks it stores and the digest is the sha256 of the model
    ranks' digests in rank order (every rank calls it): the same on every
    rank exactly when each block is the same on every client shard."""
    s = learner.state
    h = hashlib.sha256()
    for t in (s.weights, s.opt.Vvelocity, s.opt.Verror, s.round_idx,
              s.last_changed, s.client_last_round, s.aborted,
              s.weights_version, s.quarantine):
        h.update(host_bytes(t))
    if mesh_lib.model_size(learner.mesh) == 1:
        return h.hexdigest()
    mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
    joined = mesh_lib.model_all_gather(mine.to(learner.device),
                                       learner.mesh)
    return hashlib.sha256(host_bytes(joined)).hexdigest()


def joined_rows(learner) -> dict:
    """Every client's encoded rows, ``{field: array}`` (``{field__leaf:
    array}`` for a sparse or sketched codec): the ranks' row blocks (their
    sinks dropped) or offload shards joined in row order."""
    out = {}
    mesh = learner.mesh
    store = learner.host_store
    for field in CLIENT_STATE_FIELDS:
        if store is not None:
            if store.view(field) is None:
                continue
            rows = store.stacked(field)
        else:
            rows = getattr(learner.state.clients, field)
            if rows is None:
                continue
            rows = (rows[:-1] if torch.is_tensor(rows)
                    else {k: v[:-1] for k, v in rows.items()})
        leaves = rows.items() if isinstance(rows, dict) else [(None, rows)]
        split = (mesh_lib.model_size(mesh) > 1
                 and split_leaves(learner.cfg)[1])
        for leaf, t in leaves:
            if mesh is not None:
                t = mesh_lib.all_gather_cat(t.to(learner.device), mesh)
            if split:
                # the dense rows' coordinate blocks
                t = mesh_lib.model_all_gather(t, mesh, dim=1)
            key = field if leaf is None else f"{field}__{leaf}"
            out[key] = t.detach().cpu().numpy()
    return out


def final_state(learner, prefix: str = "") -> dict:
    s = learner.state
    out = {"weights": s.weights, "Vvelocity": s.opt.Vvelocity,
           "Verror": s.opt.Verror, "last_changed": s.last_changed,
           "client_last_round": s.client_last_round,
           "round_idx": s.round_idx}
    out = {k: v.detach().cpu().numpy() for k, v in out.items()}
    out.update({f"rows_{k}": v for k, v in joined_rows(learner).items()})
    return {prefix + k: v for k, v in out.items()}


def run_rounds(learner, problem, prefix: str = "") -> dict:
    """Train ``problem``'s rounds; the metrics and per-round digests."""
    rows, digests = [], []
    for ids, batch, mask in problem:
        m = learner.train_round(ids, batch, mask)
        rows.append([float(m[k]) for k in ROUND_KEYS])
        digests.append(state_digest(learner))
    return {prefix + "metrics": np.asarray(rows, np.float64),
            prefix + "digests": np.asarray(digests)}


def case_modes(mesh, device, init):
    out = {}
    problem = make_problem()
    for name, kw in MODES.items():
        ln = build(kw, mesh, device, init)
        out.update(run_rounds(ln, problem, f"{name}/"))
        out.update(final_state(ln, f"{name}/"))
    return out


def case_rows(mesh, device, init):
    """local_topk's rows: each rank's block shape, and the joined rows."""
    ln = build(MODES["local_topk"], mesh, device, init)
    out = run_rounds(ln, make_problem())
    out.update(final_state(ln))
    out["block_shape"] = np.asarray(ln.state.clients.errors.shape)
    return out


OFFLOAD_KW = dict(MODES["local_topk"], client_state="dense")


def case_offload(mesh, device, init):
    out = {}
    problem = make_problem()
    for tag, extra in (("device", {}),
                       ("offload", dict(client_state_offload=True)),
                       ("sparse", dict(client_state_offload=True,
                                       client_state="sparse"))):
        ln = build(dict(OFFLOAD_KW, **extra), mesh, device, init)
        out.update(run_rounds(ln, problem, f"{tag}/"))
        if tag != "device":
            ln.flush_offload()
            store = ln.host_store
            out[f"{tag}/shard_reads"] = store.shard_reads.copy()
            out[f"{tag}/shard_writes"] = store.shard_writes.copy()
        out.update(final_state(ln, f"{tag}/"))
    return out


def fault_model() -> FaultModel:
    return FaultModel(7, CLIENTS, base_latency=1.0, latency_sigma=0.5,
                      straggler_frac=0.25, straggler_mult=4.0,
                      dropout_prob=0.15, crash_prob=0.1)


def run_buffered_faults(learner, problem) -> dict:
    """Dispatch ``problem``'s cohorts through the event loop, then flush
    it: the schedule (fault counts, applies, sim time) and the weights."""
    for ids, batch, mask in problem:
        learner.finalize_round_metrics(learner.train_round_async(
            ids, batch, mask))
    learner.flush_faults()
    st = learner.fault_stats
    return {"schedule": np.asarray(
        [st[k] for k in ("dispatched", "dropouts", "crashes", "arrivals",
                         "applies", "partial_applies")]
        + [learner.applies_done], np.int64),
            "sim_time": np.asarray(learner.sim_time),
            "digest": np.asarray(state_digest(learner))}


def case_buffered(mesh, device, init):
    out = {}
    problem = make_problem(rounds=4)
    kw = MODES["local_topk"]
    sync = build(kw, mesh, device, init)
    out.update(run_rounds(sync, problem, "sync/"))
    lock = build(kw, mesh, device, init, cls=BufferedFedLearner,
                 server_mode="buffered")
    out.update(run_rounds(lock, problem, "lockstep/"))
    faulty = build(kw, mesh, device, init, cls=BufferedFedLearner,
                   learner_kw=dict(fault_model=fault_model()),
                   server_mode="buffered", buffer_m=4)
    out.update({f"faults/{k}": v
                for k, v in run_buffered_faults(faulty, problem).items()})
    out.update(final_state(faulty, "faults/"))
    return out


CKPT_KW = MODES["local_topk"]


def case_ckpt(mesh, device, init, out_dir):
    from commefficient_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
    out = {}
    problem = make_problem()
    # a mesh file after two rounds
    ln = build(CKPT_KW, mesh, device, init)
    run_rounds(ln, problem[:2])
    save_checkpoint(os.path.join(out_dir, "ckpt"), ln, "mesh")
    out.update(final_state(ln, "saved/"))
    # the reference's file on this mesh
    ref = os.path.join(out_dir, "ref_ckpt.npz")
    if os.path.exists(ref):
        ln = build(CKPT_KW, mesh, device, init)
        load_checkpoint(ref, ln)
        out.update(final_state(ln, "loaded/"))
    # a resume in process: 1 round, save, a new learner, 2 more rounds
    full = build(CKPT_KW, mesh, device, init)
    out.update(run_rounds(full, problem, "full/"))
    out.update(final_state(full, "full/"))
    first = build(CKPT_KW, mesh, device, init)
    run_rounds(first, problem[:1])
    fn = save_checkpoint(os.path.join(out_dir, "resume"), first, "mesh",
                         step=1)
    second = build(CKPT_KW, mesh, device, init)
    load_checkpoint(fn, second)
    out.update(run_rounds(second, problem[1:], "resumed/"))
    out.update(final_state(second, "resumed/"))
    return out


def cli_args(entry: str, out_dir: str, *extra):
    """The entry point's parsed flags for the ``cli`` case."""
    if entry == "cv":
        from commefficient_tpu_torch.training.args import build_parser
        argv = ["--device", "cpu", "--model", "TinyMLP", "--mode", "sketch",
                "--error_type", "virtual", "--virtual_momentum", "0.9",
                "--num_workers", "4", "--local_batch_size", "4",
                "--k", "50", "--num_rows", "3", "--num_cols", "500",
                "--num_epochs", "1", "--valid_batch_size", "64",
                "--dataset_dir", os.path.join(out_dir, "cifar_cli"),
                "--test"]
        return build_parser().parse_args(argv + list(extra))
    from commefficient_tpu_torch.training.gpt2 import build_gpt2_parser
    argv = ["--device", "cpu", "--model", "gpt2-tiny", "--max_seq_len", "32",
            "--mode", "sketch", "--k", "500", "--num_cols", "2000",
            "--num_rows", "3", "--num_epochs", "1", "--num_workers", "2",
            "--dataset_dir", os.path.join(out_dir, "persona_cli")]
    return build_gpt2_parser().parse_args(argv + list(extra))


def cli_rounds(entry: str, args, mesh, max_rounds: int) -> dict:
    from commefficient_tpu_torch.training import cv, gpt2
    train = cv.train if entry == "cv" else gpt2.train
    learner, row = train(args, mesh=mesh, max_rounds=max_rounds, log=False)
    return {"metrics": np.asarray([[float(r[k]) for k in ROUND_KEYS]
                                   for r in row["rounds"]], np.float64),
            "digest": np.asarray(state_digest(learner)),
            "weights": learner.full_weights().detach().cpu().numpy()}


def case_cli(mesh, device, init, out_dir):
    out = {}
    for tag, entry, extra, rounds in (
            ("cv", "cv", (), 2),
            ("cv_scan1", "cv", ("--num_epochs", "2"), 6),
            ("cv_scan3", "cv", ("--num_epochs", "2", "--scan_rounds", "3"),
             6),
            ("gpt2", "gpt2", (), 2)):
        args = cli_args(entry, out_dir, *extra)
        if entry == "cv":
            args.do_test = False   # --test would stop after one round
        out.update({f"{tag}/{k}": v for k, v in cli_rounds(
            entry, args, mesh, rounds).items()})
    return out


# --------------------------------------------------------------------------
# the model axis: gpt2-tiny on a clients x model mesh
# --------------------------------------------------------------------------

TP_T, TP_W, TP_B, TP_CLIENTS = 16, 2, 2, 4
#: the five modes on the GPT2 problem (the reference's test_mesh.py
#: config: lr 0.05, no weight decay, W 2 of 4 clients)
TP_MODES = {
    "uncompressed": dict(mode="uncompressed", error_type="none",
                         virtual_momentum=0.9),
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   k=500, num_rows=3, num_cols=5000),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9, k=500),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=500),
    "fedavg": dict(mode="fedavg", error_type="none", local_batch_size=-1,
                   fedavg_batch_size=1),
}
#: (attn_impl, dropout rate) of the tp_grad case; the rated ones draw
#: tpu_bits dropout
TP_GRAD_CONFIGS = (("full", 0.0), ("blockwise", 0.0), ("full", 0.1),
                   ("blockwise", 0.1))
TP_SEED = 1234


def tp_problem():
    """The reference's ``_gpt2_fed_problem`` batch: (ids (W, B, 1, T), mc,
    labels, mc labels, types) and an all-ones (W, B) mask, the same every
    round (ids 0 and 1)."""
    rng = np.random.RandomState(0)
    W, B, T = TP_W, TP_B, TP_T
    ids = rng.randint(0, 200, (W, B, 1, T)).astype(np.int64)
    types = rng.randint(0, 3, (W, B, 1, T)).astype(np.int64)
    mc = np.full((W, B, 1), T - 1, np.int64)
    labels = np.where(rng.rand(W, B, 1, T) < 0.5, ids, -1).astype(np.int64)
    mcl = np.zeros((W, B), np.int64)
    return (ids, mc, labels, mcl, types), np.ones((W, B), np.float32)


def tp_model(init: Optional[dict] = None, dropout: float = 0.0,
             attn_impl: str = "full", dropout_impl: str = "xla"):
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config.tiny()
    cfg.n_positions = TP_T
    cfg.dropout = dropout
    cfg.attn_impl = attn_impl
    cfg.dropout_impl = dropout_impl
    model = GPT2DoubleHeads(cfg)
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init.items()})
    return model


def tp_build(mode_kw: dict, mesh, device="cpu", init=None):
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    model = tp_model(init)
    cfg = FedConfig(num_workers=TP_W, num_clients=TP_CLIENTS, lr_scale=0.05,
                    weight_decay=0, **mode_kw)
    return FedLearner(model, cfg, make_gpt2_train_loss(model), None,
                      device=device, mesh=mesh)


def full_state(learner) -> dict:
    """The state's leaves whole: a model-axis rank's coordinate blocks
    joined over the model group (every rank calls it)."""
    s = learner.state
    mesh = learner.mesh
    split = mesh_lib.model_size(mesh) > 1

    def whole(t, dim=0):
        return mesh_lib.model_all_gather(t, mesh, dim) if split else t
    opt = split_leaves(learner.cfg)[0]
    return {"weights": whole(s.weights),
            "Vvelocity": whole(s.opt.Vvelocity) if opt else s.opt.Vvelocity,
            "Verror": whole(s.opt.Verror) if opt else s.opt.Verror,
            "last_changed": whole(s.last_changed),
            "client_last_round": s.client_last_round,
            "round_idx": s.round_idx}


def tp_rounds(learner, rounds: int, prefix: str = "") -> dict:
    batch, mask = tp_problem()
    ids = np.arange(TP_W)
    rows, digests = [], []
    for _ in range(rounds):
        m = learner.train_round(ids, batch, mask)
        rows.append([float(m[k]) for k in ROUND_KEYS])
        digests.append(state_digest(learner))
    out = {k: v.detach().cpu().numpy()
           for k, v in full_state(learner).items()}
    out["metrics"] = np.asarray(rows, np.float64)
    out["digests"] = np.asarray(digests)
    return {prefix + k: v for k, v in out.items()}


def case_tp_grad(mesh, device, init):
    """One worker's loss and flat gradient with the model on the mesh's
    model axis (``TPUnflatten``), per ``TP_GRAD_CONFIGS``."""
    from commefficient_tpu_torch.federated import client as client_lib
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    from commefficient_tpu_torch.parallel import tp as tp_lib
    from commefficient_tpu_torch.utils.params import flatten_params
    batch, mask = tp_problem()
    out = {}
    for attn, rate in TP_GRAD_CONFIGS:
        model = tp_model(init, rate, attn, "tpu_bits" if rate else "xla")
        flat, unflatten = flatten_params(model)
        ctx = tp_lib.TPContext.from_mesh(mesh)
        if ctx is not None:
            tp_lib.attach(model, ctx)
            unflatten = tp_lib.TPUnflatten(
                unflatten, flat.shape[0], tp_lib.TPLayout(
                    {n: tuple(p.shape) for n, p in model.named_parameters()},
                    model.config.n_head, ctx.size), ctx)
        cols = tuple(torch.as_tensor(c[0]).to(device) for c in batch)
        g, loss, _ = client_lib._masked_loss_and_grad(
            make_gpt2_train_loss(model), unflatten, flat.to(device), cols,
            torch.as_tensor(mask[0]).to(device), TP_SEED)
        tag = f"{attn}_{rate}"
        out[f"{tag}/grad"] = g.detach().cpu().numpy()
        out[f"{tag}/loss"] = np.asarray(float(loss))
    return out


def case_tp_modes(mesh, device, init):
    out = {}
    for name, kw in TP_MODES.items():
        ln = tp_build(kw, mesh, device, init)
        out.update(tp_rounds(ln, ROUNDS, f"{name}/"))
        s = ln.state
        out[f"{name}/held"] = np.asarray(
            [s.weights.numel(), s.last_changed.numel(),
             s.opt.Vvelocity.numel(), ln.cfg.grad_size, ln.cfg.grad_dim])
        rows = s.clients.errors if s.clients.errors is not None \
            else s.clients.velocities
        if torch.is_tensor(rows):
            out[f"{name}/rows_shape"] = np.asarray(rows.shape)
    return out


TP_CKPT_KW = TP_MODES["uncompressed"]


def case_tp_ckpt(mesh, device, init, out_dir):
    from commefficient_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
    out = {}
    ln = tp_build(TP_CKPT_KW, mesh, device, init)
    tp_rounds(ln, 2)
    save_checkpoint(os.path.join(out_dir, "tp_ckpt"), ln, "tp")
    out.update({f"saved/{k}": v.detach().cpu().numpy()
                for k, v in full_state(ln).items()})
    ref = os.path.join(out_dir, "ref_tp_ckpt.npz")
    if os.path.exists(ref):
        ln = tp_build(TP_CKPT_KW, mesh, device, init)
        load_checkpoint(ref, ln)
        out.update({f"loaded/{k}": v.detach().cpu().numpy()
                    for k, v in full_state(ln).items()})
        out["loaded/held"] = np.asarray(ln.state.weights.shape)
    return out


SERVE_TEXTS = ("hello there", "do you like fish", "tell me a story",
               "the weather is nice")
SERVE_MODES = ("fixed", "paged", "personalized", "speculative", "int8",
               "int4")


def serve_prompts():
    from commefficient_tpu_torch.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    return tok, [(tok.encode(t), [1] * len(tok.encode(t)))
                 for t in SERVE_TEXTS]


def serve_replies(model, params, mode: str, mesh=None):
    """The reference's ``__graft_entry__`` part 10 serving run in
    ``mode``: 4 prompts through 2 slots, budgets 3 + i, greedy. Returns
    (replies, the server's stats, its pools or cache)."""
    from commefficient_tpu_torch.federated.client_store import (
        HostArenaStore, make_codec)
    from commefficient_tpu_torch.serving import (ContinuousBatchingServer,
                                                 DecodeEngine,
                                                 PersonalizationIndex)
    from commefficient_tpu_torch.utils.params import flatten_params
    tok, prompts = serve_prompts()
    eng = DecodeEngine(model, params, eos_id=tok.convert_tokens_to_ids(
        "<eos>"), max_len=48, method="greedy", mesh=mesh)
    kw = {}
    if mode != "fixed":
        kw.update(kv_cache="paged", page_size=8)
    if mode in ("int8", "int4"):
        kw["kv_quant"] = mode
    if mode == "personalized":
        d = flatten_params(model)[0].shape[0]
        cfg = FedConfig(mode="local_topk", error_type="local",
                        client_state="sparse", k=4,
                        num_clients=4).finalize(d)
        kw["personalize"] = PersonalizationIndex(
            eng.params, HostArenaStore(cfg, make_codec(cfg), num_shards=2))
    if mode == "speculative":
        kw["speculate_k"] = 2
    srv = ContinuousBatchingServer(eng, slots=2, prefill_len=32, **kw)
    rids = [srv.submit(i, t, reply_type=1, max_new=3 + n,
                       user_id=(n if mode == "personalized" else None))
            for n, (i, t) in enumerate(prompts)]
    replies = srv.run()
    return [replies[r] for r in rids], srv.stats(), srv.cache


def serve_model(init: dict):
    from commefficient_tpu_torch.data.tokenizer import ByteTokenizer
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    model = GPT2DoubleHeads(GPT2Config.tiny(
        vocab_size=ByteTokenizer().vocab_size))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    return model


def case_tp_serve(mesh, device, init, out_dir):
    init = dict(np.load(os.path.join(out_dir, "serve_init.npz")))
    out = {}
    for mode in SERVE_MODES:
        model = serve_model(init)
        params = {n: p.detach().to(device)
                  for n, p in model.named_parameters()}
        model.to(device)
        replies, stats, srv_cache = serve_replies(model, params, mode, mesh)
        out[f"{mode}/replies"] = np.asarray(
            [r + [-1] * (16 - len(r)) for r in replies])
        out[f"{mode}/tp"] = np.asarray(stats["tp"])
        if "kv_pool_bytes" in stats:
            from commefficient_tpu_torch.tools.serve_tp import pool_bytes
            out[f"{mode}/pool_bytes"] = np.asarray(
                [stats["kv_pool_bytes"], pool_bytes(srv_cache)])
    return out


#: the ``cli`` case's GPT2 flags, the validation in batches of 64
TP_CLI_ARGS = ("--valid_batch_size", "64")


def case_tp_cli(mesh, device, init, out_dir):
    """The GPT2 entry point's ``train`` on the mesh (``TP_CLI_ARGS``, 2
    rounds)."""
    return {f"gpt2/{k}": v for k, v in cli_rounds(
        "gpt2", cli_args("gpt2", out_dir, *TP_CLI_ARGS), mesh, 2).items()}


#: A12 1b on the model axis: ``{tag: (mode, config extras, learner)}``,
#: the learner ``"sync"``, ``"lockstep"`` (buffered, no fault model) or
#: ``"faults"`` (buffered under ``tp_fault_model``)
TP_1B = {
    "lockstep": ("sketch", dict(server_mode="buffered"), "lockstep"),
    "faults": ("local_topk", dict(server_mode="buffered", buffer_m=2),
               "faults"),
    "offload_dense": ("local_topk", dict(client_state_offload=True),
                      "sync"),
    "device_dense": ("local_topk", {}, "sync"),
    "offload_sparse": ("local_topk", dict(client_state_offload=True,
                                          client_state="sparse"), "sync"),
    "device_sparse": ("local_topk", dict(client_state="sparse"), "sync"),
    "buckets_sketch": ("sketch", dict(grad_buckets=3), "sync"),
    "buckets_uncompressed": ("uncompressed", dict(grad_buckets=3), "sync"),
}
#: rounds (cohorts) of the tp_1b runs
TP_1B_ROUNDS = 4


def tp_fault_model() -> FaultModel:
    return FaultModel(7, TP_CLIENTS, base_latency=1.0, latency_sigma=0.5,
                      straggler_frac=0.25, straggler_mult=4.0,
                      dropout_prob=0.15, crash_prob=0.1)


def tp_1b_learner(tag: str, mesh, device="cpu", init=None):
    """The learner of ``TP_1B[tag]`` on gpt2-tiny (``tp_build``'s)."""
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    mode, extra, kind = TP_1B[tag]
    model = tp_model(init)
    cfg = FedConfig(num_workers=TP_W, num_clients=TP_CLIENTS, lr_scale=0.05,
                    weight_decay=0, **dict(TP_MODES[mode], **extra))
    cls = FedLearner if kind == "sync" else BufferedFedLearner
    kw = dict(fault_model=tp_fault_model()) if kind == "faults" else {}
    return cls(model, cfg, make_gpt2_train_loss(model), None, device=device,
               mesh=mesh, **kw)


def case_tp_1b(mesh, device, init, out_dir):
    """``TP_1B``'s runs, ``TP_1B_ROUNDS`` rounds each (cohorts through the
    event loop for ``faults``, then its flush): metrics, per-round
    digests, the whole state, every client's rows joined, each rank's
    held widths; a buffered 2-D checkpoint written (``tp_1b_ckpt``) and
    the reference's (``DIR/ref_tp_buffered.npz``) loaded."""
    from commefficient_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint)
    out = {}
    batch, mask = tp_problem()
    ids = np.arange(TP_W)
    for tag, (_, _, kind) in TP_1B.items():
        ln = tp_1b_learner(tag, mesh, device, init)
        if kind == "faults":
            rec = {f"{tag}/{k}": v for k, v in run_buffered_faults(
                ln, [(ids, batch, mask)] * TP_1B_ROUNDS).items()}
            out.update(rec)
        else:
            out.update(tp_rounds(ln, TP_1B_ROUNDS, f"{tag}/"))
        out.update({f"{tag}/{k}": v.detach().cpu().numpy()
                    for k, v in full_state(ln).items()})
        out.update({f"{tag}/rows_{k}": v
                    for k, v in joined_rows(ln).items()})
        store = ln.host_store
        if store is not None:
            leaf = store.arena(TP_1B_ROW_FIELD)
            out[f"{tag}/arena_shape"] = np.asarray(
                (leaf if torch.is_tensor(leaf) else leaf["val"]).shape)
        if tag == "lockstep":
            save_checkpoint(os.path.join(out_dir, "tp_1b_ckpt"), ln, "tp")
    ref = os.path.join(out_dir, "ref_tp_buffered.npz")
    if os.path.exists(ref):
        ln = tp_1b_learner("lockstep", mesh, device, init)
        load_checkpoint(ref, ln)
        out.update({f"loaded/{k}": v.detach().cpu().numpy()
                    for k, v in full_state(ln).items()})
    # a resume in process: half the rounds, a step file, a new learner,
    # the other half
    half = TP_1B_ROUNDS // 2
    for tag in TP_1B_RESUME:
        first = tp_1b_learner(tag, mesh, device, init)
        tp_rounds(first, half)
        fn = save_checkpoint(os.path.join(out_dir, f"tp_1b_resume_{tag}"),
                             first, "tp", step=half)
        second = tp_1b_learner(tag, mesh, device, init)
        load_checkpoint(fn, second)
        out.update(tp_rounds(second, TP_1B_ROUNDS - half, f"{tag}_resumed/"))
        out.update({f"{tag}_resumed/rows_{k}": v
                    for k, v in joined_rows(second).items()})
    return out


#: the runs ``tp_1b`` also resumes from a step file halfway
TP_1B_RESUME = ("lockstep", "offload_dense")


#: the client-row field local_topk keeps
TP_1B_ROW_FIELD = "errors"


# --------------------------------------------------------------------------
# the seq axis: ring attention and gpt2-tiny on a clients x seq mesh
# --------------------------------------------------------------------------

#: ring attention's inputs: (B, T, H, D) at 8 tokens a rank of 4
RING_SHAPE = (2, 32, 2, 8)
#: (causal, with a key mask) of the ring cases
RING_CASES = ((True, False), (False, False), (True, True))
SEQ_T = 32


def ring_inputs(seed: int = 2):
    """q, k, v (scaled 0.3), a cotangent and a key mask, from numpy."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(*RING_SHAPE).astype(np.float32) * 0.3
                  for _ in range(4))
    return q, k, v, g, rng.rand(*RING_SHAPE[:2]) > 0.25


def case_seq_ring(mesh, device, init):
    """``ring_attention_sharded`` on a 4-rank seq axis (its own mesh), per
    ``RING_CASES``: the global output, and the gradient of q, k and v
    under a fixed cotangent of each rank's block, summed over the
    ranks."""
    import torch.distributed as dist

    from commefficient_tpu_torch.ops.attention import (
        ring_attention, ring_attention_sharded)
    ring = mesh_lib.make_mesh(seq=dist.get_world_size(),
                              device_type=torch.device(device).type)
    group = mesh_lib.seq_group(ring)
    me, n = mesh_lib.seq_rank(ring), mesh_lib.seq_size(ring)
    q, k, v, g, km = (torch.as_tensor(x).to(device) for x in ring_inputs())
    per = q.shape[1] // n
    sl = slice(me * per, (me + 1) * per)
    out = {}
    for causal, masked in RING_CASES:
        tag = f"ring/{int(causal)}{int(masked)}"
        mask = km if masked else None
        out[f"{tag}/out"] = ring_attention_sharded(
            q, k, v, group, causal, mask).cpu().numpy()
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        y = ring_attention(*(x[:, sl] for x in leaves), group, causal,
                           None if mask is None else mask[:, sl])
        grads = torch.autograd.grad(y, leaves, g[:, sl])
        for name, gr in zip("qkv", grads):
            gr = gr.contiguous()
            dist.all_reduce(gr, group=group)
            out[f"{tag}/d{name}"] = gr.cpu().numpy()
    return out


def seq_model(init: Optional[dict], attn_impl: str = "ring",
              T: int = SEQ_T, dropout: float = 0.0):
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config.tiny()
    cfg.n_positions = T
    cfg.dropout = dropout
    cfg.attn_impl = attn_impl
    model = GPT2DoubleHeads(cfg)
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init.items()})
    return model


def seq_apply_inputs(T: int = SEQ_T, seed: int = 5):
    """The reference's ``test_gpt2_ring_seq_parallel_matches_single_device``
    inputs at T: ids, types (2, 2, T), global MC positions (2, 2)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 300, (2, 2, T)).astype(np.int64)
    types = rng.randint(0, 3, (2, 2, T)).astype(np.int64)
    mc = rng.randint(0, T, (2, 2)).astype(np.int64)
    return ids, types, mc


def case_seq_apply(mesh, device, init, out_dir):
    """``seq_parallel_apply`` of a ring gpt2-tiny (weights from
    ``DIR/seq_apply_init.npz``) on a 4-rank seq axis: the LM logits'
    blocks joined, and the MC logits."""
    import torch.distributed as dist

    from commefficient_tpu_torch.parallel import seq as seq_lib
    fn = os.path.join(out_dir, "seq_apply_init.npz")
    model = seq_model(dict(np.load(fn)) if os.path.exists(fn) else None)
    ring = mesh_lib.make_mesh(seq=dist.get_world_size(),
                              device_type=torch.device(device).type)
    seq_lib.attach(model, seq_lib.SeqContext.from_mesh(ring))
    model.to(device)
    ids, types, mc = (torch.as_tensor(x).to(device)
                      for x in seq_apply_inputs())
    params = dict(model.named_parameters())
    with torch.no_grad():
        lm, mcl = seq_lib.seq_parallel_apply(model, params, ids, types, mc)
    parts = [torch.empty_like(lm) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, lm.contiguous(), group=mesh_lib.seq_group(ring))
    return {"lm": torch.cat(parts, dim=2).cpu().numpy(),
            "mc": mcl.cpu().numpy()}


def seq_grad_batch(T: int = SEQ_T, seed: int = 3):
    """One worker's (B 2, C 2, T) GPT2 batch with labels and global MC
    positions in both halves of the sequence."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 200, (2, 2, T)).astype(np.int64)
    types = rng.randint(0, 3, (2, 2, T)).astype(np.int64)
    mc = np.array([[T - 1, 3], [T // 2, T // 2 - 1]], np.int64)
    labels = np.where(rng.rand(2, 2, T) < 0.5, ids, -1).astype(np.int64)
    mcl = np.array([0, 1], np.int64)
    return (ids, mc, labels, mcl, types), np.ones(2, np.float32)


def case_seq_grad(mesh, device, init):
    """One worker's loss and flat gradient on the mesh's seq axis (the
    seq loss, every rank on its block of ``seq_grad_batch``, the
    gradient summed over the seq group), at dropout 0, and
    ``seq_dp_lm_train_step``'s on both axes; with ``mesh`` None the
    port's full attention with no mesh."""
    import torch.distributed as dist

    from torch.func import functional_call

    from commefficient_tpu_torch.federated import client as client_lib
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    from commefficient_tpu_torch.parallel import seq as seq_lib
    from commefficient_tpu_torch.utils.params import flatten_params
    batch, mask = seq_grad_batch()
    ctx = seq_lib.SeqContext.from_mesh(mesh)
    model = seq_model(init, "full" if ctx is None else "ring")
    flat, unflatten = flatten_params(model)
    cols = tuple(torch.as_tensor(c).to(device) for c in batch)
    if ctx is None:
        loss = make_gpt2_train_loss(model)
    else:
        seq_lib.attach(model, ctx)
        loss = seq_lib.make_gpt2_train_loss_seq(model)
        cut = seq_lib.SeqCut(loss.seq_columns, SEQ_T, ctx.rank, ctx.size)
        cols = tuple(cut.apply(i, c) for i, c in enumerate(cols))
    g, total, _ = client_lib._masked_loss_and_grad(
        loss, unflatten, flat.to(device), cols,
        torch.as_tensor(mask).to(device), 0)
    if ctx is not None:
        dist.all_reduce(g, group=ctx.group)
    out = {"grad": g.detach().cpu().numpy(),
           "loss": np.asarray(float(total))}
    # seq_dp_lm_train_step: a (4, 1, T) batch of pre-shifted next-token
    # labels, rows over the clients axis and T over the seq axis, against
    # the same mean NLL's gradient with full attention in one process
    ids, types = (torch.as_tensor(np.concatenate([c, c[:, ::-1]])[:, :1]
                                  .copy()).to(device)
                  for c in (batch[0], batch[4]))
    labels = torch.cat([ids[..., 1:], torch.full_like(ids[..., :1], -1)],
                       dim=-1)
    labels[..., ::3] = -1
    params = dict(model.to(device).named_parameters())
    if ctx is None:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        lm, _ = functional_call(model, leaves, (
            ids, types, torch.zeros(ids.shape[:2], dtype=torch.long,
                                    device=ids.device)), {"train": False})
        lp = torch.log_softmax(lm.float(), dim=-1)
        valid = labels >= 0
        nll = -torch.gather(lp, -1, torch.where(valid, labels, 0)[..., None])
        dp_loss = torch.sum(nll[..., 0] * valid) / torch.sum(valid)
        grads = dict(zip(leaves, torch.autograd.grad(
            dp_loss, list(leaves.values()), materialize_grads=True)))
    else:
        dp_loss, grads = seq_lib.seq_dp_lm_train_step(mesh, model, params,
                                                      ids, types, labels)
    out["dp/loss"] = np.asarray(float(dp_loss))
    out["dp/grad"] = torch.cat([grads[k].reshape(-1) for k in sorted(grads)]
                               ).detach().cpu().numpy()
    return out


#: the reference's ``tests/test_cli_mesh.py:87-116`` problem, per mode
SEQ_CLI_MODES = {
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none"],
    "sketch": ["--mode", "sketch", "--error_type", "virtual", "--k", "1000",
               "--num_cols", "5000", "--num_rows", "3"],
}
SEQ_CLI_ROUNDS = 2


def seq_cli_argv(mode: str, dataset_dir: str) -> list:
    return SEQ_CLI_MODES[mode] + [
        "--virtual_momentum", "0.9", "--num_workers", "4",
        "--local_batch_size", "2", "--max_seq_len", str(SEQ_T),
        "--dataset_name", "SyntheticPersona", "--dataset_dir", dataset_dir,
        "--synthetic_personas", "8", "--synthetic_dialogs", "2",
        "--weight_decay", "0", "--num_epochs", "1", "--valid_batch_size",
        "64"]


def case_seq_cli(mesh, device, init, out_dir):
    """The GPT2 entry point's ``train`` on the mesh with ``--attn_impl
    ring`` (``SEQ_CLI_MODES``, ``SEQ_CLI_ROUNDS`` rounds; the initial
    weights from ``DIR/seq_init.npz`` when present): the rounds, a state
    digest after each, the final weights and the validation nll."""
    from commefficient_tpu_torch.models.gpt2 import GPT2DoubleHeads
    from commefficient_tpu_torch.tools.mesh_run import _Record
    from commefficient_tpu_torch.training import gpt2
    fn = os.path.join(out_dir, "seq_init.npz")
    saved = GPT2DoubleHeads.reset_parameters
    if os.path.exists(fn):
        init = {k: torch.as_tensor(v) for k, v in np.load(fn).items()}

        def from_file(self, generator=None):
            self.load_state_dict(init)
            return self
        GPT2DoubleHeads.reset_parameters = from_file
    out = {}
    try:
        for mode in SEQ_CLI_MODES:
            args = gpt2.build_gpt2_parser().parse_args(
                seq_cli_argv(mode, os.path.join(out_dir, "persona_seq"))
                + ["--device", device, "--attn_impl", "ring", "--mesh",
                   f"clients={mesh_lib.clients_size(mesh)},seq="
                   f"{mesh_lib.seq_size(mesh)}"])
            np.random.seed(args.seed)
            with _Record(False, True) as rec:
                learner, row = gpt2.train(args, mesh=mesh,
                                          max_rounds=SEQ_CLI_ROUNDS,
                                          log=False)
            out[f"{mode}/metrics"] = np.asarray(
                [[float(r[k]) for k in ROUND_KEYS] for r in row["rounds"]])
            out[f"{mode}/digests"] = np.asarray(rec.digests)
            out[f"{mode}/weights"] = learner.full_weights().cpu().numpy()
            out[f"{mode}/nll"] = np.asarray(row["nll"])
    finally:
        GPT2DoubleHeads.reset_parameters = saved
    return out


# --------------------------------------------------------------------------
# the stage axis: the GPipe pipeline of gpt2-tiny on a clients x stage mesh
# --------------------------------------------------------------------------

#: ``gpt2_pp_lm_apply``'s problems (the reference's ``tests/
#: test_attention.py`` and ``tests/test_moe.py`` pipeline tests): input
#: seed, (B, T), microbatches, stages (2: the launch's mesh; 4: the world
#: as one stage axis), the gpt2-tiny config's changes, and the reference's
#: init key (or "init", the problem whose weights it takes); "grad" takes
#: the flat gradient of mean(lm ** 2) too, "dp" also runs with
#: ``dp_axis="clients"``
PP_APPLY = {
    "two": dict(seed=8, B=4, T=16, n_micro=2, stages=2, cfg={}, key=0,
                grad=True, dp=True),
    "four": dict(seed=9, B=6, T=8, n_micro=3, stages=4, cfg={"n_layer": 4},
                 key=1, grad=True),
    "post_ln": dict(seed=0, B=2, T=16, n_micro=2, stages=2,
                    cfg={"arch": "openai-gpt"}, key=1, train=False),
    "moe": dict(seed=11, B=4, T=16, n_micro=2, stages=2,
                cfg={"moe_experts": 4, "moe_capacity_factor": 100.0}, key=0),
    "dropout": dict(seed=0, B=2, T=16, n_micro=2, stages=2,
                    cfg={"dropout": 0.3}, key=1),
    # "two" (its inputs and weights) with every block recomputed in the
    # backward
    "remat": dict(seed=8, B=4, T=16, n_micro=2, stages=2,
                  cfg={"remat": True}, init="two", grad=True),
}
#: the dropout problem's seeds: two runs of the first, one of the second
PP_DROPOUT_SEEDS = (5, 5, 6)


def pp_apply_inputs(tag: str):
    """(B, T) ids and token types of ``PP_APPLY[tag]``, from numpy."""
    spec = PP_APPLY[tag]
    rng = np.random.RandomState(spec["seed"])
    ids = rng.randint(0, 300, (spec["B"], spec["T"])).astype(np.int64)
    types = rng.randint(0, 3, (spec["B"], spec["T"])).astype(np.int64)
    return ids, types


def pp_config(tag: str):
    """``PP_APPLY[tag]``'s gpt2-tiny config (port side)."""
    from commefficient_tpu_torch.models.gpt2 import GPT2Config
    cfg = GPT2Config.tiny()
    cfg.n_positions = PP_APPLY[tag]["T"]
    for k, v in PP_APPLY[tag]["cfg"].items():
        setattr(cfg, k, v)
    return cfg


def _model_from(cfg, init: Optional[dict]):
    from commefficient_tpu_torch.models.gpt2 import GPT2DoubleHeads
    model = GPT2DoubleHeads(cfg)
    if init is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in init.items()})
    return model


def _npz_or_none(out_dir: str, name: str) -> Optional[dict]:
    fn = os.path.join(out_dir, name)
    return dict(np.load(fn)) if os.path.exists(fn) else None


def _flat_grad(params: dict, loss) -> torch.Tensor:
    grads = torch.autograd.grad(loss, list(params.values()),
                                materialize_grads=True)
    return torch.cat([g.reshape(-1) for g in grads])


def case_pp_apply(mesh, device, init, out_dir):
    """``gpt2_pp_lm_apply`` on each ``PP_APPLY`` problem (weights from
    ``DIR/pp_{tag}_init.npz``, or its "init" problem's): the logits of
    every rank, with ``dp_axis`` the clients shards' blocks joined; the
    flat gradient of mean(lm ** 2) summed over the stage group; the
    dropout problem's logits at ``PP_DROPOUT_SEEDS`` and with
    ``train=False``."""
    import torch.distributed as dist

    from commefficient_tpu_torch.parallel import pp
    four = mesh_lib.make_mesh(stage=dist.get_world_size(),
                              device_type=torch.device(device).type)
    out = {}
    for tag, spec in PP_APPLY.items():
        on = mesh if spec["stages"] == 2 else four
        model = _model_from(pp_config(tag), _npz_or_none(
            out_dir, f"pp_{spec.get('init', tag)}_init.npz"))
        model.to(device)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in model.named_parameters()}
        ids, types = (torch.as_tensor(x).to(device)
                      for x in pp_apply_inputs(tag))

        def run(**kw):
            kw.setdefault("train", spec.get("train", True))
            return pp.gpt2_pp_lm_apply(on, model, params, ids, types,
                                       spec["n_micro"], **kw)
        if tag == "dropout":
            for i, seed in enumerate(PP_DROPOUT_SEEDS):
                out[f"{tag}/seed{i}"] = run(seed=seed).detach().cpu().numpy()
            out[f"{tag}/eval"] = run(train=False).detach().cpu().numpy()
            continue
        lm = run()
        out[f"{tag}/lm"] = lm.detach().cpu().numpy()
        if spec.get("grad"):
            g = _flat_grad(params, torch.mean(lm ** 2))
            dist.all_reduce(g, group=mesh_lib.stage_group(on))
            out[f"{tag}/grad"] = g.cpu().numpy()
        if spec.get("dp"):
            with torch.no_grad():
                block = run(dp_axis="clients").contiguous()
            parts = [torch.empty_like(block)
                     for _ in range(mesh_lib.clients_size(mesh))]
            dist.all_gather(parts, block,
                            group=mesh_lib.clients_group(mesh))
            out[f"{tag}/dp_lm"] = torch.cat(parts).cpu().numpy()
    return out


#: ``pp_grad``'s microbatches (one worker's 4 sequences)
PP_GRAD_MICRO = 2


def case_pp_grad(mesh, device, init):
    """One worker's LM-only loss and flat gradient through the pipeline
    (``make_gpt2_train_loss_pp`` on the mesh's stage axis, the gradient
    summed over the stage group) at dropout 0 on ``seq_grad_batch``; with
    ``mesh`` None the port's unpipelined loss at ``mc_coef`` 0."""
    import torch.distributed as dist

    from commefficient_tpu_torch.federated import client as client_lib
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    from commefficient_tpu_torch.parallel import pp
    from commefficient_tpu_torch.utils.params import flatten_params
    batch, mask = seq_grad_batch()
    model = seq_model(init, "full")
    flat, unflatten = flatten_params(model)
    loss = (make_gpt2_train_loss(model, mc_coef=0.0) if mesh is None
            else pp.make_gpt2_train_loss_pp(mesh, model, PP_GRAD_MICRO))
    g, total, _ = client_lib._masked_loss_and_grad(
        loss, unflatten, flat.to(device),
        tuple(torch.as_tensor(c).to(device) for c in batch),
        torch.as_tensor(mask).to(device), 0)
    if mesh is not None:
        dist.all_reduce(g, group=mesh_lib.stage_group(mesh))
    return {"grad": g.detach().cpu().numpy(),
            "loss": np.asarray(float(total))}


#: the reference's ``tests/test_cli_mesh.py:286-315`` stage problem, per
#: mode (``seq_cli_argv``'s problem with ``--mc_coef 0``)
PP_CLI_ROUNDS = 2


def pp_cli_argv(mode: str, dataset_dir: str) -> list:
    return seq_cli_argv(mode, dataset_dir) + ["--mc_coef", "0"]


def case_pp_cli(mesh, device, init, out_dir):
    """The GPT2 entry point's ``train`` on the mesh with ``--mc_coef 0``
    (``SEQ_CLI_MODES``, ``PP_CLI_ROUNDS`` rounds; the initial weights from
    ``DIR/pp_cli_init.npz`` when present): the rounds, a state digest
    after each, the final weights and the validation nll; then, per mode,
    the same with a step file saved after round 1 (a save at a run's last
    round waits for an epoch that never comes), and a run resumed from
    that file for round 2."""
    from commefficient_tpu_torch.models.gpt2 import GPT2DoubleHeads
    from commefficient_tpu_torch.tools.mesh_run import _Record
    from commefficient_tpu_torch.training import gpt2
    init = _npz_or_none(out_dir, "pp_cli_init.npz")
    saved = GPT2DoubleHeads.reset_parameters
    if init is not None:
        def from_file(self, generator=None):
            self.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in init.items()})
            return self
        GPT2DoubleHeads.reset_parameters = from_file
    axes = (f"clients={mesh_lib.clients_size(mesh)},stage="
            f"{mesh_lib.stage_size(mesh)}")
    out = {}
    try:
        for mode in SEQ_CLI_MODES:
            argv = pp_cli_argv(mode, os.path.join(out_dir, "persona_pp")) + [
                "--device", device, "--mesh", axes]
            ckpt = ["--checkpoint_path", os.path.join(out_dir, f"pp_{mode}")]
            for tag, extra, rounds in (
                    ("", [], PP_CLI_ROUNDS),
                    ("saved/", ckpt + ["--checkpoint_every_rounds", "1"],
                     PP_CLI_ROUNDS),
                    ("resumed/", ckpt + ["--resume", "auto"],
                     PP_CLI_ROUNDS)):
                args = gpt2.build_gpt2_parser().parse_args(argv + extra)
                np.random.seed(args.seed)
                with _Record(False, True) as rec:
                    learner, row = gpt2.train(args, mesh=mesh,
                                              max_rounds=rounds, log=False)
                key = f"{mode}/{tag}"
                out[key + "metrics"] = np.asarray(
                    [[float(r[k]) for k in ROUND_KEYS]
                     for r in row["rounds"]])
                out[key + "digests"] = np.asarray(rec.digests)
                out[key + "weights"] = learner.full_weights().cpu().numpy()
                out[key + "nll"] = np.asarray(row["nll"])
    finally:
        GPT2DoubleHeads.reset_parameters = saved
    return out


# --------------------------------------------------------------------------
# MoE on the meshes: whole-batch routing on a clients axis, the expert
# axis, and MoE blocks on a model axis
# --------------------------------------------------------------------------

#: the reference's ``tests/test_moe.py`` layer problems: experts, width,
#: hidden width, tokens, seed (of the tokens and of the reference's init)
#: and capacity factor; "traj" takes ``steps`` SGD steps at ``lr`` on
#: mean((y - target) ** 2), target from RandomState(1)
EP_LAYER = {
    "layer": dict(E=4, C=8, ff=16, N=64, seed=0, cap=1.25),
    "traj": dict(E=4, C=8, ff=16, N=64, seed=5, cap=1.25, steps=4, lr=0.1),
}
#: the GPT2 entry point's MoE problem: ``seq_cli_argv``'s (4 workers of
#: 2 dialogs, T 32, gpt2-tiny) with 4 experts; (mode, capacity factor)
#: runs, each 2 rounds; the "resume" ones also save a step file after
#: round 1 and resume from it
MOE_EXPERTS = 4
MOE_CLI_ROUNDS = 2
EP_CLI_RUNS = {"uncompressed_1.25": ("uncompressed", 1.25, True),
               "sketch_1.25": ("sketch", 1.25, True),
               "uncompressed_100": ("uncompressed", 100.0, False),
               "sketch_100": ("sketch", 100.0, False)}
#: the model axis's MoE round and the clients axis's (C20)
TP_MOE_RUN = ("uncompressed", 1.25)
C20_RUN = ("uncompressed", 1.25)
#: flags the reference composes with the expert axis, on the sketch run
#: at 1.25: the buffered server under a fault schedule (per-worker
#: cohorts, each client routed alone) and bucketed aggregation
EP_FLAG_RUNS = {
    "buffered": ["--server_mode", "buffered", "--fault_seed", "7",
                 "--fault_dropout_prob", "0.2", "--buffer_m", "2"],
    "buckets": ["--grad_buckets", "3"],
}


def moe_cli_argv(mode: str, capacity: float, dataset_dir: str) -> list:
    # validation in batches of 8 dialogs: a batch is one capacity group,
    # and its (N, E, cap) dispatch grows as N^2 (at capacity factor 100
    # and 64 dialogs, 3.4 GB a tensor)
    return seq_cli_argv(mode, dataset_dir) + [
        "--moe_experts", str(MOE_EXPERTS), "--moe_capacity_factor",
        str(capacity), "--valid_batch_size", "8"]


def moe_layer_inputs(tag: str):
    """``EP_LAYER[tag]``'s tokens (and the trajectory's target)."""
    spec = EP_LAYER[tag]
    x = np.random.RandomState(spec["seed"]).randn(
        spec["N"], spec["C"]).astype(np.float32)
    tgt = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    return x, tgt


def case_ep_layer(mesh, device, init, out_dir):
    """``MoEFFN`` on the mesh's expert axis (weights from
    ``DIR/ep_{tag}_init.npz``): the layer's output with whole weights;
    the trajectory's losses and its final weights (the expert leaves'
    blocks joined over the expert group), each rank updating its own
    expert blocks from their gradients."""
    import torch.distributed as dist
    from torch.func import functional_call

    from commefficient_tpu_torch.ops.moe import (MoEFFN, is_expert_leaf,
                                                 shard_params_ep)
    from commefficient_tpu_torch.parallel import ep as ep_lib
    ctx = ep_lib.EPContext.from_mesh(mesh)
    out = {}
    for tag, spec in EP_LAYER.items():
        layer = MoEFFN(spec["C"], spec["E"], spec["ff"], spec["cap"])
        layer.load_state_dict({k: torch.as_tensor(v) for k, v in np.load(
            os.path.join(out_dir, f"ep_{tag}_init.npz")).items()})
        layer.to(device)
        x, tgt = (torch.as_tensor(a).to(device)
                  for a in moe_layer_inputs(tag))
        if "steps" not in spec:
            with torch.no_grad():
                out[f"{tag}/y"] = layer(x, ctx)[0].cpu().numpy()
            continue
        params = {k: v.detach() for k, v in layer.named_parameters()}
        if ctx is not None:
            params = shard_params_ep(params, ctx.rank, ctx.size)
        losses = []
        for _ in range(spec["steps"]):
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            y, _ = functional_call(layer, leaves, (x, ctx))
            loss = torch.mean((y - tgt) ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            params = {k: (v - spec["lr"] * g).detach()
                      for (k, v), g in zip(leaves.items(), grads)}
            losses.append(float(loss.detach()))
        out[f"{tag}/losses"] = np.asarray(losses)
        for k, v in params.items():
            if ctx is not None and is_expert_leaf(k):
                parts = [torch.empty_like(v) for _ in range(ctx.size)]
                dist.all_gather(parts, v.contiguous(), group=ctx.group)
                v = torch.cat(parts)
            out[f"{tag}/{k}"] = v.cpu().numpy()
    return out


def moe_gpt2_config():
    from commefficient_tpu_torch.models.gpt2 import GPT2Config
    cfg = GPT2Config.tiny()
    cfg.moe_experts = MOE_EXPERTS
    return cfg


def case_ep_gpt2(mesh, device, init, out_dir):
    """gpt2-tiny with 4 experts (weights from ``DIR/ep_gpt2_init.npz``)
    on the mesh's expert axis (``EPUnflatten``): the LM logits of
    ``pp_apply_inputs("two")`` in evaluation, and one worker's training
    loss (aux term included) and flat gradient on ``seq_grad_batch``;
    with ``mesh`` None the same unsharded."""
    from torch.func import functional_call

    from commefficient_tpu_torch.federated import client as client_lib
    from commefficient_tpu_torch.federated.losses import make_gpt2_train_loss
    from commefficient_tpu_torch.parallel import ep as ep_lib
    from commefficient_tpu_torch.utils.params import flatten_params
    model = _model_from(moe_gpt2_config(), _npz_or_none(
        out_dir, "ep_gpt2_init.npz")).to(device)
    flat, unflatten = flatten_params(model)
    ctx = ep_lib.EPContext.from_mesh(mesh)
    if ctx is not None:
        ep_lib.attach(model, ctx)
        unflatten = ep_lib.EPUnflatten(unflatten, flat.shape[0],
                                       ep_lib.EPLayout(
                                           {n: tuple(p.shape) for n, p in
                                            model.named_parameters()},
                                           ctx.size), ctx)
    ids, types = (torch.as_tensor(x).to(device)[:, None]
                  for x in pp_apply_inputs("two"))
    with torch.no_grad():
        lm, _ = functional_call(model, unflatten(flat), (
            ids, types, torch.zeros((ids.shape[0], 1), dtype=torch.int64,
                                    device=device)), {"train": False})
    batch, mask = seq_grad_batch()
    g, loss, _ = client_lib._masked_loss_and_grad(
        make_gpt2_train_loss(model), unflatten, flat,
        tuple(torch.as_tensor(c).to(device) for c in batch),
        torch.as_tensor(mask).to(device), 0)
    return {"lm": lm[:, 0].cpu().numpy(), "grad": g.cpu().numpy(),
            "loss": np.asarray(float(loss))}


class _RoutingRecord:
    """The routings of the first ``n`` MoE calls (``MoEFFN.route``
    patched while entered): each call's chosen experts, keep mask and
    capacity, as numpy."""

    def __init__(self, n: int):
        self.n = n
        self.calls = []

    def __enter__(self):
        from commefficient_tpu_torch.ops.moe import MoEFFN
        self._saved = MoEFFN.route
        rec = self

        def route(layer, xt):
            r = rec._saved(layer, xt)
            if len(rec.calls) < rec.n:
                rec.calls.append((r.expert.cpu().numpy(),
                                  r.keep.cpu().numpy(), r.capacity))
            return r
        MoEFFN.route = route
        return self

    def __exit__(self, *exc):
        from commefficient_tpu_torch.ops.moe import MoEFFN
        MoEFFN.route = self._saved


def _moe_cli_run(mesh, device, out_dir, init_name, axes, mode, capacity,
                 resume_dir=None, record=0, extra=()):
    """The GPT2 entry point's ``train`` of the MoE problem on ``axes``
    (``--mesh``; None for one process), the initial weights from
    ``DIR/{init_name}`` when present: {tag: arrays} for the run and, with
    ``resume_dir``, for a run that saves a step file after round 1 and one
    resumed from it. ``record``: the first MoE calls' routings."""
    from commefficient_tpu_torch.models.gpt2 import GPT2DoubleHeads
    from commefficient_tpu_torch.tools.mesh_run import _Record
    from commefficient_tpu_torch.training import gpt2
    init = _npz_or_none(out_dir, init_name)
    saved = GPT2DoubleHeads.reset_parameters
    if init is not None:
        def from_file(self, generator=None):
            self.load_state_dict({k: torch.as_tensor(v)
                                  for k, v in init.items()})
            return self
        GPT2DoubleHeads.reset_parameters = from_file
    argv = moe_cli_argv(mode, capacity, os.path.join(out_dir, "persona_moe")
                        ) + ["--device", device, *extra]
    if axes is not None:
        argv += ["--mesh", axes]
    runs = [("", [])]
    if resume_dir is not None:
        ckpt = ["--checkpoint_path", resume_dir]
        runs += [("saved/", ckpt + ["--checkpoint_every_rounds", "1"]),
                 ("resumed/", ckpt + ["--resume", "auto"])]
    out = {}
    try:
        for tag, extra in runs:
            args = gpt2.build_gpt2_parser().parse_args(argv + extra)
            np.random.seed(args.seed)
            routing = _RoutingRecord(record if not tag else 0)
            with _Record(False, mesh is not None) as rec, routing:
                learner, row = gpt2.train(args, mesh=mesh,
                                          max_rounds=MOE_CLI_ROUNDS,
                                          log=False)
            out[tag + "metrics"] = np.asarray(
                [[float(r[k]) for k in ROUND_KEYS] for r in row["rounds"]])
            if mesh is not None:
                out[tag + "digests"] = np.asarray(rec.digests)
            out[tag + "weights"] = learner.full_weights().cpu().numpy()
            out[tag + "nll"] = np.asarray(row["nll"])
            for i, (e, keep, cap) in enumerate(routing.calls):
                out[f"{tag}route{i}/expert"] = e
                out[f"{tag}route{i}/keep"] = keep
                out[f"{tag}route{i}/capacity"] = np.asarray(cap)
    finally:
        GPT2DoubleHeads.reset_parameters = saved
    return out


def _mesh_axes(mesh) -> Optional[str]:
    if mesh is None:
        return None
    inner = "".join(f",{k}={mesh_lib.inner_size(mesh, k)}"
                    for k in ("model", "expert")
                    if mesh_lib.inner_size(mesh, k) > 1)
    return f"clients={mesh_lib.clients_size(mesh)}{inner}"


def case_ep_cli(mesh, device, init, out_dir):
    """The GPT2 entry point's MoE rounds on the mesh (``EP_CLI_RUNS``;
    initial weights ``DIR/moe_cli_init.npz``): the rounds, a state digest
    after each, the final weights and the validation nll, and the resumed
    runs."""
    out = {}
    for tag, (mode, cap, resume) in EP_CLI_RUNS.items():
        res = os.path.join(out_dir, f"ep_{tag}") if resume else None
        out.update({f"{tag}/{k}": v for k, v in _moe_cli_run(
            mesh, device, out_dir, "moe_cli_init.npz", _mesh_axes(mesh),
            mode, cap, res).items()})
    return out


def case_ep_flags(mesh, device, init, out_dir):
    """``EP_FLAG_RUNS`` on the sketch MoE problem at capacity factor 1.25
    on the mesh (initial weights ``DIR/moe_cli_init.npz``)."""
    out = {}
    for tag, extra in EP_FLAG_RUNS.items():
        out.update({f"{tag}/{k}": v for k, v in _moe_cli_run(
            mesh, device, out_dir, "moe_cli_init.npz", _mesh_axes(mesh),
            "sketch", 1.25, extra=extra).items()})
    return out


def case_tp_moe(mesh, device, init, out_dir):
    """``TP_MOE_RUN``'s MoE rounds on the mesh's model axis (initial
    weights ``DIR/moe_cli_init.npz``)."""
    return _moe_cli_run(mesh, device, out_dir, "moe_cli_init.npz",
                        _mesh_axes(mesh), *TP_MOE_RUN)


def case_moe_c20(mesh, device, init, out_dir):
    """``C20_RUN``'s MoE rounds on the clients mesh (initial weights
    ``DIR/moe_cli_init.npz``), with the routing of round 1's MoE calls
    (one a block: this rank's tokens)."""
    return _moe_cli_run(mesh, device, out_dir, "moe_cli_init.npz",
                        _mesh_axes(mesh), *C20_RUN,
                        record=moe_gpt2_config().n_layer)


CASES = {"modes": case_modes, "rows": case_rows, "offload": case_offload,
         "buffered": case_buffered, "ckpt": case_ckpt, "cli": case_cli,
         "tp_grad": case_tp_grad, "tp_modes": case_tp_modes,
         "tp_ckpt": case_tp_ckpt, "tp_serve": case_tp_serve,
         "tp_cli": case_tp_cli, "tp_1b": case_tp_1b,
         "seq_ring": case_seq_ring, "seq_apply": case_seq_apply,
         "seq_grad": case_seq_grad, "seq_cli": case_seq_cli,
         "pp_apply": case_pp_apply, "pp_grad": case_pp_grad,
         "pp_cli": case_pp_cli, "ep_layer": case_ep_layer,
         "ep_gpt2": case_ep_gpt2, "ep_cli": case_ep_cli,
         "ep_flags": case_ep_flags, "tp_moe": case_tp_moe,
         "moe_c20": case_moe_c20}
#: the cases that read or write files beside their arrays
_WITH_DIR = ("ckpt", "cli", "tp_ckpt", "tp_serve", "tp_cli", "tp_1b",
             "seq_apply", "seq_cli", "pp_apply", "pp_cli", "ep_layer",
             "ep_gpt2", "ep_cli", "ep_flags", "tp_moe", "moe_c20")
#: the cases whose initial weights are ``DIR/tp_init.npz``
_TP_INIT = ("tp_grad", "tp_modes", "tp_ckpt", "tp_1b")


def run_cases(out_dir: str, names, device: str = "cpu",
              model: int = 1, seq: int = 1, stage: int = 1,
              expert: int = 1) -> None:
    """The launcher's target: every named case on this rank (of a
    ``clients x model`` mesh with ``model`` > 1, ``clients x seq`` with
    ``seq`` > 1, ``clients x stage`` with ``stage`` > 1, ``clients x
    expert`` with ``expert`` > 1)."""
    import torch.distributed as dist
    mesh = mesh_lib.make_mesh(model=model, seq=seq, stage=stage,
                              expert=expert,
                              device_type=torch.device(device).type)
    r = dist.get_rank()
    inits = {}
    for key in ("init", "tp_init"):
        fn = os.path.join(out_dir, f"{key}.npz")
        inits[key] = dict(np.load(fn)) if os.path.exists(fn) else None
    for name in names:
        fn = CASES[name]
        init = inits["tp_init" if name in _TP_INIT else "init"]
        args = (mesh, device, init) + ((out_dir,) if name in _WITH_DIR
                                       else ())
        arrays = fn(*args)
        np.savez(os.path.join(out_dir, f"{name}_rank{r}.npz"), **arrays)


def run_one_process(name: str, out_dir: str, device: str = "cpu",
                    init=None) -> dict:
    """A case's arrays from one process with no mesh (the comparison)."""
    fn = CASES[name]
    args = (None, device, init) + ((out_dir,) if name in _WITH_DIR else ())
    return fn(*args)


def launch(out_dir: str, names, ranks: int = 2, device: str = "cpu",
           backend: Optional[str] = None, model: int = 1,
           seq: int = 1, stage: int = 1, expert: int = 1) -> None:
    os.makedirs(out_dir, exist_ok=True)
    distributed.launch(run_cases, ranks,
                       (out_dir, list(names), device, model, seq, stage,
                        expert),
                       backend=backend, device_type=torch.device(device).type)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--model", type=int, default=1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--stage", type=int, default=1)
    p.add_argument("--expert", type=int, default=1)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--cases", default=",".join(
        c for c in CASES if c != "rows"))
    a = p.parse_args(argv)
    launch(a.out, a.cases.split(","), a.ranks, a.device, a.backend,
           a.model, a.seq, a.stage, a.expert)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

