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
at tp = M, weights from ``DIR/serve_init.npz``) and ``tp_cli`` (the GPT2
entry point's ``train``).
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


def state_digest(learner) -> str:
    """sha256 of the replicated state's bytes (on a model axis, with the
    coordinate blocks joined: every rank calls it)."""
    s = learner.state
    h = hashlib.sha256()
    w = full_state(learner) if mesh_lib.model_size(learner.mesh) > 1 \
        else {"weights": s.weights, "Vvelocity": s.opt.Vvelocity,
              "Verror": s.opt.Verror, "last_changed": s.last_changed}
    for t in (w["weights"], w["Vvelocity"], w["Verror"], s.round_idx,
              w["last_changed"], s.client_last_round, s.aborted,
              s.weights_version, s.quarantine):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


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


CASES = {"modes": case_modes, "rows": case_rows, "offload": case_offload,
         "buffered": case_buffered, "ckpt": case_ckpt, "cli": case_cli,
         "tp_grad": case_tp_grad, "tp_modes": case_tp_modes,
         "tp_ckpt": case_tp_ckpt, "tp_serve": case_tp_serve,
         "tp_cli": case_tp_cli}
#: the cases that read or write files beside their arrays
_WITH_DIR = ("ckpt", "cli", "tp_ckpt", "tp_serve", "tp_cli")
#: the cases whose initial weights are ``DIR/tp_init.npz``
_TP_INIT = ("tp_grad", "tp_modes", "tp_ckpt")


def run_cases(out_dir: str, names, device: str = "cpu",
              model: int = 1) -> None:
    """The launcher's target: every named case on this rank (of a
    ``clients x model`` mesh with ``model`` > 1)."""
    import torch.distributed as dist
    mesh = mesh_lib.make_mesh(model=model,
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
           backend: Optional[str] = None, model: int = 1) -> None:
    os.makedirs(out_dir, exist_ok=True)
    distributed.launch(run_cases, ranks,
                       (out_dir, list(names), device, model),
                       backend=backend, device_type=torch.device(device).type)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--model", type=int, default=1)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--cases", default=",".join(
        c for c in CASES if c != "rows"))
    a = p.parse_args(argv)
    launch(a.out, a.cases.split(","), a.ranks, a.device, a.backend,
           a.model)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

