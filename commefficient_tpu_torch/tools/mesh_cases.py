"""The ``clients`` mesh's cases, computed on every rank of one launch.

    python -m commefficient_tpu_torch.tools.mesh_cases --out DIR \
        [--ranks 2] [--device cpu] [--cases modes,offload,...]

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
    """sha256 of the replicated state's bytes."""
    s = learner.state
    h = hashlib.sha256()
    for t in (s.weights, s.opt.Vvelocity, s.opt.Verror, s.round_idx,
              s.last_changed, s.client_last_round, s.aborted,
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
        for leaf, t in leaves:
            if mesh is not None:
                t = mesh_lib.all_gather_cat(t.to(learner.device), mesh)
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
            "weights": learner.state.weights.detach().cpu().numpy()}


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


CASES = {"modes": case_modes, "rows": case_rows, "offload": case_offload,
         "buffered": case_buffered, "ckpt": case_ckpt, "cli": case_cli}
#: the cases that read or write files beside their arrays
_WITH_DIR = ("ckpt", "cli")


def run_cases(out_dir: str, names, device: str = "cpu") -> None:
    """The launcher's target: every named case on this rank."""
    mesh = mesh_lib.make_mesh(device_type=torch.device(device).type)
    r = mesh_lib.clients_rank(mesh)
    init_fn = os.path.join(out_dir, "init.npz")
    init = dict(np.load(init_fn)) if os.path.exists(init_fn) else None
    for name in names:
        fn = CASES[name]
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
           backend: Optional[str] = None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    distributed.launch(run_cases, ranks, (out_dir, list(names), device),
                       backend=backend, device_type=torch.device(device).type)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    p.add_argument("--cases", default=",".join(
        c for c in CASES if c != "rows"))
    a = p.parse_args(argv)
    launch(a.out, a.cases.split(","), a.ranks, a.device, a.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

