"""An entry point's ``train`` on a mesh, with what each rank saw.

    python -m commefficient_tpu_torch.tools.mesh_run --entry cv \
        --ranks 2 --backend gloo --out PREFIX [--max_rounds 3] -- FLAGS...

runs ``training.{cv,gpt2}.train(args, mesh=...)`` on ``--ranks`` local
ranks (``parallel.distributed.launch``; ``--backend gloo`` lets several
ranks share one card) and writes ``PREFIX_rank{r}.json`` for each rank:
the rounds' metrics (losses also as float hex), a digest of the
replicated state after every dispatched round (unless ``digests`` is
False), sha256 of the final weights, server momentum and error and of
every client's joined rows, the kernel launches of the rounds (every
counter zeroed just before ``train``), ``train``'s wall seconds, the
peak device memory, the offload shards' reads and writes, the buffered
server's schedule, and the backend that ran. With
``record_table`` the first aggregate the server took (the sketched table
in sketch mode) is saved as ``PREFIX_rank{r}_table.npy``; with
``record_block`` the first slice a rank sketched (its block of the
aggregate on a model axis) as ``PREFIX_rank{r}_block.npy``, its offset
in the JSON; with ``record_cohorts`` the dispatched cohorts' ids and
masks as ``PREFIX_rank{r}_cohorts.npz``; with ``time_collectives`` each
dispatched round's ``torch.distributed`` collectives (all-reduce,
all-gather, broadcast, and the ring's ``batch_isend_irecv``) are timed
on the host, the device synchronized around each, with their payload
(the bytes a rank contributes, or sends), in all and by kind
(``collectives_by_kind``). A spec's ``model`` = M makes the launch a
``clients x model`` mesh of ranks / M client shards (the state's shas and
``d`` are then of the whole joined vectors), its ``seq`` = S a ``clients
x seq`` mesh, its ``stage`` = S a ``clients x stage`` mesh (the
pipeline's hops timed as ``stage_send`` and ``stage_recv``: a receive's
time is its wait for the sending stage), its ``expert`` = E a ``clients
x expert`` mesh (the expert group's collectives timed apart as
``expert_combine``, the MoE outputs' all-reduces, ``expert_grad``, the
f all-reduces of the backward, and ``expert_join``, the expert leaves'
gradient all-gather; a collective inside another is the outer one's);
``gpt2_config`` sets attributes
of the GPT2 entry point's model config (``{"dropout": 0.0}``); the record
carries the learner's ``--grad_buckets`` plan (``buckets``: offsets and
sizes).

``launch(specs, ranks, backend)`` does the same from Python for one spec
or a list of them, which the same ranks run in turn (each on its own
mesh, of its own inner axis). FLAGS are the entry point's; ``--mesh
clients=N`` (or ``clients=N/M,model=M``, and so on) is added.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as mesh_lib


def _sha(t) -> str:
    from commefficient_tpu_torch.tools.mesh_cases import host_bytes
    return hashlib.sha256(host_bytes(t)).hexdigest()


class _Done:
    """A finished work: ``wait`` returns at once."""

    def wait(self):
        return True


class _CollectiveClock:
    """Host seconds, calls and payload bytes of the collectives, each
    call bracketed by device synchronizations (``torch.distributed``'s
    functions patched while it is entered)."""

    NAMES = ("all_reduce", "all_gather", "broadcast", "batch_isend_irecv")
    #: the pipeline's hops (``parallel/pp.py``), each waited inside: a
    #: receive's time is its wait for the sending stage
    HOPS = ("send", "recv")
    #: the expert group's collectives (``parallel/ep.py``), by kind
    EXPERT = {"combine_sum": "expert_combine", "grad_sum": "expert_grad",
              "gather_grads": "expert_join"}

    def __enter__(self):
        self.seconds, self.bytes, self.calls = 0.0, 0, 0
        from commefficient_tpu_torch.parallel import ep
        from commefficient_tpu_torch.parallel.pp import StageContext
        self.kinds = {n: [0.0, 0, 0] for n in self.NAMES}
        self.kinds.update({f"stage_{n}": [0.0, 0, 0] for n in self.HOPS})
        self.kinds.update({k: [0.0, 0, 0] for k in self.EXPERT.values()})
        self._inside = False
        self._saved = [(dist, n, getattr(dist, n), n) for n in self.NAMES]
        self._saved += [(StageContext, n, getattr(StageContext, n),
                         f"stage_{n}") for n in self.HOPS]
        self._saved += [(ep, n, getattr(ep, n), kind)
                        for n, kind in self.EXPERT.items()]
        for owner, name, f, kind in self._saved:
            setattr(owner, name, self._timed(name, f, kind))
        return self

    def _timed(self, name, f, kind_name):
        def timed(*args, **kwargs):
            if self._inside:
                return f(*args, **kwargs)
            if name == "batch_isend_irecv":
                sent = [op.tensor for op in args[0] if op.op is dist.isend]
                ts = sent or [args[0][0].tensor]
            elif name in self.HOPS:
                # (stage, tensor or shape, ...)
                ts = [args[1]] if name == "send" else []
                sent = ts
            else:
                ts = [args[1] if name == "all_gather" else args[0]]
                sent = ts
            cuda = (any(t.is_cuda for t in ts) if ts
                    else torch.cuda.is_available())
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._inside = True
            try:
                out = f(*args, **kwargs)
            finally:
                self._inside = False
            if name == "batch_isend_irecv":
                # waited here, so the time is the transfer's; a gloo
                # send or receive waits once, so the caller gets works
                # already done
                for req in out:
                    req.wait()
                out = [_Done()] * len(out)
            if cuda:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            nbytes = sum(t.numel() * t.element_size() for t in sent)
            self.seconds += dt
            self.bytes += nbytes
            self.calls += 1
            kind = self.kinds[kind_name]
            kind[0] += dt
            kind[1] += nbytes
            kind[2] += 1
            return out
        return timed

    def snapshot(self):
        return (self.seconds, self.bytes, self.calls,
                {k: list(v) for k, v in self.kinds.items()})

    def __exit__(self, *exc):
        for owner, name, f, _ in self._saved:
            setattr(owner, name, f)


class _Record:
    """Per-round state digests of every dispatched round (the outermost
    ``train_round_async`` of a learner only), the first aggregate the
    server took, the first sketched slice and the dispatched cohorts."""

    def __init__(self, table: bool, digests: bool, block: bool = False,
                 clock: Optional[_CollectiveClock] = None):
        self.digests, self.cohorts, self.table = [], [], None
        self.block = None
        self.clock = clock
        self.collectives = []     # (seconds, bytes, calls) a round
        self.by_kind = []         # {kind: (seconds, bytes, calls)} a round
        self._want_table = table
        self._want_block = block
        self._want_digests = digests
        self._depth = 0

    def __enter__(self):
        from commefficient_tpu_torch.federated import round as round_mod
        from commefficient_tpu_torch.federated.api import FedLearner
        from commefficient_tpu_torch.federated.buffer import \
            BufferedFedLearner
        from commefficient_tpu_torch.ops.countsketch import CountSketch
        from commefficient_tpu_torch.tools.mesh_cases import state_digest
        self._saved = [(cls, "train_round_async", cls.train_round_async)
                       for cls in (FedLearner, BufferedFedLearner)]
        self._saved += [(round_mod, "server_update", round_mod.server_update),
                        (CountSketch, "sketch_range",
                         CountSketch.sketch_range)]
        rec = self

        def wrap(saved):
            def dispatch(learner, client_ids, batch, mask, **kw):
                rec._depth += 1
                before = rec.clock.snapshot() if rec.clock else None
                try:
                    raw = saved(learner, client_ids, batch, mask, **kw)
                finally:
                    rec._depth -= 1
                if rec._depth == 0:
                    if before is not None:
                        now = rec.clock.snapshot()
                        rec.collectives.append([
                            a - b for a, b in zip(now[:3], before[:3])])
                        rec.by_kind.append({
                            k: [a - b for a, b in zip(v, before[3][k])]
                            for k, v in now[3].items() if v[2]
                            > before[3][k][2]})
                    rec.cohorts.append((np.array(client_ids),
                                        np.array(mask)))
                    if rec._want_digests:
                        rec.digests.append(state_digest(learner))
                return raw
            return dispatch
        for cls, attr, saved in self._saved[:2]:
            setattr(cls, attr, wrap(saved))
        server_update, sketch_range = (f for _, _, f in self._saved[2:])

        def update(gradient, *args, **kwargs):
            if rec._want_table and rec.table is None:
                rec.table = gradient.detach().cpu().numpy().copy()
            return server_update(gradient, *args, **kwargs)

        def sketch(cs, chunk, offset=0):
            if rec._want_block and rec.block is None:
                rec.block = (chunk.detach().cpu().numpy().copy(),
                             int(offset))
            return sketch_range(cs, chunk, offset)
        round_mod.server_update = update
        CountSketch.sketch_range = sketch
        return self

    def __exit__(self, *exc):
        for owner, attr, f in self._saved:
            setattr(owner, attr, f)


@contextlib.contextmanager
def gpt2_overrides(overrides: dict):
    """The GPT2 entry point's model config with ``overrides`` set on it
    while entered (``{"dropout": 0.0}``: no flag sets them)."""
    from commefficient_tpu_torch.training import gpt2
    saved = gpt2.gpt2_config

    def gpt2_config(*a, **kw):
        cfg = saved(*a, **kw)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg
    gpt2.gpt2_config = gpt2_config
    try:
        yield
    finally:
        gpt2.gpt2_config = saved


def run_specs(specs: list) -> None:
    """The launcher's target: ``run_rank`` of each spec in turn, on one
    process group (the ranks start once)."""
    for spec in specs:
        run_rank(spec)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def run_rank(spec: dict) -> None:
    """The launcher's target: one rank of ``spec`` (``entry``, ``argv``,
    ``out``, optional ``max_rounds``, ``attrs`` set on the parsed flags,
    ``record_table``, ``record_cohorts``, and ``digests``: False skips the
    per-round digests, which read the state back to the host and so
    stretch the rounds' times)."""
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.tools.mesh_cases import joined_rows
    from commefficient_tpu_torch.training import cv, gpt2
    from commefficient_tpu_torch.training.args import (
        build_parser, round_up_workers_for_mesh)
    entry = spec["entry"]
    parser = (build_parser() if entry == "cv"
              else gpt2.build_gpt2_parser())
    n = distributed.world_size()
    inner = {k: int(spec[k]) for k in ("model", "seq", "stage", "expert")
             if int(spec.get(k, 1)) > 1}
    shards = n // int(np.prod(list(inner.values()), dtype=np.int64))
    axes = f"clients={shards}" + "".join(
        f",{k}={v}" for k, v in inner.items())
    args = parser.parse_args(list(spec["argv"]) + ["--mesh", axes])
    for k, v in spec.get("attrs", {}).items():
        setattr(args, k, v)
    round_up_workers_for_mesh(args, mesh_lib.MeshSpec(shards, inner))
    np.random.seed(args.seed)
    device_type = torch.device(args.device).type
    mesh = mesh_lib.make_mesh(n, device_type=device_type, **inner)
    r = dist.get_rank()
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    train = cv.train if entry == "cv" else gpt2.train
    clock = _CollectiveClock() if spec.get("time_collectives") else None
    with (clock or contextlib.nullcontext()), _Record(
            spec.get("record_table", False), spec.get("digests", True),
            spec.get("record_block", False), clock) as rec, \
            gpt2_overrides(spec.get("gpt2_config", {})):
        cuda_lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        learner, row = train(args, mesh=mesh,
                             max_rounds=spec.get("max_rounds"), log=False)
        wall = time.perf_counter() - t0
        if cuda:
            torch.cuda.synchronize()
        launches = dict(row.get("launches_after_rounds") or
                        {k: v for k, v in cuda_lib.LAUNCHES.items() if v})
    from commefficient_tpu_torch.tools.mesh_cases import full_state
    s = full_state(learner)
    rows = joined_rows(learner)
    h = hashlib.sha256()
    for k in sorted(rows):
        h.update(k.encode())
        h.update(rows[k].tobytes())
    out = {
        "rank": r, "world": n, "backend": dist.get_backend(),
        "device": str(learner.device),
        "rounds": [{"loss": x["loss"], "loss_hex": float(x["loss"]).hex(),
                    "upload_bytes": x["upload_bytes"],
                    "download_bytes": x["download_bytes"],
                    "round_s": x.get("round_s")}
                   for x in row.get("rounds", [])],
        "test_loss": row.get("test_loss", row.get("nll")),
        "wall_s": wall,
        "preempted": bool(row.get("preempted", False)),
        "digests": rec.digests,
        "weights_sha": _sha(s["weights"]), "vvel_sha": _sha(s["Vvelocity"]),
        "verr_sha": _sha(s["Verror"]), "rows_sha": h.hexdigest(),
        "round_idx": int(s["round_idx"]), "d": int(s["weights"].shape[0]),
        "held": int(learner.state.weights.shape[0]),
        "finite": bool(torch.isfinite(s["weights"]).all()),
        "launches": launches,
        "collectives": rec.collectives,
        "collectives_by_kind": rec.by_kind,
        "buckets": (None if learner.grad_buckets is None else
                    [list(map(int, learner.grad_buckets.offsets)),
                     list(map(int, learner.grad_buckets.sizes))]),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                     if cuda else None),
    }
    store = learner.host_store
    if store is not None:
        out.update(shard_reads=store.shard_reads.tolist(),
                   shard_writes=store.shard_writes.tolist(),
                   arena_bytes=store.nbytes())
    if hasattr(learner, "fault_stats"):
        out.update(fault_stats=dict(learner.fault_stats),
                   applies=learner.applies_done, sim_time=learner.sim_time,
                   num_clients=learner.cfg.num_clients)
    prefix = f"{spec['out']}_rank{r}"
    if rec.table is not None:
        np.save(prefix + "_table.npy", rec.table)
    if rec.block is not None:
        np.save(prefix + "_block.npy", rec.block[0])
        out["block_offset"] = rec.block[1]
    if spec.get("record_cohorts"):
        np.savez(prefix + "_cohorts.npz",
                 ids=np.stack([c[0] for c in rec.cohorts]),
                 masks=np.stack([c[1] for c in rec.cohorts]))
    with open(prefix + ".json", "w") as f:
        json.dump(out, f)
    del learner, s


def launch(specs, ranks: int, backend: Optional[str] = None) -> list:
    """``specs`` (one spec, or a list run in turn by the same ranks) on
    ``ranks`` local ranks; returns each spec's list of rank records."""
    specs = [specs] if isinstance(specs, dict) else list(specs)
    argv = list(specs[0]["argv"])
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    distributed.launch(run_specs, ranks, (specs,), backend=backend,
                       device_type=torch.device(device).type)
    out = []
    for spec in specs:
        recs = []
        for r in range(ranks):
            with open(f"{spec['out']}_rank{r}.json") as f:
                recs.append(json.load(f))
        out.append(recs)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = []
    if "--" in argv:
        i = argv.index("--")
        argv, flags = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--entry", choices=("cv", "gpt2"), required=True)
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--max_rounds", type=int, default=None)
    a = p.parse_args(argv)
    launch({"entry": a.entry, "argv": flags, "out": a.out,
            "max_rounds": a.max_rounds}, a.ranks, a.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
