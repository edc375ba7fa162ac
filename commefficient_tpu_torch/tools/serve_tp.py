"""Tensor-parallel serving of GPT2-small on a ``model`` mesh, with what
each rank saw.

    from commefficient_tpu_torch.tools import serve_tp
    recs = serve_tp.launch(spec, ranks=2, backend="gloo")

Every rank builds the same GPT2-small from ``spec["seed"]`` (float32,
blockwise attention, ``spec["n_layer"]`` layers, vocab ``spec["vocab"]``),
joins a ``make_mesh(ranks, model=ranks)`` mesh, and serves
``spec["prompts"]`` (``(ids, types)`` lists; the reply's token type is
the prompt's last) through a paged ``ContinuousBatchingServer`` over a
``DecodeEngine(mesh=)``: a warm-up burst of the first ``warmup`` prompts
at ``warmup_new`` tokens, then every prompt at once, greedy, at most
``max_new`` tokens each. It writes ``{spec["out"]}_rank{r}.json``: the
replies, the host ms of every decode-only step, tokens and wall seconds,
the kernel launches of the burst (counters zeroed just before it), the
model-axis all-reduces a decode-only step and their host ms (each
bracketed by device synchronizations), the KV pool bytes of the model
and of a rank, the tp degree and the peak device memory.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch
import torch.distributed as dist

from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.parallel import tp as tp_lib


def serve_model(spec: dict, device):
    """GPT2-small (its first ``n_layer`` layers' shape) from the seed."""
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config.small(vocab_size=spec["vocab"])
    cfg.attn_impl = "blockwise"
    cfg.n_layer = spec["n_layer"]
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(spec["seed"])).to(device)
    return model, {n: p.detach() for n, p in model.named_parameters()}


def pool_bytes(cache) -> int:
    """The bytes of a server's pools (or cache) on this rank."""
    return sum(t.numel() * t.element_size() for layer in cache
               for t in layer.values())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _CountAllReduces:
    """Counts and times (host seconds, the device synchronized around
    each) the row-parallel all-reduces of the model's forwards."""

    def __enter__(self):
        self.n, self.seconds = 0, 0.0
        self._saved = tp_lib.reduce_from_tp

        def counted(x, tp):
            self.n += 1
            _sync(x.device)
            t0 = time.perf_counter()
            out = self._saved(x, tp)
            _sync(x.device)
            self.seconds += time.perf_counter() - t0
            return out
        tp_lib.reduce_from_tp = counted
        return self

    def __exit__(self, *exc):
        tp_lib.reduce_from_tp = self._saved


def burst(srv, prompts, max_new: int, device, counter=None):
    """Submit every prompt at once and step until the server drains:
    (replies in submission order, host ms of each decode-only step,
    (all-reduces, their ms) of each decode-only step, wall seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    rids = [srv.submit(ids, types, types[-1], max_new)
            for ids, types in prompts]
    replies, decode_ms, reduces = {}, [], []
    while srv._queued() or any(r is not None for r in srv._slot_req):
        queued = sum(len(q) for q in [srv._queue] + srv._shard_queue)
        before = (counter.n, counter.seconds) if counter is not None \
            else None
        ts = time.perf_counter()
        for rid, toks in srv.step():
            replies[rid] = toks
        _sync(device)
        te = time.perf_counter()
        if queued == sum(len(q) for q in [srv._queue] + srv._shard_queue):
            decode_ms.append((te - ts) * 1e3)
            if counter is not None:
                reduces.append((counter.n - before[0],
                                (counter.seconds - before[1]) * 1e3))
    return ([replies[r] for r in rids], decode_ms, reduces,
            time.perf_counter() - t0)


def run_rank(spec: dict) -> None:
    """The launcher's target: one rank of ``spec``."""
    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.serving import (ContinuousBatchingServer,
                                                 DecodeEngine)
    n = distributed.world_size()
    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.make_mesh(n, model=n, device_type=device.type)
    model, params = serve_model(spec, device)
    engine = DecodeEngine(model, params, eos_id=spec["eos"],
                          max_len=spec["max_len"], mesh=mesh)
    srv = ContinuousBatchingServer(engine, slots=spec["slots"],
                                   prefill_len=spec["prefill"],
                                   page_size=spec["page"], kv_cache="paged")
    prompts = [(list(i), list(t)) for i, t in spec["prompts"]]
    burst(srv, prompts[:spec["warmup"]], spec["warmup_new"], device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cuda_lib.LAUNCHES.clear()
    with _CountAllReduces() as counter:
        replies, decode_ms, reduces, wall = burst(
            srv, prompts, spec["max_new"], device, counter)
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    stats = srv.stats()
    out = {
        "rank": dist.get_rank(), "world": n, "backend": dist.get_backend(),
        "tp": stats["tp"], "replies": replies, "decode_ms": decode_ms,
        "allreduces_per_decode_step": sorted({n for n, _ in reduces}),
        "allreduce_ms_per_decode_step": [ms for _, ms in reduces],
        "tokens": sum(len(r) for r in replies), "wall_s": wall,
        "launches": launches, "kv_pool_bytes": stats["kv_pool_bytes"],
        "kv_pool_bytes_per_rank": pool_bytes(srv.cache),
        "pages_in_use": srv.pager.pages_in_use,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
    }
    with open(f"{spec['out']}_rank{out['rank']}.json", "w") as f:
        json.dump(out, f)


def launch(spec: dict, ranks: int, backend: Optional[str] = None) -> list:
    """``spec`` on ``ranks`` local ranks; each rank's record."""
    device_type = torch.device(spec.get("device", "cuda")).type
    distributed.launch(run_rank, ranks, (spec,), backend=backend,
                       device_type=device_type)
    recs = []
    for r in range(ranks):
        with open(f"{spec['out']}_rank{r}.json") as f:
            recs.append(json.load(f))
    return recs

