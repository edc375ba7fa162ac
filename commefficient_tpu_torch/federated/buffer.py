"""Buffered asynchronous aggregation (FedBuff) under the seeded fault model
(port of ``commefficient_tpu/federated/buffer.py``).

The sync round is a lock-step barrier: the server waits for every sampled
client, so one straggler or dropout stalls the cohort. The buffered
server lands contributions in an M-slot buffer as they arrive and applies
whenever M have landed, scaling each by its staleness ``s(tau) = 1 / (1 +
tau)^alpha``, ``tau = weights_version - start_version`` the applies since
its client pulled.

Three steps over the sync round's client phase (``round.build_client_phase``):

* ``cohort``: the W sampled clients' steps against the current weights,
  emitted as a W-slot ``BufferState`` (plus the cohort's loss and metric
  sums); nothing of the server state changes;
* ``deposit``: copy the arrived slots of a cohort into the server's
  buffer, in worker order. Which slots arrive, and when, is the host
  event loop's business (``BufferedFedLearner``), driven by the seeded
  ``FaultModel``; the device sees a boolean take-mask only;
* ``apply``: the staleness-weighted aggregate of the filled slots, then
  the sync round's server tail (``round.build_server_tail``: the server
  update, the deferred client-row writeback, the byte accounting), and
  the buffer reset.

Without a fault model every contribution arrives at once and the server
applies each cohort: the learner then runs the sync round itself (one
call path, so with alpha 0 the trajectory is the sync learner's bitwise:
the same seeds, the same reduction over the slots in worker order, the
same server call; a staleness of 0 scales nothing).

The buffer keeps one sink slot past its M, as the client rows keep a
sink row: a dropped slot writes there, and nothing syncs with the host
to filter it. Under ``--client_quarantine`` a non-finite contribution is
excluded at apply by a select and its client benched; under
``--client_state_offload`` the cohort gathers its rows through the
learner's ``HostOffloadPipeline`` and the apply hands the rows it would
scatter back to the pipeline, the dropped slots marked by the sentinel
id ``num_clients`` (the sink row's index).

On a ``mesh`` the buffer is sharded as the reference's
``buffer_state_shardings``: rank r owns the slots ``slot_block(M)`` (and
a sink of its own). A cohort runs each rank's workers and joins their
contributions in worker order on every rank; a deposit writes each taken
slot on the rank that owns its buffer slot; the apply sums each rank's
slots and joins the sums with ``all_reduce``, and the tail writes the
slots' rows back to their owners. The fault schedule is the host's and
reads only the whole cohort, so it does not depend on the mesh.

With a ``model`` axis (2-D clients x model federation) the cohort runs
the clients tensor-parallel on the joined weights, as the sync round
does, and each slot keeps only the rank's coordinate block of its dense
transmit (its sketch block, 128-aligned, in sketch mode, which sketches
at apply) and of the dense codec's rows: ``buffer_state_shardings``'
``(clients, model)`` split. A per-client sketched transmit (an (r, c)
table) is split by slot only. The apply sums each rank's block over the
clients axis and joins the blocks over the model group (or sums their
block sketches), and the tail writes each rank's block of the rows back.
A seq axis needs the fused round, so the cohort refuses it.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

import numpy as np
import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.faults import FaultModel
from commefficient_tpu_torch.federated.client import ClientStepOut
from commefficient_tpu_torch.federated.round import (FedState,
                                                     build_client_phase,
                                                     build_server_tail,
                                                     client_sketch_of,
                                                     download_counts,
                                                     finite_contributions,
                                                     mesh_client_rows,
                                                     split_leaves)
from commefficient_tpu_torch.federated.server import make_sketch
from commefficient_tpu_torch.federated.state import (CLIENT_STATE_FIELDS,
                                                     BufferState)
from commefficient_tpu_torch.ops.countsketch import LANES
from commefficient_tpu_torch.parallel import mesh as mesh_lib


def build_buffer_programs(apply_loss: Callable, unflatten: Callable,
                          cfg: FedConfig,
                          trainable_mask: Optional[torch.Tensor] = None,
                          sketch=None, mesh=None):
    """``(cohort, deposit, apply)`` for this config (``cfg`` finalized):

        cohort(state, ids (W,) int64, batch, mask, lr, seed, rows=None,
               client_ks=None) -> (BufferState of W slots, metrics)
        deposit(buffer (M + 1 slots), contrib (W slots), take (W,) bool)
            -> buffer (written in place)
        apply(state, lr, seed) -> (state, metrics), or under offload
            (state, (writeback ids (M,), encoded rows), metrics)

    ``sketch``: the round's ``CountSketch`` to share (else one is made).
    On a ``mesh`` the cohort takes this rank's workers' columns (the ids
    and mask whole) and returns every worker's slot, and the buffer holds
    this rank's ``slot_block`` of M plus a sink."""
    cfg.validate()
    if cfg.server_mode != "buffered":
        raise ValueError("build_buffer_programs needs server_mode="
                         f"'buffered', got {cfg.server_mode!r}")
    M = cfg.effective_buffer_m
    ws, m_lo, m_hi = slice(None), 0, M
    if mesh is not None:
        n_shards = mesh_lib.clients_size(mesh)
        for name, val in (("num_workers", cfg.num_workers),
                          ("num_clients", cfg.num_clients),
                          ("buffer_m", M)):
            if val % n_shards:
                raise ValueError(
                    f"{name} ({val}) must be divisible by the mesh "
                    f"'clients' axis size ({n_shards}) — buffered slot "
                    f"rows shard over that axis (each shard owns its "
                    f"own slots)")
        ws = mesh_lib.worker_block(cfg.num_workers, mesh)
        m_lo, m_hi = mesh_lib.slot_block(M, mesh)
    m_loc = m_hi - m_lo
    if mesh_lib.seq_size(mesh) > 1:
        raise ValueError(
            "the buffered server's cohort steps each client apart, which a "
            "seq mesh axis cannot shard; use --server_mode sync (or the "
            "lock-step buffered server, which runs the sync round)")
    split = mesh_lib.model_size(mesh) > 1
    split_rows = split and split_leaves(cfg)[1]
    lo, hi = mesh_lib.coord_block(cfg.grad_dim, mesh) if split \
        else (0, cfg.grad_dim)
    if cfg.mode == "sketch" and sketch is None:
        sketch = make_sketch(cfg)
    offload = cfg.client_state_offload and cfg.has_client_state
    quarantine = cfg.client_quarantine
    # as in the sync round: sketch once an apply, not once a client, when
    # no per-worker nonlinearity comes between
    sketch_after_aggregate = (sketch is not None
                              and client_sketch_of(cfg, sketch) is None)
    clients = build_client_phase(apply_loss, unflatten, cfg, sketch,
                                 trainable_mask)
    server_tail = build_server_tail(cfg, sketch, trainable_mask, mesh,
                                    rows_blocked=True)
    # the coordinates of a dense transmit a model-axis rank keeps: its
    # sketch block (the tiled sketch's lane cuts) when the apply sketches
    t_lo, t_hi = (mesh_lib.coord_block(
        cfg.grad_dim, mesh, align=LANES if cfg.sketch_scheme == "tiled"
        else 1) if sketch_after_aggregate else (lo, hi)) if split \
        else (0, cfg.grad_dim)

    def mine(out: ClientStepOut) -> ClientStepOut:
        """A rank's coordinate block of the dense transmit and rows."""
        if not split:
            return out
        t = out.transmit
        if t.dim() == 2:
            t = t[:, t_lo:t_hi].contiguous()
        rows = [r[:, lo:hi].contiguous() if r is not None and split_rows
                else r for r in (out.velocity, out.error, out.client_weights)]
        return ClientStepOut(t, *rows, out.loss_sum, out.metric_sums,
                             out.num_datapoints)

    def gather(x):
        """A rank's block joined into the whole on every rank (identity
        off a mesh)."""
        return x if mesh is None or x is None else \
            mesh_lib.all_gather_cat(x, mesh)

    def reduce(x):
        return x if mesh is None else mesh_lib.all_reduce_sum(x, mesh)

    def cohort(state: FedState, ids, batch, mask, lr, seed, rows=None,
               client_ks=None):
        W = ids.shape[0]
        num_clients = state.client_last_round.shape[0]
        valid_w = torch.any(mask > 0, dim=1)
        alive_w = (valid_w & ~(state.quarantine[ids] > 0) if quarantine
                   else valid_w)
        # download snapshot against the weights the client pulls now;
        # billed at apply, gated by that apply's guard
        counts = download_counts(state.last_changed,
                                 state.client_last_round[ids])
        if split:
            # each model rank counts its block
            counts = mesh_lib.model_all_reduce(counts, mesh)
        if mesh is None:
            out = clients(state, ids, batch, mask, lr, seed, rows,
                          client_ks)
        else:
            out = clients(state, ids[ws], batch, mask[ws], lr, seed,
                          mesh_client_rows(state, ids.tolist(), rows, mesh,
                                           ws, split_rows),
                          None if client_ks is None else client_ks[ws],
                          weights=mesh_lib.model_all_gather(state.weights,
                                                            mesh))
            out = ClientStepOut(*(gather(x) for x in mine(out)))
        contrib = BufferState(
            transmit=out.transmit, loss_sum=out.loss_sum,
            metric_sums=out.metric_sums,
            num_datapoints=out.num_datapoints,
            download_floats=(counts * alive_w.to(torch.int32)).to(
                torch.float32),
            cid=torch.where(alive_w, ids, num_clients),
            start_version=state.weights_version.expand(W).clone(),
            valid=alive_w,
            count=torch.zeros((), dtype=torch.int32, device=ids.device),
            velocities=out.velocity, errors=out.error,
            weights=out.client_weights)
        # the cohort's reporting sums: excluded slots selected out under
        # quarantine; otherwise the sync round's plain sums (padded slots
        # are zeros, a NaN slot reaches the guard)
        if quarantine:
            report_w = alive_w & finite_contributions(out)
            metrics = {
                "loss_sum": torch.sum(torch.where(report_w, out.loss_sum,
                                                  0.0)),
                "metric_sums": torch.sum(torch.where(
                    report_w[:, None], out.metric_sums, 0.0), dim=0),
                "num_datapoints": torch.sum(torch.where(
                    report_w, out.num_datapoints, 0.0))}
        else:
            metrics = {"loss_sum": torch.sum(out.loss_sum),
                       "metric_sums": torch.sum(out.metric_sums, dim=0),
                       "num_datapoints": torch.sum(out.num_datapoints)}
        return contrib, metrics

    def deposit(buf: BufferState, contrib: BufferState, take):
        """Copy the taken cohort slots into the next free slots, in worker
        order. Invalid slots (padded, benched: device knowledge the host
        lacks) go to the sink slot M, so the host re-reads ``count``. The
        caller keeps popcount(take) <= M - count."""
        take_eff = take & contrib.valid
        ti = take_eff.to(torch.int32)
        slots = torch.where(take_eff, buf.count + torch.cumsum(ti, 0) - 1,
                            M).long()
        if mesh is not None:
            # this rank writes the taken slots it owns
            slots = torch.where((slots >= m_lo) & (slots < m_hi),
                                slots - m_lo, m_loc)
        for field in ("transmit", "loss_sum", "metric_sums",
                      "num_datapoints", "download_floats", "cid",
                      "start_version") + CLIENT_STATE_FIELDS:
            dst, src = getattr(buf, field), getattr(contrib, field)
            if dst is not None and src is not None:
                dst[slots] = src
        buf.valid[slots] = True
        buf.valid[m_loc] = False
        buf.count = buf.count + torch.sum(ti)
        return buf

    def apply(state: FedState, lr, seed):
        buf = state.buffer
        transmit, loss_sum, n = (buf.transmit[:m_loc], buf.loss_sum[:m_loc],
                                 buf.num_datapoints[:m_loc])
        cid, start = buf.cid[:m_loc], buf.start_version[:m_loc]
        vmask = buf.valid[:m_loc] & (
            torch.arange(m_lo, m_hi, device=cid.device) < buf.count)
        if quarantine:
            # per-contribution exclusion by a select (NaN * 0 is NaN)
            finite_b = (torch.isfinite(loss_sum) & torch.all(
                torch.isfinite(transmit.reshape(m_loc, -1)), dim=1))
            if split:
                # a slot is finite when every model rank's block is
                finite_b = mesh_lib.model_all_reduce(
                    (~finite_b).to(torch.int32), mesh) == 0
            contrib_b = vmask & finite_b
        else:
            finite_b, contrib_b = None, vmask
        tau = torch.clamp(state.weights_version - start, min=0)
        if cfg.staleness_alpha == 0.0:
            # no 1.0 multiplies: the lock-step equivalence stays bitwise
            wt_t, wt_n = transmit, n
        else:
            s = torch.pow(1.0 + tau.to(torch.float32),
                          -cfg.staleness_alpha)
            wt_t = s.view((-1,) + (1,) * (transmit.dim() - 1)) * transmit
            wt_n = s * n
        cb = contrib_b.view((-1,) + (1,) * (transmit.dim() - 1))
        total_n = torch.sum(torch.where(contrib_b, wt_n, 0.0))
        # the breach check reads the unweighted post-exclusion loss
        loss_total = torch.sum(torch.where(contrib_b, loss_sum, 0.0))
        n_raw = torch.sum(torch.where(contrib_b, n, 0.0))
        download = torch.sum(torch.where(vmask, buf.download_floats[:m_loc],
                                         0.0))
        if mesh is not None:
            total_n, loss_total, n_raw, download = reduce(torch.stack(
                [total_n, loss_total, n_raw, download]))
        agg = (reduce(torch.sum(torch.where(cb, wt_t, 0.0), dim=0))
               / torch.clamp(total_n, min=1.0))
        if split and sketch_after_aggregate:
            # the rank's block sketched at its offset, the tables summed
            # over the model group
            agg = mesh_lib.model_all_reduce(sketch.sketch_range(agg, t_lo),
                                            mesh)
        elif split and agg.dim() == 1:
            agg = mesh_lib.model_all_gather(agg, mesh)
        elif sketch_after_aggregate:
            agg = sketch.sketch_vec(agg)
        # the rows computed at cohort time land in client state only when
        # their contribution is applied; each client pulled at its slot's
        # start version
        new_rows = tuple(None if r is None else r[:m_loc]
                         for r in (buf.velocities, buf.errors, buf.weights))
        cid, contrib_b, vmask, finite_b, start, tau = (
            gather(x) for x in (cid, contrib_b, vmask, finite_b, start, tau))
        new_state, writeback, metrics = server_tail(
            state, agg, loss_total / torch.clamp(n_raw, min=1.0), cid,
            contrib_b, vmask, finite_b, start, new_rows, download, lr, seed)
        new_state.buffer = _reset(buf, state.client_last_round.shape[0])
        metrics.update(
            applied=(~metrics["aborted"]).to(torch.float32),
            buffer_fill=buf.count.to(torch.float32),
            staleness_mean=(
                torch.sum(torch.where(contrib_b, tau.to(torch.float32), 0.0))
                / torch.clamp(torch.sum(contrib_b.to(torch.float32)),
                              min=1.0)))
        if offload:
            return new_state, writeback, metrics
        return new_state, metrics

    return cohort, deposit, apply


def _reset(buf: BufferState, num_clients: int) -> BufferState:
    """An empty buffer shaped like ``buf`` (the next apply's slots)."""
    def zeros(x):
        return None if x is None else torch.zeros_like(x)
    return BufferState(
        transmit=zeros(buf.transmit), loss_sum=zeros(buf.loss_sum),
        metric_sums=zeros(buf.metric_sums),
        num_datapoints=zeros(buf.num_datapoints),
        download_floats=zeros(buf.download_floats),
        cid=torch.full_like(buf.cid, num_clients),
        start_version=zeros(buf.start_version), valid=zeros(buf.valid),
        count=zeros(buf.count), velocities=zeros(buf.velocities),
        errors=zeros(buf.errors), weights=zeros(buf.weights))


def init_buffer(contrib: BufferState, m: int,
                num_clients: int) -> BufferState:
    """An empty buffer of ``m`` slots and the sink slot, shaped off a
    cohort's contribution (slot 0 of each tensor gives the slot's shape
    and dtype)."""
    def grow(x):
        return (None if x is None else
                torch.zeros((m + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device))
    dev = contrib.cid.device
    return BufferState(
        transmit=grow(contrib.transmit), loss_sum=grow(contrib.loss_sum),
        metric_sums=grow(contrib.metric_sums),
        num_datapoints=grow(contrib.num_datapoints),
        download_floats=grow(contrib.download_floats),
        cid=torch.full((m + 1,), num_clients, dtype=contrib.cid.dtype,
                       device=dev),
        start_version=torch.zeros((m + 1,), dtype=torch.int32, device=dev),
        valid=torch.zeros((m + 1,), dtype=torch.bool, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        velocities=grow(contrib.velocities), errors=grow(contrib.errors),
        weights=grow(contrib.weights))


def _merge_apply(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    """Roll up the metrics of several applies in one host call: bytes and
    counts add, point-in-time values (aborted, update_l2, staleness) take
    the latest. A single apply passes through untouched."""
    if a is None:
        return b
    if b is None:
        return a
    out = dict(b)
    for k in ("download_bytes", "upload_bytes", "applied",
              "dropped_contributions"):
        if k in a and k in b:
            out[k] = a[k] + b[k]
    return out


class BufferedFedLearner(FedLearner):
    """A ``FedLearner`` whose server runs buffered aggregation.

    The host side is a deterministic event loop over simulated time:
    cohort k is dispatched at ``k * dispatch_interval``; each sampled
    client's fate (dropout, crash, arrival latency) comes from the seeded
    ``FaultModel``; arrivals wait in a heap ordered by ``(arrival time,
    seq)``, ``seq`` a monotone tiebreak, and are delivered in that order
    before any later cohort is dispatched; the server applies whenever
    ``buffer_m`` contributions have landed, and ``sim_time`` advances to
    each apply's trigger arrival. With ``fault_model=None`` every client
    arrives at once and each call runs the sync round (the lock-step
    mode). The same seed replays the same buffer schedule bitwise.
    """

    def __init__(self, model, cfg: FedConfig, loss_train, loss_val=None,
                 lr_schedule=None, device="cuda", seed: int = 0,
                 lr_scale_vec=None, trainable_mask=None,
                 fault_model: Optional[FaultModel] = None,
                 dispatch_interval: Optional[float] = None, mesh=None):
        if cfg.server_mode != "buffered":
            raise ValueError("BufferedFedLearner needs cfg.server_mode="
                             f"'buffered', got {cfg.server_mode!r}")
        super().__init__(model, cfg, loss_train, loss_val,
                         lr_schedule=lr_schedule, device=device, seed=seed,
                         lr_scale_vec=lr_scale_vec,
                         trainable_mask=trainable_mask, mesh=mesh)
        self.M = self.cfg.effective_buffer_m
        # lock-step runs the sync round itself (also on a seq axis, which
        # the cohort cannot run)
        self._cohort = self._deposit = self._apply = None
        if fault_model is not None or mesh_lib.seq_size(mesh) == 1:
            self._cohort, self._deposit, self._apply = \
                build_buffer_programs(
                    self._loss_train, self._compute_unflatten, self.cfg,
                    trainable_mask=self._trainable_mask,
                    sketch=self._round.sketch, mesh=mesh)
        lo, hi = ((0, self.M) if mesh is None
                  else mesh_lib.slot_block(self.M, mesh))
        self._m_local = hi - lo
        self._num_clients = int(self.state.client_last_round.shape[0])
        self.fault_model = fault_model
        self.dispatch_interval = float(
            dispatch_interval if dispatch_interval is not None
            else (fault_model.base_latency if fault_model else 1.0))
        self._events = []       # heap of (arrival_t, seq, contrib, worker)
        self._seq = 0
        self._buf_count = 0     # host mirror, re-read after each deposit
        self._last_lr_in = None
        self._apply_seed = None
        self.cohorts_done = 0
        self.applies_done = 0
        self.sim_time = 0.0
        self.fault_stats = {"dispatched": 0, "dropouts": 0, "crashes": 0,
                            "arrivals": 0, "applies": 0,
                            "partial_applies": 0}

    # -- event loop ------------------------------------------------------

    def _push_writeback(self, wb):
        """Deferred host-arena writeback (offload): the dropped slots carry
        the sentinel id ``num_clients`` and are not written."""
        ids, rows = wb
        ids_np = ids.cpu().numpy().astype(np.int64)
        self._offload_pipe.push(ids_np, ids_np < self._num_clients, rows)

    def _do_apply(self, t: float) -> dict:
        if self._offload:
            self.state, wb, metrics = self._apply(
                self.state, self._last_lr_in, self._apply_seed)
            self._push_writeback(wb)
        else:
            self.state, metrics = self._apply(self.state, self._last_lr_in,
                                              self._apply_seed)
        self._buf_count = 0
        self.applies_done += 1
        self.fault_stats["applies"] += 1
        self.sim_time = max(self.sim_time, float(t))
        return metrics

    def _deliver(self, contrib: BufferState, workers, t: float):
        """Deposit ``workers`` (cohort slots, in order) at sim time ``t``,
        applying whenever the buffer fills; chunked so a deposit never
        overflows even if every candidate slot is valid."""
        W = contrib.valid.shape[0]
        merged = None
        i = 0
        while i < len(workers):
            space = self.M - self._buf_count
            if space <= 0:
                merged = _merge_apply(merged, self._do_apply(t))
                continue
            chunk = workers[i:i + space]
            take = np.zeros(W, bool)
            take[chunk] = True
            self.state.buffer = self._deposit(
                self.state.buffer, contrib, self._to_device(take))
            self._buf_count = int(self.state.buffer.count)
            i += len(chunk)
            if self._buf_count >= self.M:
                merged = _merge_apply(merged, self._do_apply(t))
        return merged

    def _drain(self, upto: float):
        """Deliver every heaped arrival with t <= upto in arrival order:
        their applies advance ``weights_version``, the staleness later
        cohorts are judged against."""
        merged = None
        while self._events and self._events[0][0] <= upto:
            t, _seq, contrib, worker = heapq.heappop(self._events)
            self.fault_stats["arrivals"] += 1
            merged = _merge_apply(merged, self._deliver(contrib, [worker],
                                                        t))
        return merged

    def _ensure_buffer(self, contrib: BufferState):
        if self.state.buffer is None:
            self.state.buffer = init_buffer(contrib, self._m_local,
                                            self._num_clients)

    # -- FedLearner surface ----------------------------------------------

    def train_round_async(self, client_ids, batch, mask, epoch_frac=None,
                          next_client_ids=None):
        """Dispatch one cohort: the clients' steps run against the current
        weights; whether and when their contributions reach the buffer is
        the fault model's call. The returned metrics merge the cohort's
        loss and metric sums with whatever applies fired in this call
        (zero bytes when none did)."""
        fm = self.fault_model
        self.fault_stats["dispatched"] += 1
        if fm is None:
            # lock-step: the sync round, one apply a cohort
            raw = super().train_round_async(
                client_ids, batch, mask, epoch_frac=epoch_frac,
                next_client_ids=next_client_ids)
            self.applies_done += 1
            self.fault_stats["applies"] += 1
            self.cohorts_done += 1
            return raw
        lr = self.lr_at(self.rounds_done if epoch_frac is None
                        else epoch_frac)
        seed = self._next_seed()
        ids_np = np.asarray(client_ids)
        ids = self._to_device(ids_np, torch.int64)
        cols = tuple(self._cols(c, i) for i, c in enumerate(batch))
        m = self._to_device(mask, torch.float32)
        lr_in = self._lr_in(lr)
        # the applies this call triggers from here on use its lr and seed
        self._last_lr_in = lr_in
        self._apply_seed = seed
        ks = self._client_ks(ids_np) if self.cfg.client_k_active else None
        d_k = self.cohorts_done * self.dispatch_interval
        # causal order: the arrivals due before this dispatch apply first
        applied = self._drain(d_k)
        # gathered after the drain: an apply pushes fresher rows
        rows = (self._offload_pipe.gather(ids_np.astype(np.int64))
                if self._offload else None)
        contrib, raw = self._cohort(self.state, ids, cols, m, lr_in, seed,
                                    rows, ks)
        self._ensure_buffer(contrib)
        valid_np = np.asarray(mask).any(axis=1)
        started, arrives, latency = fm.cohort_fates(self.cohorts_done,
                                                    ids_np, valid_np)
        self.fault_stats["dropouts"] += int((valid_np & ~started).sum())
        self.fault_stats["crashes"] += int((started & ~arrives).sum())
        for wk in np.nonzero(arrives)[0]:
            heapq.heappush(self._events, (d_k + float(latency[wk]),
                                          self._seq, contrib, int(wk)))
            self._seq += 1
        if applied is None:
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            raw.update(aborted=self.state.aborted.clone(),
                       download_bytes=zero, upload_bytes=zero,
                       update_l2=zero)
        else:
            raw.update(applied)
        if self._offload and next_client_ids is not None:
            self._offload_pipe.prefetch(
                np.asarray(next_client_ids).astype(np.int64))
        self.cohorts_done += 1
        self.rounds_done += 1
        raw["lr"] = lr
        return raw

    def _host_totals(self, applied) -> Optional[dict]:
        """Read applies' metrics on the host and add their bytes to the
        totals (these applies bypass ``finalize_round_metrics``)."""
        if applied is None:
            return None
        out = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
               for k, v in applied.items()}
        self.total_download_bytes += float(out["download_bytes"])
        self.total_upload_bytes += float(out["upload_bytes"])
        return out

    def pump_events(self, upto: Optional[float] = None):
        """Deliver every arrival due by ``upto`` (default: the dispatch
        clock, ``cohorts_done * dispatch_interval``) without dispatching a
        cohort. Returns the applies' merged host metrics, or None."""
        if upto is None:
            upto = self.cohorts_done * self.dispatch_interval
        return self._host_totals(self._drain(float(upto)))

    def event_cursor(self) -> dict:
        """The event loop's position for a checkpoint. In-flight arrivals
        and a partial buffer are not saved: a resume starts with an empty
        buffer, and the fault model's schedule replays from the cursor."""
        return {"cohorts_done": self.cohorts_done,
                "applies_done": self.applies_done,
                "sim_time": float(self.sim_time),
                "seq": self._seq}

    def restore_event_cursor(self, cur: dict) -> None:
        self.cohorts_done = int(cur["cohorts_done"])
        self.applies_done = int(cur["applies_done"])
        self.sim_time = float(cur["sim_time"])
        self._seq = int(cur["seq"])
        self._events = []
        self._buf_count = 0
        self._last_lr_in = None
        self._apply_seed = None

    def flush_faults(self):
        """Deliver every in-flight arrival and apply what is left in the
        buffer: the end-of-training barrier. Returns the merged host
        metrics of those applies, or None."""
        applied = self._drain(np.inf)
        if self._buf_count > 0:
            self.fault_stats["partial_applies"] += 1
            applied = _merge_apply(applied, self._do_apply(self.sim_time))
        self.flush_offload()
        return self._host_totals(applied)

    def train_rounds_scan(self, *a, **k):
        raise NotImplementedError(
            "buffered mode dispatches cohorts through a host event loop; "
            "K-round scan windows are a sync-mode optimization")

    def scan_window(self, k: int):
        raise NotImplementedError(
            "buffered mode has no scan window (see train_rounds_scan)")
