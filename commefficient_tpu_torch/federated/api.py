"""High-level federated training API (port of ``FedLearner``,
``HostOffloadPipeline``, ``RoundPipeline`` and ``ScanWindow`` in
``commefficient_tpu/federated/api.py``).

    learner = FedLearner(model, cfg, loss_train, loss_val, device="cuda")
    metrics = learner.train_round(client_ids, batch, mask)   # one fed round
    metrics = learner.evaluate(batches)                      # centralized val

The model's current parameters are the initial weights; the learner
keeps them as one flat vector in the reference's coordinates
(utils/params.py) and runs the model functionally on views of it. Its
``state`` carries the server's momentum and error and, in the modes that
keep them, the clients' rows (``state.clients``) in the ``--client_state``
codec's encoding; under ``--client_state_offload`` the rows live in host
arenas instead (``host_store``, ``host_clients``) and a
``HostOffloadPipeline`` moves the sampled ones.

``train_round_async`` dispatches a round and returns its metrics as
device tensors, ``finalize_round_metrics`` reads them on the host;
``train_round`` is both, then ``flush_offload``. A loop that passes the
next round's ids (``next_client_ids``) lets the pipeline gather them
while this round computes. ``pipeline()`` gives a one-round
``RoundPipeline``: a loop pushes each dispatched round and reads the
previous one's metrics, so the host's read overlaps the next round.

``--scan_rounds K``: ``train_rounds_scan`` enqueues K rounds from one
window of stacked inputs, copied to the device once, with no host read
between them on the fused paths, and stacks their metrics on the device
for one copy to the host (``finalize_scan_metrics``); ``scan_window(K)``
buffers a loop's rounds into such windows. A window equals K single
rounds bitwise: the same seeds in the same order from ``generator``, the
same schedule points, the same round step.

``--grad_buckets``: the learner plans the buckets at parameter leaf
boundaries in the flat vector's order (``state.make_grad_buckets``),
aligned to the tiled sketch's 128-lane blocks in sketch mode.

``--client_k_dist``: each round's (W,) budgets are drawn on the host from
the keyed Philox stream (``faults.cohort_client_ks``, memoized per
client) and passed to the round as one device tensor.

``mesh=`` (``parallel/mesh.py``, a ``DeviceMesh`` with a ``clients``
dimension; every rank builds the same learner and is fed the same
batches): the learner keeps the rank's row block of the client rows (or
its shard of the host arenas), hands the round its workers' columns and
the whole ids and mask, and every rank's weights and server state stay
bitwise the others'. The generator is seeded alike on every rank, so the
rounds' seeds, and the server's draws from them, are the same on all.

A mesh with a ``model`` axis of M (2-D clients x model federation, the
reference's ``api.py:95-102``) pads the flat vector to a multiple of M
(``cfg.grad_size_pad``; the pad coordinates get no gradient, decay or
update and are never charged to the byte counters), and each model rank
STORES only its ``coord_block`` of the weights, ``last_changed``, the
dense modes' server momentum and error and the dense codec's client
rows: d/M of the flat state, where a clients-only rank holds d. The
sketch tables and the sparse and sketched codecs' O(k) rows stay whole
on every model rank. A GPT2 model then computes tensor-parallel
(``parallel/tp.py``): ``tp.attach`` puts the model axis on its config and
the round and validation take its compute shards through a
``TPUnflatten``; any other model computes replicated on the model axis.
``full_weights()`` is the whole padded vector on every rank. Under
``--client_state_offload`` the host arenas of a model rank hold the
dense codec's rows as their coordinate blocks (``client_rows_shardings``'
``(clients, model)`` split), and the sparse and sketched codecs' whole
encodings (encoded from the whole row every model rank holds, so the
stored pairs are the one-process encode's); ``--server_mode buffered``
and ``--grad_buckets`` split by coordinate as the round does.

A mesh with a ``seq`` axis of S (sequence parallelism, GPT2 with ring
attention: ``parallel/seq.py``) attaches the axis to the model, and the
learner cuts each batch column with a sequence dimension (the loss's
``seq_columns``) to the rank's block of ``cfg.max_seq_len``
(``seq_cut``, a ``SeqCut``) beside the worker block, for the rounds and
the validation; the state is replicated over the axis.

A mesh with an ``expert`` axis (MoE expert parallelism, GPT2 with
``--moe_experts``: ``parallel/ep.py``) attaches the axis to the model and
the round and validation take the rank's expert leaves through an
``EPUnflatten``; the state is replicated over the axis, as in the
reference.

Dropout: the learner owns a ``torch.Generator`` seeded with ``seed``
(the reference's round rng) and draws one seed from it per round.

Per-coordinate LR: ``lr_scale_vec``, a (d,) vector or a callable that
builds one from the model (``utils.params.scalar_lr_multipliers``, the
Fixup recipe), makes each round's lr ``lr * vec`` in float32, which the
server rules and fedavg's local steps multiply into the update as they
do a scalar lr. ``trainable_mask``, a (d,) 0/1 vector, freezes the
coordinates where it is 0 (``utils/finetune.py``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.client_store import (HostArenaStore,
                                                            make_codec)
from commefficient_tpu_torch.federated.faults import cohort_client_ks
from commefficient_tpu_torch.federated.round import (FedState,
                                                     build_eval_step,
                                                     build_round_step,
                                                     init_fed_state,
                                                     split_leaves)
from commefficient_tpu_torch.federated.state import (CLIENT_STATE_FIELDS,
                                                     ClientState,
                                                     make_grad_buckets)
from commefficient_tpu_torch.ops.countsketch import LANES
from commefficient_tpu_torch.parallel import ep as ep_lib
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.parallel import seq as seq_lib
from commefficient_tpu_torch.parallel import tp as tp_lib
from commefficient_tpu_torch.utils.device import resolve_device
from commefficient_tpu_torch.utils.params import flatten_params


class FedLearner:
    def __init__(self, model: torch.nn.Module, cfg: FedConfig,
                 loss_train: Callable, loss_val: Optional[Callable] = None,
                 lr_schedule: Optional[Callable] = None, device="cuda",
                 seed: int = 0, lr_scale_vec=None, trainable_mask=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.model = model.to(self.device)
        flat, self.unflatten = flatten_params(self.model)
        d_logical = flat.shape[0]
        M = mesh_lib.model_size(mesh)
        if M > 1:
            cfg = dataclasses.replace(
                cfg, mesh_shape=(mesh_lib.clients_size(mesh), M),
                mesh_axis_names=(mesh_lib.AXIS, "model"))
        self.cfg = cfg.finalize(d_logical, pad_to=M)
        self.mesh = mesh
        self.worker_slice = slice(None)
        self.coord_block = (0, self.cfg.grad_dim)
        if self.cfg.grad_dim != d_logical:
            # the pad coordinates: never reached by unflatten, so they get
            # no gradient, decay or update
            flat = torch.cat([flat, flat.new_zeros(self.cfg.grad_dim
                                                   - d_logical)])
            base = self.unflatten
            self.unflatten = lambda fp: base(fp[:d_logical])  # noqa: E731
        compute_unflatten = self.unflatten
        if M > 1:
            self.coord_block = mesh_lib.coord_block(self.cfg.grad_dim, mesh)
            if getattr(getattr(self.model, "config", None), "n_head", None):
                ctx = tp_lib.TPContext.from_mesh(mesh)
                tp_lib.attach(self.model, ctx)
                layout = tp_lib.TPLayout(
                    {n: tuple(p.shape)
                     for n, p in self.model.named_parameters()},
                    self.model.config.n_head, M)
                compute_unflatten = tp_lib.TPUnflatten(
                    self.unflatten, d_logical, layout, ctx)
        ep_ctx = ep_lib.EPContext.from_mesh(mesh)
        if ep_ctx is not None:
            # the state stays replicated over the expert axis; the
            # compute takes the rank's expert leaves
            ep_lib.attach(self.model, ep_ctx)
            compute_unflatten = ep_lib.EPUnflatten(
                self.unflatten, d_logical, ep_lib.EPLayout(
                    {n: tuple(p.shape)
                     for n, p in self.model.named_parameters()},
                    ep_ctx.size), ep_ctx)
        self.seq_cut = None
        seq_ctx = seq_lib.SeqContext.from_mesh(mesh)
        if seq_ctx is not None:
            columns = getattr(loss_train, "seq_columns", None)
            if columns is None:
                raise ValueError("a seq mesh axis needs a sequence-parallel "
                                 "loss (parallel/seq.py: its seq_columns "
                                 "name the columns to cut)")
            seq_lib.attach(self.model, seq_ctx)
            self.seq_cut = seq_lib.SeqCut(columns, self.cfg.max_seq_len,
                                          seq_ctx.rank, seq_ctx.size)
        num_rows = None
        if mesh is not None:
            # the reference's _check_mesh, before anything is allocated
            from commefficient_tpu_torch.federated.round import check_mesh
            check_mesh(self.cfg, mesh)
            self.worker_slice = mesh_lib.worker_block(self.cfg.num_workers,
                                                      mesh)
            lo, hi = mesh_lib.row_block(self.cfg.num_clients, mesh)
            num_rows = hi - lo
        self.state: FedState = init_fed_state(self.cfg, flat,
                                              num_rows=num_rows,
                                              block=self.coord_block)
        self.codec = make_codec(self.cfg)
        self._offload = (self.cfg.client_state_offload
                         and self.cfg.has_client_state)
        self.host_store = self.host_clients = self._offload_pipe = None
        if self._offload:
            # --topk_down's stale weights start at the initial weights
            fill = (flat.detach().cpu() if self.cfg.needs_client_weights
                    else None)
            codec, coords = self.codec, None
            if M > 1 and split_leaves(self.cfg)[1]:
                # a model rank's arenas hold its block of each dense row
                coords = self.coord_block
                codec = type(self.codec)(coords[1] - coords[0])
                fill = None if fill is None else fill[coords[0]:coords[1]]
            self.host_store = HostArenaStore(
                self.cfg, codec, flat_weights=fill,
                num_shards=mesh_lib.clients_size(mesh),
                local_shard=(None if mesh is None
                             else mesh_lib.clients_rank(mesh)),
                coord_block=coords)
            self.host_clients = {f: self.host_store.view(f)
                                 for f in CLIENT_STATE_FIELDS}
            self._offload_pipe = HostOffloadPipeline(
                self, depth=self.cfg.offload_pipeline_depth)
        self.grad_buckets = make_grad_buckets(
            [t.numel() for t in self.unflatten(flat).values()],
            self.cfg.grad_dim, self.cfg.grad_buckets,
            align=LANES if (self.cfg.mode == "sketch"
                            and self.cfg.sketch_scheme == "tiled") else 1)
        if trainable_mask is not None:
            trainable_mask = torch.as_tensor(
                trainable_mask, dtype=torch.float32, device=self.device)
            if trainable_mask.shape == (d_logical,) != (self.cfg.grad_dim,):
                # the pads stay frozen
                trainable_mask = torch.cat([trainable_mask,
                                            trainable_mask.new_zeros(
                                                self.cfg.grad_dim
                                                - d_logical)])
            if trainable_mask.shape != (self.cfg.grad_dim,):
                raise ValueError(
                    f"trainable_mask must have shape ({self.cfg.grad_dim},)"
                    f", got {tuple(trainable_mask.shape)}")
        # kept for subclasses that build more programs over the same loss
        # (federated/buffer.BufferedFedLearner)
        self._loss_train = loss_train
        self._compute_unflatten = compute_unflatten
        self._trainable_mask = trainable_mask
        self._round = build_round_step(loss_train, compute_unflatten,
                                       self.cfg, buckets=self.grad_buckets,
                                       trainable_mask=trainable_mask,
                                       mesh=mesh)
        if self._round.sketch is not None:
            # the kernels' hash tables reach the card here, not by blocking
            # copies inside the first round
            self._round.sketch.prepare(self.device)
        self._eval = build_eval_step(loss_val or loss_train,
                                     compute_unflatten)
        self.lr_schedule = lr_schedule or (lambda t: cfg.lr_scale)
        if callable(lr_scale_vec):
            lr_scale_vec = lr_scale_vec(self.model)
        if lr_scale_vec is not None:
            lr_scale_vec = torch.as_tensor(lr_scale_vec, dtype=torch.float32,
                                           device=self.device)
            if lr_scale_vec.shape != (self.cfg.grad_size,):
                raise ValueError(
                    f"lr_scale_vec must have shape ({self.cfg.grad_size},), "
                    f"got {tuple(lr_scale_vec.shape)}")
            if self.cfg.grad_dim != d_logical:
                lr_scale_vec = torch.cat([lr_scale_vec, lr_scale_vec.new_ones(
                    self.cfg.grad_dim - d_logical)])
        self.lr_scale_vec = lr_scale_vec
        self._client_k_memo = {}
        self.rounds_done = 0
        self.total_download_bytes = 0.0
        self.total_upload_bytes = 0.0

    def lr_at(self, t: float) -> float:
        return float(self.lr_schedule(t))

    def full_weights(self) -> torch.Tensor:
        """The whole (padded) flat weight vector: ``state.weights``, or on
        a model axis the model ranks' blocks joined (every rank must
        call it)."""
        return mesh_lib.model_all_gather(self.state.weights, self.mesh)

    def _to_device(self, x, dtype=None):
        """``x`` on the learner's device: a tensor (already there, as
        ``data.prefetch.device_prefetch`` leaves it) is taken as it is,
        anything else is copied from the host. To a CUDA device the copy
        goes from pinned memory without blocking the host: a copy from
        pageable memory would wait for the work queued on the stream,
        every round, and the pinned block is not reused before the copy
        has run (PyTorch's host allocator records the copy's event)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        host = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _cols(self, c, i: int, stacked: bool = False):
        """Batch column ``i`` on the device: on a mesh this rank's workers
        only, on a seq axis its block of the sequence (a prefetched column
        arrives cut already)."""
        if (self.mesh is not None
                and c.shape[1 if stacked else 0] == self.cfg.num_workers):
            c = c[:, self.worker_slice] if stacked else c[self.worker_slice]
        if self.seq_cut is not None:
            c = self.seq_cut.apply(i, c)
        return self._to_device(c)

    def _client_ks(self, client_ids) -> torch.Tensor:
        """The cohort's (W,) ``--client_k_dist`` budgets as one device
        tensor (a pure function of (cfg.seed, client), memoized)."""
        return self._to_device(cohort_client_ks(
            self.cfg.seed, np.asarray(client_ids), self.cfg.k,
            self.cfg.client_k_dist, memo=self._client_k_memo), torch.int64)

    def flush_offload(self):
        """Drain the offload pipeline: every pending writeback lands in
        the arenas and the gather-ahead buffer is dropped. No-op off the
        offload path. ``train_round`` calls it, so a synchronous caller
        always sees current ``host_clients``; a loop calls it at every
        epoch's end and before an abort returns."""
        if self._offload_pipe is not None:
            self._offload_pipe.flush_all()

    def _next_seed(self) -> int:
        """The next round's seed from ``generator``: one draw a round."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.generator))

    def _lr_in(self, lr: float):
        # the reference's lr_in: float32(lr) times the vector, rounded once
        return lr if self.lr_scale_vec is None else lr * self.lr_scale_vec

    def train_round_async(self, client_ids, batch, mask, epoch_frac=None,
                          next_client_ids=None):
        """Dispatch one round and return its metrics as device tensors
        (read them with ``finalize_round_metrics``). ``next_client_ids``:
        the next round's ids, whose rows the offload pipeline then gathers
        while this round computes (ignored off the offload path)."""
        lr = self.lr_at(self.rounds_done if epoch_frac is None
                        else epoch_frac)
        seed = self._next_seed()
        args = (self._to_device(client_ids, torch.int32),
                tuple(self._cols(c, i) for i, c in enumerate(batch)),
                self._to_device(mask, torch.float32), self._lr_in(lr), seed)
        ks = (self._client_ks(client_ids) if self.cfg.client_k_active
              else None)
        if self._offload:
            ids_np = np.asarray(client_ids).astype(np.int64)
            rows = self._offload_pipe.gather(ids_np)
            self.state, out_rows, raw = self._round(
                self.state, *args, rows=rows, client_ks=ks)
            self._offload_pipe.push(ids_np, np.asarray(mask).any(axis=1),
                                    out_rows)
            if next_client_ids is not None:
                self._offload_pipe.prefetch(
                    np.asarray(next_client_ids).astype(np.int64))
        else:
            self.state, raw = self._round(self.state, *args, client_ks=ks)
        self.rounds_done += 1
        raw["lr"] = lr
        return raw

    def finalize_round_metrics(self, raw):
        """Read one round's device metrics on the host, with one copy, and
        add its bytes to the totals."""
        if "lr" not in raw:
            raise ValueError("round metrics were already finalized "
                             "(finalize_* consumes its input)")
        if isinstance(raw["lr"], list):
            raise TypeError("this is a train_rounds_scan result; use "
                            "finalize_scan_metrics")
        lr = raw.pop("lr")
        out = _unpack_metrics(_pack_metrics(raw).cpu().numpy(), lr)
        self.total_download_bytes += out["download_bytes"]
        self.total_upload_bytes += out["upload_bytes"]
        return out

    def train_round(self, client_ids, batch, mask, epoch_frac=None):
        """Run one federated round and return its host metrics; offloaded
        rows are flushed to the arenas after it."""
        out = self.finalize_round_metrics(
            self.train_round_async(client_ids, batch, mask,
                                   epoch_frac=epoch_frac))
        self.flush_offload()
        return out

    def train_rounds_scan(self, client_ids, batches, masks,
                          epoch_fracs=None):
        """Dispatch K rounds from one window: ``client_ids`` (K, W), each
        column of ``batches`` stacked to (K, W, B, ...), ``masks`` (K, W,
        B). The stacked inputs go to the device in one copy each (or are
        taken as they are where they are there already), the K rounds are
        enqueued back to back and their metrics stacked on the device.
        The seeds are K draws from ``generator`` in the order of K
        ``train_round_async`` calls and the LRs the schedule's at
        ``rounds_done + k`` (or ``epoch_fracs`` (K,)), so the window
        equals K single rounds bitwise. Returns the raw stacked metrics for
        ``finalize_scan_metrics``."""
        if self._offload:
            raise ValueError(
                "train_rounds_scan needs device-resident client state "
                "(offloaded rows are host-gathered per round); run with "
                "scan_rounds=1 under client_state_offload")
        ids_host = np.asarray(client_ids)
        K = ids_host.shape[0]
        ts = (np.asarray(epoch_fracs, np.float64) if epoch_fracs is not None
              else np.arange(self.rounds_done, self.rounds_done + K))
        lrs = [self.lr_at(float(t)) for t in ts]
        seeds = [self._next_seed() for _ in range(K)]
        ids = self._to_device(ids_host, torch.int32)
        cols = tuple(self._cols(c, i, stacked=True)
                     for i, c in enumerate(batches))
        m = self._to_device(masks, torch.float32)
        ks = None
        if self.cfg.client_k_active:
            # the (K, W) budgets, one row a round: the per-round draws
            ks = self._to_device(np.stack([
                cohort_client_ks(self.cfg.seed, row, self.cfg.k,
                                 self.cfg.client_k_dist,
                                 memo=self._client_k_memo)
                for row in ids_host]), torch.int64)
        packed = []
        for k in range(K):
            self.state, raw = self._round(
                self.state, ids[k], tuple(c[k] for c in cols), m[k],
                self._lr_in(lrs[k]), seeds[k],
                client_ks=None if ks is None else ks[k])
            packed.append(_pack_metrics(raw))
        self.rounds_done += K
        # host-known, so the dispatch stays asynchronous
        return {"packed": torch.stack(packed), "lr": lrs}

    def finalize_scan_metrics(self, raw):
        """Read a ``train_rounds_scan`` result with one copy to the host:
        a list of K per-round dicts of ``finalize_round_metrics``' schema;
        each round's bytes are added to the totals."""
        if "lr" not in raw:
            raise ValueError("scan metrics were already finalized "
                             "(finalize_* consumes its input)")
        if not isinstance(raw["lr"], list):
            raise TypeError("this is a single-round result; use "
                            "finalize_round_metrics")
        lrs = raw.pop("lr")
        rows = raw["packed"].cpu().numpy()
        results = []
        for row, lr in zip(rows, lrs):
            out = _unpack_metrics(row, lr)
            self.total_download_bytes += out["download_bytes"]
            self.total_upload_bytes += out["upload_bytes"]
            results.append(out)
        return results

    def pipeline(self) -> "RoundPipeline":
        """A one-round software pipeline over this learner (see
        ``RoundPipeline``)."""
        return RoundPipeline(self)

    def scan_window(self, k: int) -> "ScanWindow":
        """A K-round window buffer over this learner (see ``ScanWindow``)."""
        if self._offload:
            raise ValueError(
                "--scan_rounds K>1 is incompatible with "
                "--client_state_offload (rows are host-gathered per "
                "round); use scan_rounds=1")
        return ScanWindow(self, k)

    def evaluate(self, batches: Iterable):
        """Centralized validation over an iterable of (batch_tuple, mask)."""
        loss_sum, metric_sums, n_total, num_batches = 0.0, None, 0.0, 0
        weights = self.full_weights()
        for batch, mask in batches:
            num_batches += 1
            if self.seq_cut is not None:
                batch = tuple(self.seq_cut.apply(i, c)
                              for i, c in enumerate(batch))
            out = self._eval(weights,
                             tuple(self._to_device(c) for c in batch),
                             self._to_device(mask, torch.float32))
            loss_sum += float(out["loss_sum"])
            ms = out["metric_sums"].cpu().numpy()
            metric_sums = ms if metric_sums is None else metric_sums + ms
            n_total += float(out["num_datapoints"])
        n = max(n_total, 1.0)
        return {"loss": loss_sum / n,
                "metrics": (metric_sums if metric_sums is not None
                            else np.zeros(1)) / n,
                "num_datapoints": n, "num_batches": num_batches}


#: the scalar metrics of a round, in the order ``_pack_metrics`` lays them
#: out ahead of ``metric_sums``
_PACKED_SCALARS = ("loss_sum", "num_datapoints", "download_bytes",
                   "upload_bytes", "update_l2", "aborted")


def _pack_metrics(raw) -> torch.Tensor:
    """One round's device metrics as one float32 row: the scalars of
    ``_PACKED_SCALARS`` (each a float32 value or a bool, so exact), then
    ``metric_sums``."""
    return torch.cat([torch.stack([raw[key].to(torch.float32)
                                   for key in _PACKED_SCALARS]),
                      raw["metric_sums"].to(torch.float32)])


def _unpack_metrics(row: np.ndarray, lr: float) -> dict:
    """``finalize_round_metrics``' dict from a packed row on the host."""
    v = dict(zip(_PACKED_SCALARS, (float(x) for x in row)))
    n = max(v["num_datapoints"], 1.0)
    return {
        "loss": v["loss_sum"] / n,
        "metrics": row[len(_PACKED_SCALARS):] / n,
        "num_datapoints": n,
        "download_bytes": v["download_bytes"],
        "upload_bytes": v["upload_bytes"],
        "update_l2": v["update_l2"],
        "aborted": bool(v["aborted"]),
        "lr": float(lr),
    }


class RoundPipeline:
    """One-round software pipeline over a ``FedLearner``.

    ``push`` takes a dispatched round's raw (device) metrics and returns
    the previous round's finalized metrics (None for the first), so that
    the host's read of round t overlaps round t+1 on the device; ``flush``
    after the loop returns the last round's. A loop therefore sees each
    round's metrics one round late: a NaN abort lags one round, and the
    round's sticky device guard keeps the rounds after a breach from
    changing anything."""

    def __init__(self, learner: FedLearner):
        self.learner = learner
        self._pending = None

    def push(self, raw):
        out = self.flush()
        self._pending = raw
        return out

    def flush(self):
        out = None
        if self._pending is not None:
            out = self.learner.finalize_round_metrics(self._pending)
            self._pending = None
        return out


class ScanWindow:
    """Buffers a loop's rounds and runs every K of them as one
    ``train_rounds_scan`` window (``--scan_rounds K``). ``push`` returns
    the window's finalized per-round metrics (a list) when it ran one,
    else None; ``flush`` after the loop runs the shorter tail window."""

    def __init__(self, learner: FedLearner, k: int):
        self.learner = learner
        self.k = max(1, int(k))
        self._buf = []

    def push(self, client_ids, cols, mask, epoch_frac):
        self._buf.append((np.asarray(client_ids), tuple(cols), mask,
                          epoch_frac))
        if len(self._buf) >= self.k:
            return self.flush()
        return None

    def flush(self):
        if not self._buf:
            return []
        ids_k = np.stack([b[0] for b in self._buf])
        cols_k = tuple(_stack([b[1][i] for b in self._buf])
                       for i in range(len(self._buf[0][1])))
        mask_k = _stack([b[2] for b in self._buf])
        fracs = [b[3] for b in self._buf]
        self._buf.clear()
        return self.learner.finalize_scan_metrics(
            self.learner.train_rounds_scan(ids_k, cols_k, mask_k,
                                           epoch_fracs=fracs))


def _stack(items):
    """Stack a window's arrays: on their device where they are tensors
    (prefetched), on the host otherwise."""
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items)
    return np.stack([np.asarray(a) for a in items])


class HostOffloadPipeline:
    """Gather-ahead and lazy writeback of host-offloaded client rows.

    The rows live in the learner's ``HostArenaStore`` in the run's codec
    encoding, and cross to the device encoded; the round decodes and
    encodes them there (``client_store.py``).

    * gather-ahead: with the next round's ids (``prefetch``), their rows
      are stacked into a pinned staging buffer and copied to the device on
      a side stream while the current round computes; the compute stream
      waits on the copy's event before it reads them.
    * lazy writeback: a round's output rows wait in a queue of at most
      ``depth`` rounds as device tensors, and are copied back (on the side
      stream, into a pinned buffer, then into the arenas) when the queue
      overflows or ``flush_all`` runs.

    A gather resolves each id against the queue newest-first before the
    arena, so a round sees the latest value of every row whenever its
    writeback lands; the queue holds encoded rows, what the arena will
    hold, so a flush never changes what a gather sees. The round returns
    the input encoding for padded and guarded slots, and padded slots are
    never written back. ``stats`` counts gathers, gather-ahead hits and
    rows read from the queue, and the host seconds of gathers and
    writebacks.

    Copy-stream hazards: the arena stays pageable and only the
    ``(W, row)`` staging buffers are pinned (pinning gigabytes costs
    seconds); a staging buffer is rewritten only after the event of its
    last copy; a tensor made on the side stream and read on the compute
    stream (and the reverse) is ``record_stream``-ed so that the caching
    allocator does not hand out its memory early."""

    def __init__(self, learner: FedLearner, depth: int = 2):
        if int(depth) < 1:
            raise ValueError(f"offload_pipeline_depth must be >= 1, got "
                             f"{depth}")
        self.learner = learner
        self.depth = int(depth)
        self.device = learner.device
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)
        self._pending = deque()   # (ids_np, valid_np, out_rows, event)
        self._prefetched = None   # (ids key, rows ClientState)
        self._pushes = 0          # pending-queue generation counter
        self._prefetch_gen = -1
        # pinned staging: two for gathers (the one of the gather-ahead may
        # still be in flight while the next is built), one for writebacks,
        # pinned here rather than in the middle of a round
        self._staging = {}
        self._staging_events = {}
        self._gather_slot = 0
        if self._cuda:
            W = learner.cfg.num_workers
            for field in CLIENT_STATE_FIELDS:
                if learner.host_store.view(field) is not None:
                    for slot in (0, 1, "flush"):
                        self._staging_for((field, slot, W))
        self.stats = {"gathers": 0, "prefetch_hits": 0,
                      "rows_from_pending": 0, "flushed_rounds": 0,
                      "gather_s": 0.0, "scatter_s": 0.0}

    # --- staging ---------------------------------------------------------
    def _staging_for(self, key):
        """A host tree shaped like ``W`` encoded rows of ``field``, for
        ``key = (field, slot, W)``: pinned and reused on CUDA, once the
        event of its last copy has passed; fresh tensors on the CPU, where
        the round reads it directly."""
        field, _, W = key
        proto = self.learner.host_store.arena(field)

        def alloc(a):
            return torch.empty((W,) + tuple(a.shape[1:]), dtype=a.dtype,
                               pin_memory=self._cuda)
        if not self._cuda:
            return tree_map(alloc, proto)
        if key not in self._staging:
            self._staging[key] = tree_map(alloc, proto)
        event = self._staging_events.pop(key, None)
        if event is not None:
            event.synchronize()
        return self._staging[key]

    # --- gather side -----------------------------------------------------
    def _pending_row(self, field: str, cid: int):
        """The newest not-yet-written output row of client ``cid`` as
        (device tree, slot), or None. Within a round the last valid slot
        wins, as in the ascending-slot writeback."""
        for ids_np, valid, out, _ in reversed(self._pending):
            if getattr(out, field) is None:
                continue
            for w in range(len(ids_np) - 1, -1, -1):
                if valid[w] and ids_np[w] == cid:
                    return getattr(out, field), w
        return None

    def _build_gather(self, ids_np):
        """The sampled clients' encoded rows, W-leading, on the device.
        Out-of-range ids (padded slots) clamp, as a device gather would;
        their rows are inert (zero mask). On a mesh only the slots of the
        clients this rank's arena owns are filled: the round routes them
        to their workers' ranks."""
        store = self.learner.host_store
        t0 = time.perf_counter()
        slot = self._gather_slot
        self._gather_slot ^= 1
        W = len(ids_np)
        fields = {}
        for field in CLIENT_STATE_FIELDS:
            if store.view(field) is None:
                fields[field] = None
                continue
            cids = [int(np.clip(i, 0, store.num_rows - 1)) for i in ids_np]
            hits = {}
            key = (field, slot, W)
            host = self._staging_for(key)
            for w, cid in enumerate(cids):
                if not store.owns(cid):
                    continue
                hit = self._pending_row(field, cid)
                if hit is not None:
                    hits[w] = hit
                    self.stats["rows_from_pending"] += 1
                    continue
                tree_map(lambda o, r: o[w].copy_(r), host,
                         store.row(field, cid))
            rows = self._to_device(host, key)
            for w, (tree, src) in hits.items():
                tree_map(lambda o, p: o[w].copy_(p[src]), rows, tree)
            fields[field] = rows
        self.stats["gathers"] += 1
        self.stats["gather_s"] += time.perf_counter() - t0
        return ClientState(**fields)

    def _to_device(self, host, key):
        """``host`` (a staging tree) on the device, copied on the side
        stream; the compute stream waits for the copy."""
        if not self._cuda:
            return host
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            rows = tree_map(lambda a: a.to(self.device, non_blocking=True),
                            host)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._staging_events[key] = done
        compute.wait_event(done)
        # made on the side stream, read on the compute stream
        tree_map(lambda a: a.record_stream(compute), rows)
        return rows

    def gather(self, ids_np):
        """Rows for a round about to run: the gather-ahead buffer if it
        matches (same ids, no round pushed since it was built), else a
        fresh gather."""
        if self._prefetched is not None:
            key, rows = self._prefetched
            self._prefetched = None
            if (key == tuple(int(i) for i in ids_np)
                    and self._prefetch_gen == self._pushes):
                self.stats["prefetch_hits"] += 1
                return rows
        return self._build_gather(ids_np)

    def prefetch(self, ids_np):
        """Gather the next round's rows now: their copies overlap the
        current round's compute."""
        self._prefetched = (tuple(int(i) for i in ids_np),
                            self._build_gather(ids_np))
        self._prefetch_gen = self._pushes

    # --- scatter side ----------------------------------------------------
    def push(self, ids_np, valid, out_rows: ClientState):
        """Queue a finished round's output rows for lazy writeback."""
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._pending.append((np.asarray(ids_np), np.asarray(valid),
                              out_rows, event))
        self._pushes += 1
        while len(self._pending) > self.depth:
            self._flush_one()

    def _to_host(self, rows, event, field: str):
        """A device tree's values on the host: on CUDA copied on the side
        stream, after the round that made it, into pinned staging."""
        if not self._cuda:
            return rows
        host = self._staging_for((field, "flush", _slots(rows)))
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(event)
            tree_map(lambda h, d: h.copy_(d, non_blocking=True), host, rows)
            # made on the compute stream, read on the side stream
            tree_map(lambda d: d.record_stream(self._copy_stream), rows)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return host

    def _flush_one(self):
        store = self.learner.host_store
        t0 = time.perf_counter()
        ids_np, valid, out, event = self._pending.popleft()
        for field in CLIENT_STATE_FIELDS:
            new = getattr(out, field)
            if store.view(field) is None or new is None:
                continue
            host = self._to_host(new, event, field)
            for w, cid in enumerate(ids_np):
                if valid[w] and store.owns(cid):
                    store.set_row(field, int(cid),
                                  tree_map(lambda a: a[w], host))
        self.stats["flushed_rounds"] += 1
        self.stats["scatter_s"] += time.perf_counter() - t0

    def flush_all(self):
        """Apply every pending writeback and drop the gather-ahead
        buffer."""
        while self._pending:
            self._flush_one()
        self._prefetched = None


def _slots(tree) -> int:
    """The leading (slot) extent of an encoded row tree."""
    return tree_leaves(tree)[0].shape[0]
