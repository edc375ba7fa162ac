"""The federated round (port of ``commefficient_tpu/federated/round.py``).

Two paths, as in the reference:

* fused clients (``fused_clients_eligible``: uncompressed, sketch and
  true_topk with no per-client state): the sum of the clients' gradients
  is the gradient of the summed loss, so one backward over the
  ``(W*B, ...)`` batch replaces W; in sketch mode the sketch is linear,
  so the round sketches the aggregate once;
* per worker (local_topk, fedavg, any mode with local momentum or
  local error, and every mode under ``--dp``, ``--max_grad_norm``,
  ``--topk_down`` or ``--microbatch_size``):
  each client's step on its own batch and client-state rows, the
  transmits of padded slots zeroed, summed and divided by the
  datapoints. In sketch mode a per-worker nonlinearity breaks the
  sketch's linearity, so each client transmits its own table (all W
  sketched in one batched launch) and the round sums tables instead of
  sketching the aggregate. fedavg clients apply the lr themselves, so
  the server takes lr = 1; true_topk with local momentum masks the
  clients' velocities at the global update's support; under
  ``--topk_down`` each client computes at its stale weights plus the
  top-k of the difference, which become its new stale row; the client
  rows go back by scatter.

Client rows cross the round boundary through the ``--client_state``
codec (``federated/client_store.py``): decoded on gather, encoded on
scatter. Under ``--client_state_offload`` the state keeps no rows: the
round takes the W sampled clients' encoded rows as an argument and
returns their new encodings, a frozen slot (padded, or in a guarded
round) its input encoding bitwise, for the host pipeline to write back.
Under ``--client_k_dist`` the local top-k takes each client's budget.

``--grad_buckets`` (a ``GradBuckets`` plan) builds the aggregate bucket
by bucket: dense modes slice the transmit's reduce at the bucket edges
and join the chunks by concatenation (bitwise the unbucketed
aggregate); a sketch-after-aggregate round sketches each chunk at its
offset and adds the tables in bucket order (equal to the monolithic
table up to float32 association at the bucket edges). A per-worker
sketched transmit is a table already, with nothing to bucket.

Then the server tail (``build_server_tail``, shared with the buffered
server's apply): the server update, the sticky NaN guard (a select, so a
NaN update cannot leak into the weights), the client-row writeback, the
per-coordinate ``last_changed`` round and the exact upload/download byte
metrics, all on the device with no host sync.

On a mesh with a ``model`` axis (2-D clients x model federation) each
rank stores the ``coord_block`` of the flat state (``api.FedLearner``),
and a round runs, in order: the model group all-gathers the weights (and
the dense codec's client rows and a dense mode's server state); the
rank's clients step on its tensor-parallel shard (``parallel/tp.py``),
the model group joining the flat gradient; in sketch mode each model
rank reduces its block over the clients axis and sketches only that
block (``sketch_range`` at its offset: the hashes are keyed on global
coordinates) and the model group sums the tables, while the other modes
join the whole transmit over the clients axis as a 1-D mesh does; the
server tail runs whole on every rank (the recovery and top-k kernels over
the whole d, as the reference's Pallas calls see the gathered vector);
and each rank keeps its block of what changed. With ``--grad_buckets``
each model rank compresses each bucket's intersection with its block:
the dense chunks joined over the model group, or in sketch mode each
intersection sketched at its (128-aligned) offset and the tables summed
over the buckets and the model group. Offloaded dense rows are the
rank's coordinate block of each row, joined after the owners route them.

On a mesh with a ``seq`` axis (sequence parallelism, ``parallel/seq.py``;
the fused path only) rank (c, s) runs client shard c's workers on its
block of the sequence, its dropout from ``seq.shard_seed``; the
gradient's reduce spans both axes (each seq rank holds its block's
share), the loss, metric and datapoint sums only the clients axis (the
seq ranks' losses are the same), and the tail runs replicated.

On a mesh with a ``stage`` axis (GPipe, ``parallel/pp.py``; the fused
path only) the S ranks of client shard c run its workers through one
pipeline, each rank the blocks of its stage, with the dropout seed of the
clients axis (``mesh_seed``; the pipeline folds each stage's ticks into
it); the gradient's reduce spans both axes (each stage rank holds the
gradient of the parameters it reads, zeros elsewhere), the loss, metric
and datapoint sums only the clients axis (every stage rank returns the
last stage's loss), and the tail runs replicated.

On a mesh with an ``expert`` axis (MoE expert parallelism,
``parallel/ep.py``; the fused path only) the E ranks of client shard c
run its workers together, each its experts' share of every MoE block,
with the dropout seed of the clients axis (``mesh_seed``: the expert
ranks of a shard draw the same masks); every rank holds the whole
gradient (``EPUnflatten`` joins the expert leaves), so the gradient's
reduce spans the clients axis only: a world sum would count the
replicated leaves E times.

On any clients axis above 1 the fused path's MoE blocks route every
rank's tokens as one call, as the reference's one GSPMD loss call does
(``ops/moe.py`` ``routing_group``: the capacity, the slots and the aux
term of the whole batch); the per-worker path routes each client alone,
as the reference's vmap does.

``--client_quarantine`` forces the per-worker path: a client on the
bench (``state.quarantine``) neither pulls nor uploads, a non-finite
contribution is excluded from the aggregate by a select (NaN * 0 is
NaN) and its client benched for ``quarantine_rounds`` applied rounds,
and only a post-exclusion breach trips the sticky guard. A
``trainable_mask`` (the finetune path) zeroes the frozen coordinates of
every gradient before compression and of the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_map

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client as client_lib
from commefficient_tpu_torch.federated.client_store import (
    gather_rows, init_client_storage, make_codec, scatter_rows, select_rows)
from commefficient_tpu_torch.federated.server import (init_server_opt_state,
                                                      make_sketch,
                                                      server_update)
from commefficient_tpu_torch.federated.state import (BufferState,
                                                     ClientState,
                                                     GradBuckets,
                                                     ServerOptState)
from commefficient_tpu_torch.ops import moe as moe_lib
from commefficient_tpu_torch.ops.countsketch import LANES
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.parallel import seq as seq_lib

#: fold-in domain of the server's DP noise seed under the round's seed
#: (the reference's ``noise_rng = fold_in(rng, 0x5e77e7)``)
SERVER_NOISE_FOLD = 0x5E77E7


@dataclass
class FedState:
    """What persists across rounds (the reference's ``FedState``)."""
    weights: torch.Tensor            # (d,) f32
    opt: ServerOptState              # virtual momentum / error
    clients: ClientState             # (num_clients + 1, ...) encoded rows
    round_idx: torch.Tensor          # () int32
    last_changed: torch.Tensor       # (d,) int32: round each weight changed
    client_last_round: torch.Tensor  # (num_clients,) int32
    aborted: torch.Tensor            # () bool: NaN guard tripped (sticky)
    # () int32: server applies that moved the weights (round_idx in sync
    # mode; the version buffered contributions are stamped with)
    weights_version: torch.Tensor
    # (num_clients,) int32: applied rounds of bench left per client
    quarantine: torch.Tensor
    # the buffered server's M-slot buffer (federated/buffer.py), or None
    buffer: Optional[BufferState] = None


def init_fed_state(cfg: FedConfig, flat_weights: torch.Tensor,
                   num_rows: Optional[int] = None,
                   block: Optional[tuple] = None) -> FedState:
    """The round-0 state. ``num_rows``: the client rows this process
    holds (its ``row_block`` on a mesh; every client's by default).
    ``block``: the ``(lo, hi)`` coordinates a model-axis rank stores of
    the weights, ``last_changed``, the dense server state and the dense
    client rows (``mesh.coord_block``; all of them by default)."""
    d, dev = cfg.grad_dim, flat_weights.device
    if flat_weights.shape != (d,):
        raise ValueError(f"flat weights of shape {tuple(flat_weights.shape)}"
                         f", expected ({d},)")
    lo, hi = block or (0, d)
    if cfg.client_state_offload and cfg.has_client_state:
        # the rows live in the learner's host arenas
        clients = ClientState()
    else:
        clients = init_client_storage(cfg, make_codec(cfg), flat_weights,
                                      num_rows=num_rows, block=(lo, hi))
    weights = flat_weights.to(torch.float32)
    if (lo, hi) != (0, d):
        weights = weights[lo:hi].clone()
    return FedState(
        weights=weights,
        opt=init_server_opt_state(cfg, dev, width=hi - lo),
        clients=clients,
        round_idx=torch.zeros((), dtype=torch.int32, device=dev),
        # -2 = "never changed": below the -1 "never participated" sentinel
        last_changed=torch.full((hi - lo,), -2, dtype=torch.int32,
                                device=dev),
        client_last_round=torch.full((cfg.num_clients,), -1,
                                     dtype=torch.int32, device=dev),
        aborted=torch.zeros((), dtype=torch.bool, device=dev),
        weights_version=torch.zeros((), dtype=torch.int32, device=dev),
        quarantine=torch.zeros((cfg.num_clients,), dtype=torch.int32,
                               device=dev))


def split_leaves(cfg: FedConfig) -> tuple:
    """Beside the weights and ``last_changed``, what a model-axis rank
    stores a coordinate block of: ``(server state, client rows)``, a
    dense mode's (d,) momentum and error, and the dense codec's rows (the
    sketch tables and the O(k) encodings stay whole on every rank)."""
    return cfg.mode != "sketch", cfg.client_state == "dense"


def set_at(vec: torch.Tensor, ids: torch.Tensor, value) -> torch.Tensor:
    """A copy of the (n,) ``vec`` with ``value`` (a scalar or one per id)
    written at ``ids``; an id of n (a dropped slot) writes nothing, as
    the reference's ``.at[ids].set(value, mode="drop")``. Written into a
    copy one longer, so nothing syncs with the host."""
    n = vec.shape[0]
    out = torch.cat([vec, vec.new_zeros(1)])
    out[ids] = torch.as_tensor(value, dtype=vec.dtype, device=vec.device)
    return out[:n]


def download_counts(last_changed: torch.Tensor,
                    stale_round: torch.Tensor) -> torch.Tensor:
    """Per participant, the number of weights changed since it last
    pulled: ``#{i : last_changed[i] >= stale_round[w]}``, as W
    comparison-and-count reductions over ``last_changed``, one per
    participant, with no (W, d) comparison. The integers are the
    reference's sorted-search histogram's (a ``bincount`` of d buckets
    into W + 1 bins serializes on a few atomics on the card, most of all
    when nearly every weight is still at -2)."""
    return torch.stack([torch.sum(last_changed >= s, dtype=torch.int32)
                        for s in stale_round])


def fused_clients_eligible(cfg: FedConfig) -> bool:
    """Whether the round may take the fused-gradient path: no per-client
    state or nonlinearity, so the sum of the clients' gradients is the
    gradient of the summed loss. Quarantine judges each contribution, so
    it needs the per-worker path."""
    return (cfg.mode in ("uncompressed", "sketch", "true_topk")
            and not cfg.do_dp and cfg.max_grad_norm is None
            and not cfg.do_topk_down
            and not cfg.needs_velocity_state
            and cfg.error_type != "local"
            and cfg.microbatch_size == -1
            and not cfg.client_quarantine)


def client_sketch_of(cfg: FedConfig, sketch):
    """The sketch each client applies to its own gradient, or None. The
    sum of sketches is the sketch of the sum unless a per-worker
    nonlinearity (the DP clip and noise, the sketch-space clip) comes
    between; then each client sketches its own gradient."""
    return sketch if cfg.do_dp or cfg.max_grad_norm is not None else None


def build_client_phase(apply_loss: Callable, unflatten: Callable,
                       cfg: FedConfig, sketch=None,
                       trainable_mask: Optional[torch.Tensor] = None
                       ) -> Callable:
    """``clients(state, ids (W,) int64, batch, mask, lr, seed, rows=None,
    client_ks=None) -> ClientStepOut``: the per-worker clients' steps
    against ``state.weights``, shared by the sync round's per-worker path
    and the buffered server's cohort. Client ``c`` draws from
    ``fold_in(seed, c)``, as the reference folds the client id into the
    round's rng. ``rows``: the clients' encoded rows (under offload, or
    on a mesh), else they are gathered from ``state``."""
    is_fedavg = cfg.mode == "fedavg"
    client_sketch = client_sketch_of(cfg, sketch)
    codec = make_codec(cfg)

    def client_rows(state, ids, rows):
        """The W clients' dense (velocity, error, stale weight) rows: the
        given encoded ``rows`` (offloaded, or routed from their owners on
        a mesh) decoded, else gathered from the state."""
        if rows is not None:
            return tuple(None if enc is None else codec.decode_rows(enc)
                         for enc in (rows.velocities, rows.errors,
                                     rows.weights))
        return tuple(gather_rows(storage, ids, codec)
                     for storage in (state.clients.velocities,
                                     state.clients.errors,
                                     state.clients.weights))

    def clients(state, ids, batch, mask, lr, seed, rows=None,
                client_ks=None, weights=None) -> client_lib.ClientStepOut:
        # ``weights``: the whole vector (a model-axis rank stores a block)
        w = state.weights if weights is None else weights
        # one host read of the W ids: the seeds are host ints
        seeds = [fold_in(seed, c) for c in ids.tolist()]
        if is_fedavg:
            outs = [client_lib.fedavg_client_step(
                apply_loss, unflatten, w, tuple(c[i] for c in batch),
                mask[i], lr, cfg, seeds[i], trainable_mask=trainable_mask)
                for i in range(mask.shape[0])]
            transmit, loss_sum, metric_sums, n = (torch.stack(x)
                                                  for x in zip(*outs))
            return client_lib.ClientStepOut(transmit, None, None, None,
                                            loss_sum, metric_sums, n)
        vels, errs, stales = client_rows(state, ids, rows)
        return client_lib.client_step(
            apply_loss, unflatten, w, batch, mask, vels, errs, cfg,
            seeds, client_sketch, stales, client_ks=client_ks,
            trainable_mask=trainable_mask)

    return clients


def finite_contributions(out: client_lib.ClientStepOut) -> torch.Tensor:
    """(W,) bool: the client's loss and every coordinate of its transmit
    are finite (quarantine's per-contribution verdict)."""
    W = out.transmit.shape[0]
    return (torch.isfinite(out.loss_sum)
            & torch.all(torch.isfinite(out.transmit.reshape(W, -1)), dim=1))


def last_of(ids: torch.Tensor, sink: int) -> torch.Tensor:
    """``ids`` with every id but its last occurrence replaced by ``sink``:
    a scatter of per-slot values then writes each id once, from its last
    slot (the order a sequential scatter leaves), on any device."""
    later = torch.triu(ids[:, None] == ids[None, :], diagonal=1).any(dim=1)
    return torch.where(later, sink, ids)


def build_server_tail(cfg: FedConfig, sketch=None,
                      trainable_mask: Optional[torch.Tensor] = None,
                      mesh=None, rows_blocked: bool = False) -> Callable:
    """``server_tail(state, agg, loss_mean, ids, contrib_w, pull_w, finite_w,
    pulled_at, new_rows, download_floats, lr, seed) -> (FedState,
    writeback, metrics)``: what follows the aggregation, shared by the sync
    round and the buffered server's apply.

    The slots (W clients, or M buffer slots) carry client ``ids`` (an id
    of ``num_clients`` is the sink); ``pull_w`` marks the slots that
    pulled and uploaded, ``contrib_w`` those in the aggregate, and
    ``finite_w`` (quarantine only, else None) the finite contributions;
    ``pulled_at`` is the version each slot pulled at (a scalar, or one per
    slot); ``new_rows`` the slots' dense (velocity, error, stale weight)
    rows, each None if absent. The tail runs the breach check on
    ``loss_mean``, the server update gated by it and by the trainable
    mask, the client-row writeback of the contributing slots (by scatter,
    or under offload returned as ``writeback = (ids, encoded rows)``, the
    others' ids ``num_clients``), ``last_changed``, the download
    baseline, the bench clock and the byte metrics. The returned state
    keeps ``state.buffer``.

    On a ``mesh`` every argument but ``new_rows`` is the whole (replicated)
    slot vector and ``new_rows`` are this rank's block of slots: each rank
    encodes its block, the blocks are joined in slot order, and each rank
    writes the rows of the clients it owns into its row block (under
    offload the writeback carries every slot, for the owners' arenas).
    ``rows_blocked``: on a model axis the dense codec's ``new_rows`` are
    the rank's coordinate block already (the buffered server's slots),
    not whole rows to cut."""
    is_fedavg = cfg.mode == "fedavg"
    codec = make_codec(cfg)
    offload = cfg.client_state_offload and cfg.has_client_state
    quarantine = cfg.client_quarantine
    split = mesh_lib.model_size(mesh) > 1
    lo, hi = mesh_lib.coord_block(cfg.grad_dim, mesh) if split \
        else (0, cfg.grad_dim)
    # what a model-axis rank stores a block of: a dense mode's server
    # state and the dense codec's rows
    split_opt, split_rows = (split and x for x in split_leaves(cfg))

    def whole(x):
        return mesh_lib.model_all_gather(x, mesh) if split_opt else x

    def block(x):
        # a copy: a view would keep the whole vector alive
        return x[..., lo:hi].clone() if split_opt else x

    def server_tail(state: FedState, agg, loss_mean, ids, contrib_w, pull_w,
                    finite_w, pulled_at, new_rows, download_floats, lr,
                    seed):
        num_clients = state.client_last_round.shape[0]
        # the sticky NaN guard: a breaching round and every round after it
        # leave weights, state and accounting untouched; under quarantine
        # the loss is the post-exclusion one, so only a server-side breach
        # trips it
        breach = ~torch.isfinite(loss_mean) | (loss_mean > cfg.nan_threshold)
        ok = ~breach & ~state.aborted
        okf = ok.to(torch.float32)
        oki = ok.to(torch.int32)

        opt = ServerOptState(Vvelocity=whole(state.opt.Vvelocity),
                             Verror=whole(state.opt.Verror))
        update, new_opt = server_update(
            agg, opt, cfg, 1.0 if is_fedavg else lr, sketch=sketch,
            noise_seed=fold_in(seed, SERVER_NOISE_FOLD))
        if trainable_mask is not None:
            update = update * trainable_mask
        if cfg.grad_dim != cfg.grad_size:
            # the pad coordinates never move
            update = torch.cat([update[:cfg.grad_size],
                                update.new_zeros(cfg.grad_dim
                                                 - cfg.grad_size)])
        update = torch.where(ok, update, 0.0)
        new_opt = ServerOptState(
            Vvelocity=block(torch.where(ok, new_opt.Vvelocity,
                                        opt.Vvelocity)),
            Verror=block(torch.where(ok, new_opt.Verror, opt.Verror)))

        new_vels, new_errs, new_stale = new_rows
        cut = split_rows and not rows_blocked
        if cfg.mode == "true_topk" and new_vels is not None:
            # momentum factor masking of the participating clients'
            # velocities at the global top-k support
            upd = update[lo:hi] if split_rows and rows_blocked else update
            new_vels = torch.where((upd != 0)[None, :], 0.0, new_vels)
        new_rows = (new_vels, new_errs, new_stale)
        # out-of-range ids (padded, benched, excluded or guarded slots, and
        # all but the last slot of a client) write the sink row
        scatter_ids = last_of(torch.where(contrib_w & ok, ids, num_clients),
                              num_clients)
        writeback = None
        if mesh is not None:
            enc = [None if r is None
                   else mesh_lib.all_gather_tree(codec.encode_rows(
                       r[:, lo:hi] if cut else r), mesh)
                   for r in new_rows]
            clients_state = state.clients
            if offload:
                writeback = (scatter_ids, ClientState(*enc))
            else:
                local = mesh_lib.local_row_ids(scatter_ids, num_clients, mesh)
                for storage, e in zip((state.clients.velocities,
                                       state.clients.errors,
                                       state.clients.weights), enc):
                    if storage is not None and e is not None:
                        tree_map(lambda a, b: a.index_put_((local,), b),
                                 storage, e)
        elif offload:
            writeback = (scatter_ids, ClientState(*(
                None if r is None else codec.encode_rows(r)
                for r in new_rows)))
            clients_state = state.clients
        else:
            clients_state = ClientState(*(
                scatter_rows(storage, scatter_ids, new, codec)
                for storage, new in zip(
                    (state.clients.velocities, state.clients.errors,
                     state.clients.weights), new_rows)))

        # stamps in version units (round_idx in sync mode): a weight
        # changed at version u was unseen by a client that pulled at
        # version v iff u >= v
        mine = update[lo:hi] if split else update
        new_last_changed = torch.where(mine != 0, state.weights_version,
                                       state.last_changed)
        if quarantine:
            # every client that pulled re-syncs its download baseline,
            # even if its contribution was then excluded; a non-finite
            # one is benched, and every bench clock ticks once an applied
            # round
            dropped_w = pull_w & ~finite_w
            new_client_last = set_at(
                state.client_last_round,
                last_of(torch.where(pull_w & ok, ids, num_clients),
                        num_clients), pulled_at)
            new_quarantine = set_at(
                torch.clamp(state.quarantine - oki, min=0),
                torch.where(dropped_w & ok, ids, num_clients),
                cfg.quarantine_rounds)
        else:
            new_client_last = set_at(state.client_last_round, scatter_ids,
                                     pulled_at)
            new_quarantine = state.quarantine

        aborted = state.aborted | breach
        new_state = FedState(
            weights=state.weights - mine, opt=new_opt,
            clients=clients_state,
            round_idx=state.round_idx + oki,
            last_changed=new_last_changed,
            client_last_round=new_client_last,
            aborted=aborted,
            weights_version=state.weights_version + oki,
            quarantine=new_quarantine,
            buffer=state.buffer)
        metrics = {
            "aborted": aborted,
            "download_bytes": 4.0 * download_floats * okf,
            "upload_bytes": (4.0 * cfg.upload_floats_per_client
                             * torch.sum(pull_w.to(torch.float32)) * okf),
            "update_l2": torch.linalg.vector_norm(update),
        }
        if quarantine:
            metrics["dropped_contributions"] = torch.sum(
                dropped_w.to(torch.float32)) * okf
            metrics["num_quarantined"] = torch.sum(
                (new_quarantine > 0).to(torch.int32))
        return new_state, writeback, metrics

    return server_tail


def check_mesh(cfg: FedConfig, mesh) -> None:
    """The reference's ``_check_mesh``: the worker and client axes must
    divide the mesh's ``clients`` axis."""
    n_shards = mesh_lib.clients_size(mesh)
    if cfg.num_workers % n_shards:
        raise ValueError(
            f"num_workers ({cfg.num_workers}) must be divisible by "
            f"the mesh 'clients' axis size ({n_shards})")
    if cfg.num_clients % n_shards:
        raise ValueError(
            f"num_clients ({cfg.num_clients}) must be divisible by "
            f"the mesh 'clients' axis size ({n_shards})")


def mesh_seed(seed: int, mesh) -> int:
    """A rank's stream of worker-side draws on the fused path (its
    clients' dropout): rank 0 keeps the round's seed, so a ring of one is
    the one-process round bitwise."""
    r = mesh_lib.clients_rank(mesh)
    return seed if r == 0 else fold_in(seed, r)


def mesh_client_rows(state: FedState, ids_host, rows, mesh, wslice: slice,
                     split_rows: bool = False):
    """On a mesh, the encoded rows of this rank's workers (``wslice`` of
    the W slots), from their owners: ``rows``, the W slots in which this
    rank filled the clients it owns (its offload arena's gather), or else
    the rows of its row block in ``state.clients``. None when the mode
    keeps no client rows. ``split_rows``: the rows are a model-axis
    rank's coordinate block (the dense codec), joined over the model
    group after the exchange."""
    num_clients = state.client_last_round.shape[0]
    if rows is None:
        local = mesh_lib.local_row_ids(
            torch.as_tensor(ids_host, device=state.weights.device),
            num_clients, mesh)
        rows = ClientState(*(
            None if s is None else tree_map(lambda a: a[local], s)
            for s in (state.clients.velocities, state.clients.errors,
                      state.clients.weights)))
    if all(r is None for r in (rows.velocities, rows.errors,
                               rows.weights)):
        return None
    out = mesh_lib.route_rows(rows, ids_host, num_clients, mesh, wslice)
    if not split_rows:
        return out
    return ClientState(*(
        None if r is None else mesh_lib.model_all_gather(r, mesh, dim=1)
        for r in (out.velocities, out.errors, out.weights)))


def build_round_step(apply_loss: Callable, unflatten: Callable,
                     cfg: FedConfig,
                     buckets: Optional[GradBuckets] = None,
                     trainable_mask: Optional[torch.Tensor] = None,
                     mesh=None) -> Callable:
    """``round_step(state, client_ids (W,), batch (W, B, ...), mask (W, B),
    lr, seed, rows=None, client_ks=None) -> (FedState, metrics)``, every
    tensor on the state's device (its ``sketch`` attribute: the round's
    ``CountSketch``, or None); ``lr`` is a float or a (d,) float32
    tensor of per-coordinate rates. Under ``--client_state_offload``
    ``rows`` is the W clients' encoded ``ClientState`` and the step
    returns ``(FedState, out_rows, metrics)``; ``client_ks`` is the (W,)
    device tensor of ``--client_k_dist`` budgets. The fused path draws its
    dropout from ``seed``; in the per-worker path client ``c`` draws from
    ``fold_in(seed, c)``, as the reference folds the client id into the
    round's rng. The server's DP noise draws from ``fold_in(seed,
    SERVER_NOISE_FOLD)``, the reference's ``noise_rng``.
    ``trainable_mask``: an optional (d,) float32 0/1 vector; its zeros
    freeze those weights (the finetune path).

    On a ``mesh`` (``parallel/mesh.py``) the batch's columns are this
    rank's ``worker_block`` and the ids, mask and ``client_ks`` the whole
    W; ``state.clients`` holds the rank's ``row_block``, and under offload
    ``rows`` is W slots in which the rank has filled the clients it owns
    (``out_rows`` likewise). Each rank runs its workers (the fused path
    fuses its own; its dropout from ``mesh_seed``), sums their transmits,
    and joins the sums with one ``all_reduce`` a bucket (one more for the
    loss, metric and datapoint sums); the clients' rows go from their
    owners to their workers' ranks before the clients' steps and back
    after the tail. The tail runs replicated, the byte counts from the
    whole W, so every rank's state stays bitwise the others'."""
    cfg.validate()
    if mesh is not None:
        check_mesh(cfg, mesh)
    sketch = make_sketch(cfg) if cfg.mode == "sketch" else None
    fused_clients = fused_clients_eligible(cfg)
    client_sketch = client_sketch_of(cfg, sketch)
    sketch_after_aggregate = sketch is not None and client_sketch is None
    offload = cfg.client_state_offload and cfg.has_client_state
    quarantine = cfg.client_quarantine
    bucketed = (buckets is not None and buckets.num_buckets > 1
                and (cfg.mode != "sketch" or sketch_after_aggregate))
    if bucketed and sum(buckets.sizes) != cfg.grad_dim:
        raise ValueError(f"GradBuckets plan covers {sum(buckets.sizes)} "
                         f"coordinates, round has {cfg.grad_dim}")
    split = mesh_lib.model_size(mesh) > 1
    seq = mesh_lib.seq_size(mesh) > 1
    stage = mesh_lib.stage_size(mesh) > 1
    expert = mesh_lib.expert_size(mesh) > 1
    if (seq or stage or expert) and not fused_clients:
        which = "seq" if seq else "stage" if stage else "expert"
        raise ValueError(
            f"a {which} mesh axis runs on the fused "
            "federated round only (mode uncompressed/sketch/true_topk; no "
            "local momentum/error, DP, grad clip, topk_down, microbatching "
            "or quarantine)")
    # the fused path's MoE routes every rank's tokens as one call
    route = (moe_lib.RouteGroup(mesh_lib.clients_group(mesh),
                                mesh_lib.clients_rank(mesh),
                                mesh_lib.clients_size(mesh))
             if mesh_lib.clients_size(mesh) > 1 else None)
    split_rows = split and split_leaves(cfg)[1]
    b_lo, b_hi = mesh_lib.coord_block(cfg.grad_dim, mesh) if split \
        else (0, cfg.grad_dim)
    s_lo, s_hi = mesh_lib.coord_block(
        cfg.grad_dim, mesh, align=LANES if cfg.sketch_scheme == "tiled"
        else 1) if split else (0, cfg.grad_dim)
    clients = build_client_phase(apply_loss, unflatten, cfg, sketch,
                                 trainable_mask)
    server_tail = build_server_tail(cfg, sketch, trainable_mask, mesh)
    ws = (slice(None) if mesh is None
          else mesh_lib.worker_block(cfg.num_workers, mesh))

    def reduce(x):
        """The sum over the mesh's ranks (identity off a mesh)."""
        return x if mesh is None else mesh_lib.all_reduce_sum(x, mesh)

    def reduce_grad(x):
        """The gradient's sum: over both axes of a seq or stage mesh (each
        inner rank holds its share), else ``reduce``."""
        return mesh_lib.world_all_reduce(x) if seq or stage else reduce(x)

    def reduce_sums(total_n, loss_total, metric_totals):
        """The scalar sums of every rank, in one ``all_reduce``."""
        if mesh is None:
            return total_n, loss_total, metric_totals
        packed = reduce(torch.cat([torch.stack([total_n, loss_total]),
                                   metric_totals]))
        return packed[0], packed[1], packed[2:]

    def pieces(lo, hi):
        """``[lo, hi)`` cut at the bucket edges (itself unbucketed)."""
        if not bucketed:
            return [(lo, hi)]
        return [(max(o, lo), min(o + n, hi))
                for o, n in zip(buckets.offsets, buckets.sizes)
                if max(o, lo) < min(o + n, hi)]

    def compress(chunk_of):
        """The round's aggregate from ``chunk_of(offset, size)``, the
        aggregated (size,) slice: the whole vector, sketched once in
        sketch mode; or bucket by bucket, the chunks joined by
        concatenation (dense) or their tables added in bucket order."""
        if split and sketch_after_aggregate:
            # this rank's block (its cuts on the tiled sketch's lane
            # blocks), each bucket's part of it sketched at its offset;
            # the model group sums the tables
            table = None
            for lo_i, hi_i in pieces(s_lo, s_hi):
                t = sketch.sketch_range(chunk_of(lo_i, hi_i - lo_i), lo_i)
                table = t if table is None else table + t
            return mesh_lib.model_all_reduce(table, mesh)
        if split and bucketed:
            # the buckets' parts of this rank's block, joined over the
            # model group (equal blocks, in model-rank order)
            return mesh_lib.model_all_gather(torch.cat([
                chunk_of(lo_i, hi_i - lo_i)
                for lo_i, hi_i in pieces(b_lo, b_hi)]), mesh)
        if not bucketed:
            agg = chunk_of(0, cfg.grad_dim)
            return sketch.sketch_vec(agg) if sketch_after_aggregate else agg
        chunks = [chunk_of(o, n)
                  for o, n in zip(buckets.offsets, buckets.sizes)]
        if not sketch_after_aggregate:
            return torch.cat(chunks)
        table = sketch.sketch_range(chunks[0], buckets.offsets[0])
        for off, chunk in zip(buckets.offsets[1:], chunks[1:]):
            table = table + sketch.sketch_range(chunk, off)
        return table

    def fused_step(w, batch, mask, seed):
        flat_cols = tuple(c.reshape((-1,) + tuple(c.shape[2:]))
                          for c in batch)
        flat_mask = mask.reshape(-1)
        with moe_lib.routing_group(route):
            grad_sum, loss_total, metric_totals = \
                client_lib._masked_loss_and_grad(
                    apply_loss, unflatten, w, flat_cols, flat_mask,
                    seed if mesh is None else seq_lib.shard_seed(seed, mesh)
                    if seq else mesh_seed(seed, mesh))
        if trainable_mask is not None:
            grad_sum = grad_sum * trainable_mask
        total_n, loss_total, metric_totals = reduce_sums(
            torch.sum(flat_mask), loss_total, metric_totals)
        wd = None
        if cfg.weight_decay != 0:
            # each valid worker adds (wd/W)*w scaled by its datapoints
            wd = (cfg.weight_decay / cfg.num_workers) * w * total_n
            if trainable_mask is not None:
                wd = wd * trainable_mask
            if mesh is None:
                grad_sum, wd = grad_sum + wd, None
        denom = torch.clamp(total_n, min=1.0)

        def chunk_of(o, n):
            g = reduce_grad(grad_sum[o:o + n])
            return (g if wd is None else g + wd[o:o + n]) / denom
        return compress(chunk_of), loss_total, metric_totals, total_n

    def aggregate(out: client_lib.ClientStepOut, contrib_w, select: bool):
        """The contributions' (aggregate, loss, metrics, datapoints).
        Padded slots are zeroed: with local error feedback their transmit
        would otherwise leak the aliased client's error row. ``select``:
        excluded slots are dropped by a select, so a NaN slot stays out
        (quarantine); else they are zeroed by a multiply, the reference's
        op. On a mesh ``out`` and ``contrib_w`` are the rank's workers'."""
        transmit = out.transmit
        cb = contrib_w.view((-1,) + (1,) * (transmit.dim() - 1))
        if select:
            total_n = torch.sum(torch.where(contrib_w, out.num_datapoints,
                                            0.0))
            loss_total = torch.sum(torch.where(contrib_w, out.loss_sum,
                                               0.0))
            metric_totals = torch.sum(torch.where(
                contrib_w[:, None], out.metric_sums, 0.0), dim=0)

            def masked(x):
                return torch.where(cb, x, 0.0)
        else:
            total_n = torch.sum(out.num_datapoints)
            loss_total = torch.sum(out.loss_sum)
            metric_totals = torch.sum(out.metric_sums, dim=0)

            def masked(x):
                return x * cb
        total_n, loss_total, metric_totals = reduce_sums(
            total_n, loss_total, metric_totals)
        denom = torch.clamp(total_n, min=1.0)
        if client_sketch is not None:
            agg = reduce(torch.sum(masked(transmit), dim=0)) / denom
        else:
            agg = compress(lambda o, k: reduce(torch.sum(
                masked(transmit[:, o:o + k]), dim=0)) / denom)
        return agg, loss_total, metric_totals, total_n

    def round_step(state: FedState, client_ids, batch, mask, lr, seed,
                   rows: Optional[ClientState] = None, client_ks=None):
        if offload and rows is None:
            raise ValueError("an offloaded round takes the clients' rows")
        w = mesh_lib.model_all_gather(state.weights, mesh)
        ids = client_ids.long()
        num_clients = state.client_last_round.shape[0]
        # epoch-tail rounds carry fewer than W real clients: padded slots
        # have all-zero masks and neither transmit nor count in the bytes
        valid_w = torch.any(mask > 0, dim=1)
        if quarantine:
            # benched clients sit the round out: no pull, no upload (their
            # slot still computes, and every consumer masks it)
            pull_w = valid_w & ~(state.quarantine[ids] > 0)
        else:
            pull_w = valid_w

        # download accounting before this round's update
        stale_round = state.client_last_round[ids]
        counts = download_counts(state.last_changed, stale_round)
        if split:
            # each model rank counts its block
            counts = mesh_lib.model_all_reduce(counts, mesh)
        download_floats = torch.sum(
            counts * pull_w.to(torch.int32)).to(torch.float32)

        if fused_clients:
            agg, loss_total, metric_totals, total_n = fused_step(
                w, batch, mask[ws], seed)
            out = None
            contrib_w, finite_w = valid_w, None
        else:
            ks = None if client_ks is None else client_ks[ws]
            if mesh is None:
                out = clients(state, ids, batch, mask, lr, seed, rows, ks)
            else:
                out = clients(state, ids[ws], batch, mask[ws], lr, seed,
                              mesh_client_rows(state, ids.tolist(), rows,
                                               mesh, ws, split_rows), ks,
                              weights=w)
            if quarantine:
                finite_w = finite_contributions(out)
                if mesh is not None:
                    finite_w = mesh_lib.all_gather_cat(finite_w, mesh)
                contrib_w = pull_w & finite_w
            else:
                contrib_w, finite_w = valid_w, None
            agg, loss_total, metric_totals, total_n = aggregate(
                out, contrib_w[ws], select=quarantine)

        new_rows = ((None,) * 3 if out is None else
                    (out.velocity, out.error, out.client_weights))
        new_state, writeback, tail_metrics = server_tail(
            state, agg, loss_total / torch.clamp(total_n, min=1.0), ids,
            contrib_w, pull_w, finite_w, state.round_idx, new_rows,
            download_floats, lr, seed)
        metrics = {"loss_sum": loss_total, "metric_sums": metric_totals,
                   "num_datapoints": total_n, **tail_metrics}
        if not offload:
            return new_state, metrics
        # a slot the tail did not write back (padded, benched, excluded or
        # guarded) returns its input encoding bitwise
        wb_ids, enc = writeback
        keep = wb_ids < num_clients
        out_rows = ClientState(*(
            old if old is None or new is None else select_rows(keep, new, old)
            for new, old in ((enc.velocities, rows.velocities),
                             (enc.errors, rows.errors),
                             (enc.weights, rows.weights))))
        return new_state, out_rows, metrics

    round_step.sketch = sketch
    return round_step


def build_eval_step(apply_loss: Callable, unflatten: Callable) -> Callable:
    """Centralized validation step."""

    def eval_step(weights, batch, mask):
        loss_sum, metric_sums, n = client_lib.eval_step(
            apply_loss, unflatten, weights, batch, mask)
        return {"loss_sum": loss_sum, "metric_sums": metric_sums,
                "num_datapoints": n}

    return eval_step
