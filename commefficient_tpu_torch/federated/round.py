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

Then the server update, the sticky NaN guard (a select, so a NaN update
cannot leak into the weights), the per-coordinate ``last_changed`` round
and the exact upload/download byte metrics, all on the device with no
host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client as client_lib
from commefficient_tpu_torch.federated.client_store import (
    gather_rows, init_client_storage, make_codec, scatter_rows, select_rows)
from commefficient_tpu_torch.federated.server import (init_server_opt_state,
                                                      make_sketch,
                                                      server_update)
from commefficient_tpu_torch.federated.state import (ClientState,
                                                     GradBuckets,
                                                     ServerOptState)
from commefficient_tpu_torch.ops.dropout import fold_in

#: fold-in domain of the server's DP noise seed under the round's seed
#: (the reference's ``noise_rng = fold_in(rng, 0x5e77e7)``)
SERVER_NOISE_FOLD = 0x5E77E7


@dataclass
class FedState:
    """What persists across rounds (the reference's ``FedState`` without
    quarantine or buffer)."""
    weights: torch.Tensor            # (d,) f32
    opt: ServerOptState              # virtual momentum / error
    clients: ClientState             # (num_clients + 1, ...) encoded rows
    round_idx: torch.Tensor          # () int32
    last_changed: torch.Tensor       # (d,) int32: round each weight changed
    client_last_round: torch.Tensor  # (num_clients,) int32
    aborted: torch.Tensor            # () bool: NaN guard tripped (sticky)


def init_fed_state(cfg: FedConfig, flat_weights: torch.Tensor) -> FedState:
    d, dev = cfg.grad_dim, flat_weights.device
    if flat_weights.shape != (d,):
        raise ValueError(f"flat weights of shape {tuple(flat_weights.shape)}"
                         f", expected ({d},)")
    if cfg.client_state_offload and cfg.has_client_state:
        # the rows live in the learner's host arenas
        clients = ClientState()
    else:
        clients = init_client_storage(cfg, make_codec(cfg), flat_weights)
    return FedState(
        weights=flat_weights.to(torch.float32),
        opt=init_server_opt_state(cfg, dev),
        clients=clients,
        round_idx=torch.zeros((), dtype=torch.int32, device=dev),
        # -2 = "never changed": below the -1 "never participated" sentinel
        last_changed=torch.full((d,), -2, dtype=torch.int32, device=dev),
        client_last_round=torch.full((cfg.num_clients,), -1,
                                     dtype=torch.int32, device=dev),
        aborted=torch.zeros((), dtype=torch.bool, device=dev))


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
    gradient of the summed loss."""
    return (cfg.mode in ("uncompressed", "sketch", "true_topk")
            and not cfg.do_dp and cfg.max_grad_norm is None
            and not cfg.do_topk_down
            and not cfg.needs_velocity_state
            and cfg.error_type != "local"
            and cfg.microbatch_size == -1)


def build_round_step(apply_loss: Callable, unflatten: Callable,
                     cfg: FedConfig,
                     buckets: Optional[GradBuckets] = None) -> Callable:
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
    SERVER_NOISE_FOLD)``, the reference's ``noise_rng``."""
    cfg.validate()
    sketch = make_sketch(cfg) if cfg.mode == "sketch" else None
    is_fedavg = cfg.mode == "fedavg"
    fused_clients = fused_clients_eligible(cfg)
    # sum of sketches == sketch of the sum unless a per-worker
    # nonlinearity (the DP clip and noise, the sketch-space clip) comes
    # between; then each client sketches its own gradient
    client_sketch = (sketch if cfg.do_dp or cfg.max_grad_norm is not None
                     else None)
    sketch_after_aggregate = sketch is not None and client_sketch is None
    codec = make_codec(cfg)
    offload = cfg.client_state_offload and cfg.has_client_state
    bucketed = (buckets is not None and buckets.num_buckets > 1
                and (cfg.mode != "sketch" or sketch_after_aggregate))
    if bucketed and sum(buckets.sizes) != cfg.grad_dim:
        raise ValueError(f"GradBuckets plan covers {sum(buckets.sizes)} "
                         f"coordinates, round has {cfg.grad_dim}")

    def compress(chunk_of):
        """The round's aggregate from ``chunk_of(offset, size)``, the
        aggregated (size,) slice: the whole vector, sketched once in
        sketch mode; or bucket by bucket, the chunks joined by
        concatenation (dense) or their tables added in bucket order."""
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
        grad_sum, loss_total, metric_totals = \
            client_lib._masked_loss_and_grad(apply_loss, unflatten, w,
                                             flat_cols, flat_mask, seed)
        total_n = torch.sum(flat_mask)
        if cfg.weight_decay != 0:
            # each valid worker adds (wd/W)*w scaled by its datapoints
            grad_sum = grad_sum + (cfg.weight_decay / cfg.num_workers) \
                * w * total_n
        denom = torch.clamp(total_n, min=1.0)
        agg = compress(lambda o, n: grad_sum[o:o + n] / denom)
        return agg, loss_total, metric_totals, total_n

    def client_rows(state, ids, rows):
        """The W clients' dense (velocity, error, stale weight) rows."""
        if offload:
            return tuple(None if enc is None else codec.decode_rows(enc)
                         for enc in (rows.velocities, rows.errors,
                                     rows.weights))
        return tuple(gather_rows(storage, ids, codec)
                     for storage in (state.clients.velocities,
                                     state.clients.errors,
                                     state.clients.weights))

    def per_worker_step(state, ids, batch, mask, valid_w, lr, seed, rows,
                        client_ks):
        w = state.weights
        # one host read of the W ids: the seeds are host ints
        seeds = [fold_in(seed, c) for c in ids.tolist()]
        if is_fedavg:
            outs = [client_lib.fedavg_client_step(
                apply_loss, unflatten, w, tuple(c[i] for c in batch),
                mask[i], lr, cfg, seeds[i]) for i in range(mask.shape[0])]
            transmit, loss_sum, metric_sums, n = (torch.stack(x)
                                                  for x in zip(*outs))
            new_vels = new_errs = new_stale = None
        else:
            vels, errs, stales = client_rows(state, ids, rows)
            out = client_lib.client_step(
                apply_loss, unflatten, w, batch, mask, vels, errs, cfg,
                seeds, client_sketch, stales, client_ks=client_ks)
            transmit, loss_sum, metric_sums, n = (
                out.transmit, out.loss_sum, out.metric_sums,
                out.num_datapoints)
            new_vels, new_errs, new_stale = (out.velocity, out.error,
                                             out.client_weights)
        total_n = torch.sum(n)
        # padded slots are zeroed: with local error feedback their
        # transmit would otherwise leak the aliased client's error row
        valid = valid_w.view((-1,) + (1,) * (transmit.dim() - 1))
        denom = torch.clamp(total_n, min=1.0)
        if client_sketch is not None:
            agg = torch.sum(transmit * valid, dim=0) / denom
        else:
            agg = compress(lambda o, k: torch.sum(
                transmit[:, o:o + k] * valid, dim=0) / denom)
        return (agg, torch.sum(loss_sum), torch.sum(metric_sums, dim=0),
                total_n, new_vels, new_errs, new_stale)

    def round_step(state: FedState, client_ids, batch, mask, lr, seed,
                   rows: Optional[ClientState] = None, client_ks=None):
        if offload and rows is None:
            raise ValueError("an offloaded round takes the clients' rows")
        w = state.weights
        ids = client_ids.long()
        num_clients = state.client_last_round.shape[0]
        # epoch-tail rounds carry fewer than W real clients: padded slots
        # have all-zero masks and neither transmit nor count in the bytes
        valid_w = torch.any(mask > 0, dim=1)

        # download accounting before this round's update
        stale_round = state.client_last_round[ids]
        counts = download_counts(state.last_changed, stale_round)
        download_floats = torch.sum(
            counts * valid_w.to(torch.int32)).to(torch.float32)

        if fused_clients:
            agg, loss_total, metric_totals, total_n = fused_step(
                w, batch, mask, seed)
            new_vels = new_errs = new_stale = None
        else:
            (agg, loss_total, metric_totals, total_n, new_vels, new_errs,
             new_stale) = per_worker_step(state, ids, batch, mask, valid_w,
                                          lr, seed, rows, client_ks)

        # in-round NaN guard: a breaching round and every round after it
        # leave weights, state and accounting untouched
        loss_mean = loss_total / torch.clamp(total_n, min=1.0)
        breach = ~torch.isfinite(loss_mean) | (loss_mean > cfg.nan_threshold)
        ok = ~breach & ~state.aborted
        okf = ok.to(torch.float32)
        # out-of-range ids (padded or guarded slots) write the sink row
        scatter_ids = torch.where(valid_w & ok, ids, num_clients)

        update, new_opt = server_update(
            agg, state.opt, cfg, 1.0 if is_fedavg else lr, sketch=sketch,
            noise_seed=fold_in(seed, SERVER_NOISE_FOLD))
        update = torch.where(ok, update, 0.0)
        new_opt = ServerOptState(
            Vvelocity=torch.where(ok, new_opt.Vvelocity,
                                  state.opt.Vvelocity),
            Verror=torch.where(ok, new_opt.Verror, state.opt.Verror))
        new_w = w - update

        if cfg.mode == "true_topk" and new_vels is not None:
            # momentum factor masking of the participating clients'
            # velocities at the global top-k support
            new_vels = torch.where((update != 0)[None, :], 0.0, new_vels)
        new_rows = (new_vels, new_errs, new_stale)
        if offload:
            keep = valid_w & ok

            def frozen(new_dense, old_enc):
                # a frozen slot returns its input encoding bitwise
                if old_enc is None or new_dense is None:
                    return old_enc
                return select_rows(keep, codec.encode_rows(new_dense),
                                   old_enc)

            out_rows = ClientState(*(
                frozen(new, old) for new, old in zip(
                    new_rows, (rows.velocities, rows.errors, rows.weights))))
            clients = state.clients
        else:
            out_rows = None
            clients = ClientState(*(
                scatter_rows(storage, scatter_ids, new, codec)
                for storage, new in zip(
                    (state.clients.velocities, state.clients.errors,
                     state.clients.weights), new_rows)))

        new_last_changed = torch.where(update != 0, state.round_idx,
                                       state.last_changed)
        new_client_last = torch.cat([
            state.client_last_round,
            torch.zeros(1, dtype=torch.int32, device=w.device)])
        new_client_last[scatter_ids] = state.round_idx
        new_client_last = new_client_last[:num_clients]

        aborted = state.aborted | breach
        new_state = FedState(
            weights=new_w, opt=new_opt, clients=clients,
            round_idx=state.round_idx + ok.to(torch.int32),
            last_changed=new_last_changed,
            client_last_round=new_client_last,
            aborted=aborted)
        metrics = {
            "loss_sum": loss_total,
            "metric_sums": metric_totals,
            "num_datapoints": total_n,
            "aborted": aborted,
            "download_bytes": 4.0 * download_floats * okf,
            "upload_bytes": (4.0 * cfg.upload_floats_per_client
                             * torch.sum(valid_w.to(torch.float32)) * okf),
            "update_l2": torch.linalg.vector_norm(update),
        }
        if offload:
            return new_state, out_rows, metrics
        return new_state, metrics

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
