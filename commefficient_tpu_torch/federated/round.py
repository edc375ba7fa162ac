"""The federated round (port of ``commefficient_tpu/federated/round.py``).

Two paths, as in the reference:

* fused clients (``fused_clients_eligible``: uncompressed, sketch and
  true_topk with no per-client state): the sum of the clients' gradients
  is the gradient of the summed loss, so one backward over the
  ``(W*B, ...)`` batch replaces W; in sketch mode the sketch is linear,
  so the round sketches the aggregate once;
* per worker (local_topk, fedavg, any mode with local momentum or
  local error, and every mode under ``--dp`` or ``--max_grad_norm``):
  each client's step on its own batch and client-state rows, the
  transmits of padded slots zeroed, summed and divided by the
  datapoints. In sketch mode a per-worker nonlinearity breaks the
  sketch's linearity, so each client transmits its own table (all W
  sketched in one batched launch) and the round sums tables instead of
  sketching the aggregate. fedavg clients apply the lr themselves, so
  the server takes lr = 1; true_topk with local momentum masks the
  clients' velocities at the global update's support; the client rows go
  back by scatter.

Then the server update, the sticky NaN guard (a select, so a NaN update
cannot leak into the weights), the per-coordinate ``last_changed`` round
and the exact upload/download byte metrics, all on the device with no
host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated import client as client_lib
from commefficient_tpu_torch.federated.client_store import (
    gather_rows, init_client_storage, scatter_rows)
from commefficient_tpu_torch.federated.server import (init_server_opt_state,
                                                      make_sketch,
                                                      server_update)
from commefficient_tpu_torch.federated.state import (ClientState,
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
    clients: ClientState             # (num_clients + 1, d) rows
    round_idx: torch.Tensor          # () int32
    last_changed: torch.Tensor       # (d,) int32: round each weight changed
    client_last_round: torch.Tensor  # (num_clients,) int32
    aborted: torch.Tensor            # () bool: NaN guard tripped (sticky)


def init_fed_state(cfg: FedConfig, flat_weights: torch.Tensor) -> FedState:
    d, dev = cfg.grad_dim, flat_weights.device
    if flat_weights.shape != (d,):
        raise ValueError(f"flat weights of shape {tuple(flat_weights.shape)}"
                         f", expected ({d},)")
    return FedState(
        weights=flat_weights.to(torch.float32),
        opt=init_server_opt_state(cfg, dev),
        clients=init_client_storage(cfg, dev),
        round_idx=torch.zeros((), dtype=torch.int32, device=dev),
        # -2 = "never changed": below the -1 "never participated" sentinel
        last_changed=torch.full((d,), -2, dtype=torch.int32, device=dev),
        client_last_round=torch.full((cfg.num_clients,), -1,
                                     dtype=torch.int32, device=dev),
        aborted=torch.zeros((), dtype=torch.bool, device=dev))


def download_counts(last_changed: torch.Tensor,
                    stale_round: torch.Tensor) -> torch.Tensor:
    """Per participant, the number of weights changed since it last
    pulled: ``#{i : last_changed[i] >= stale_round[w]}``, by one sorted
    search and a histogram instead of a (W, d) comparison."""
    W = stale_round.shape[0]
    d_total = last_changed.shape[0]
    order = torch.argsort(stale_round, stable=True)
    sorted_stale = stale_round[order].contiguous()
    buckets = torch.searchsorted(sorted_stale, last_changed.contiguous(),
                                 right=True)
    hist = torch.bincount(buckets, minlength=W + 1)
    below_sorted = torch.cumsum(hist, 0)[:W]
    counts = torch.zeros(W, dtype=torch.int32, device=last_changed.device)
    counts[order] = (d_total - below_sorted).to(torch.int32)
    return counts


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
                     cfg: FedConfig) -> Callable:
    """``round_step(state, client_ids (W,), batch (W, B, ...), mask (W, B),
    lr, seed) -> (FedState, metrics)``, every tensor on the state's
    device. The fused path draws its dropout from ``seed``; in the
    per-worker path client ``c`` draws from ``fold_in(seed, c)``, as the
    reference folds the client id into the round's rng. The server's DP
    noise draws from ``fold_in(seed, SERVER_NOISE_FOLD)``, the
    reference's ``noise_rng``."""
    cfg.validate()
    sketch = make_sketch(cfg) if cfg.mode == "sketch" else None
    is_fedavg = cfg.mode == "fedavg"
    fused_clients = fused_clients_eligible(cfg)
    # sum of sketches == sketch of the sum unless a per-worker
    # nonlinearity (the DP clip and noise, the sketch-space clip) comes
    # between; then each client sketches its own gradient
    client_sketch = (sketch if cfg.do_dp or cfg.max_grad_norm is not None
                     else None)

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
        agg = grad_sum / torch.clamp(total_n, min=1.0)
        return agg, loss_total, metric_totals, total_n

    def per_worker_step(state, ids, batch, mask, valid_w, lr, seed):
        w = state.weights
        # one host read of the W ids: the seeds are host ints
        seeds = [fold_in(seed, c) for c in ids.tolist()]
        if is_fedavg:
            outs = [client_lib.fedavg_client_step(
                apply_loss, unflatten, w, tuple(c[i] for c in batch),
                mask[i], lr, cfg, seeds[i]) for i in range(mask.shape[0])]
            transmit, loss_sum, metric_sums, n = (torch.stack(x)
                                                  for x in zip(*outs))
            new_vels = new_errs = None
        else:
            out = client_lib.client_step(
                apply_loss, unflatten, w, batch, mask,
                gather_rows(state.clients.velocities, ids),
                gather_rows(state.clients.errors, ids), cfg, seeds,
                client_sketch)
            transmit, loss_sum, metric_sums, n = (
                out.transmit, out.loss_sum, out.metric_sums,
                out.num_datapoints)
            new_vels, new_errs = out.velocity, out.error
        total_n = torch.sum(n)
        # padded slots are zeroed: with local error feedback their
        # transmit would otherwise leak the aliased client's error row
        valid = valid_w.view((-1,) + (1,) * (transmit.dim() - 1))
        agg = (torch.sum(transmit * valid, dim=0)
               / torch.clamp(total_n, min=1.0))
        return (agg, torch.sum(loss_sum), torch.sum(metric_sums, dim=0),
                total_n, new_vels, new_errs)

    def round_step(state: FedState, client_ids, batch, mask, lr, seed):
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
            new_vels = new_errs = None
        else:
            (agg, loss_total, metric_totals, total_n, new_vels,
             new_errs) = per_worker_step(state, ids, batch, mask, valid_w,
                                         lr, seed)
        if sketch is not None and client_sketch is None:
            agg = sketch.sketch_vec(agg)

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
        clients = ClientState(
            velocities=scatter_rows(state.clients.velocities, scatter_ids,
                                    new_vels),
            errors=scatter_rows(state.clients.errors, scatter_ids,
                                new_errs))

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
        return new_state, metrics

    return round_step


def build_eval_step(apply_loss: Callable, unflatten: Callable) -> Callable:
    """Centralized validation step."""

    def eval_step(weights, batch, mask):
        loss_sum, metric_sums, n = client_lib.eval_step(
            apply_loss, unflatten, weights, batch, mask)
        return {"loss_sum": loss_sum, "metric_sums": metric_sums,
                "num_datapoints": n}

    return eval_step
