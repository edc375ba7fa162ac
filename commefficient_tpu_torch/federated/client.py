"""Client-side computation (port of ``commefficient_tpu/federated/client.py``;
DP, gradient clipping, microbatching and ``--topk_down`` are ROADMAP.md
A5).

The reference vmaps one client's step over the round's W workers. Here
the gradients run one worker at a time (``compute_gradient``), and the
rest of the step — local momentum, local error, the local top-k and its
masking — runs on the stacked ``(W, d)`` rows at once, so the local
top-k is one batched kernel launch per radix round for all W clients.
The per-worker gradients differ from the reference's vmapped ones only in
summation order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.ops.topk import topk


class ClientStepOut(NamedTuple):
    transmit: torch.Tensor             # (W, d): sum-of-gradients scaled
    velocity: Optional[torch.Tensor]   # (W, d) or None
    error: Optional[torch.Tensor]      # (W, d) or None
    loss_sum: torch.Tensor             # (W,)
    metric_sums: torch.Tensor          # (W, M)
    num_datapoints: torch.Tensor       # (W,)


def _masked_loss_and_grad(apply_loss, unflatten, w_flat, batch, mask,
                          seed=None):
    """Gradient of the summed loss over valid examples, with respect to
    the flat weights, plus the summed loss and metrics; ``seed`` feeds the
    model's dropout."""
    w = w_flat.detach().requires_grad_(True)
    per_ex_loss, per_ex_metrics = apply_loss(unflatten(w), batch, seed,
                                             True)
    loss_sum = torch.sum(per_ex_loss * mask)
    metric_sums = torch.sum(per_ex_metrics.detach() * mask[None, :], dim=-1)
    (grad,) = torch.autograd.grad(loss_sum, w)
    return grad, loss_sum.detach(), metric_sums


def compute_gradient(apply_loss, unflatten, forward_weights, batch, mask,
                     cfg: FedConfig, seed=None):
    """One client's mean gradient over its valid examples plus weight
    decay ``(wd / W) * w`` (every worker adds it and the server sums),
    and its summed loss, metrics and datapoint count."""
    n = torch.sum(mask)
    grad_sum, loss_sum, metric_sums = _masked_loss_and_grad(
        apply_loss, unflatten, forward_weights, batch, mask, seed)
    grad = grad_sum / torch.clamp(n, min=1.0)
    if cfg.weight_decay != 0:
        grad = grad + (cfg.weight_decay / cfg.num_workers) * forward_weights
    return grad, loss_sum, metric_sums, n


def client_step(apply_loss, unflatten, ps_weights, batch, mask, velocity,
                error, cfg: FedConfig, seeds=None) -> ClientStepOut:
    """The local step of the round's W non-fedavg clients: ``batch`` is a
    tuple of ``(W, B, ...)`` tensors, ``mask`` ``(W, B)``, ``velocity`` and
    ``error`` the clients' ``(W, d)`` rows or None, ``seeds`` the W
    clients' dropout seeds (None: no dropout drawn)."""
    W = mask.shape[0]
    seeds = [None] * W if seeds is None else seeds
    outs = [compute_gradient(apply_loss, unflatten, ps_weights,
                             tuple(c[w] for c in batch), mask[w], cfg,
                             seeds[w])
            for w in range(W)]
    g, loss_sum, metric_sums, n = (torch.stack(x) for x in zip(*outs))
    # sum-of-gradients semantics: scale each mean back up by its batch
    # size so the server can divide by the total datapoints
    g = g * n[:, None]

    if cfg.local_momentum > 0:
        velocity = g + cfg.local_momentum * velocity
        carrier = velocity
    else:
        carrier = g
    if cfg.error_type == "local":
        error = error + carrier
        to_transmit = error
    else:
        to_transmit = carrier

    if cfg.mode == "local_topk":
        to_transmit = topk(to_transmit, cfg.k)
        support = to_transmit != 0
        if cfg.error_type == "local":
            error = torch.where(support, 0.0, error)       # error feedback
        if cfg.local_momentum > 0:
            velocity = torch.where(support, 0.0, velocity)  # factor masking
    return ClientStepOut(transmit=to_transmit, velocity=velocity,
                         error=error, loss_sum=loss_sum,
                         metric_sums=metric_sums, num_datapoints=n)


def fedavg_client_step(apply_loss, unflatten, ps_weights, batch, mask, lr,
                       cfg: FedConfig, seed=None):
    """FedAvg for one client: ``num_fedavg_epochs`` of local SGD over its
    whole (padded) data in chunks of ``fedavg_batch_size``, transmitting
    the weight delta scaled by its datapoint count. The lr decays per real
    local step: the exponent is ``epoch * n_real_chunks + chunk_idx``,
    padded ghost chunks (all-zero mask tails) not counted, as in the
    reference. Local step ``s`` draws its dropout from ``fold_in(seed,
    s)``. Returns ``(transmit (d,), loss_sum, metric_sums, n)``, the loss
    and metrics averaged over the epochs."""
    max_b = mask.shape[0]
    chunk = (max_b if cfg.fedavg_batch_size == -1
             else min(cfg.fedavg_batch_size, max_b))
    n_chunks = -(-max_b // chunk)
    pad = n_chunks * chunk - max_b

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    batch = tuple(padded(c) for c in batch)
    mask_p = padded(mask)
    n_real_chunks = torch.sum(
        (mask_p.view(n_chunks, chunk).sum(1) > 0).to(torch.float32))

    w = ps_weights
    loss_sum = metric_sums = 0.0
    for step in range(n_chunks * cfg.num_fedavg_epochs):
        epoch, b_idx = divmod(step, n_chunks)
        sl = slice(b_idx * chunk, (b_idx + 1) * chunk)
        g, ls, ms, n = compute_gradient(
            apply_loss, unflatten, w, tuple(c[sl] for c in batch),
            mask_p[sl], cfg, None if seed is None else fold_in(seed, step))
        eff_step = epoch * n_real_chunks + b_idx
        decay = torch.pow(cfg.fedavg_lr_decay, eff_step)
        # g is already the mean gradient over the chunk
        w = w - g * lr * decay * (n > 0).to(torch.float32)
        loss_sum = loss_sum + ls
        metric_sums = metric_sums + ms
    client_n = torch.sum(mask)
    return ((ps_weights - w) * client_n,
            loss_sum / cfg.num_fedavg_epochs,
            metric_sums / cfg.num_fedavg_epochs, client_n)


@torch.no_grad()
def eval_step(apply_loss, unflatten, weights, batch, mask):
    """Validation forward pass: (loss sum, metric sums, count)."""
    per_ex_loss, per_ex_metrics = apply_loss(unflatten(weights), batch,
                                             None, False)
    return (torch.sum(per_ex_loss * mask),
            torch.sum(per_ex_metrics * mask[None, :], dim=-1),
            torch.sum(mask))
