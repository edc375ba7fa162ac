"""Client-side computation (port of ``commefficient_tpu/federated/client.py``;
microbatching and ``--topk_down`` are ROADMAP.md A5).

The reference vmaps one client's step over the round's W workers. Here
the gradients run one worker at a time (``mean_gradient``), and the rest
of the step runs on the stacked ``(W, d)`` rows at once, in the
reference's order (``client.py:131-178``): the raw-gradient clip
(``--max_grad_norm``, dense modes), weight decay, the DP clip and worker
noise (``--dp``), in sketch mode the per-worker sketch — all W rows in
one launch of the batched sketch kernel — and its sketch-space clip
(``--max_grad_norm`` through ``l2estimate``), then the scale by the
datapoints, local momentum, local error, and the local top-k, one
batched kernel launch per radix round for all W clients. The per-worker
gradients differ from the reference's vmapped ones only in summation
order.

Noise: client ``c``'s worker noise is drawn from a ``torch.Generator``
seeded ``fold_in(client seed, NOISE_FOLD)``, a fold-in domain that no
dropout site of the models uses (they fold in their place in the model,
small integers), on the gradient's device. It matches the reference's
``jax.random.normal`` in distribution, not in its bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.ops.sketch_kernels import sketch_vec_batched
from commefficient_tpu_torch.ops.topk import topk

#: fold-in domain of the worker DP noise seed under a client's (or a
#: fedavg local step's) seed; the models' dropout sites fold in small
#: integers, so no site draws from it
NOISE_FOLD = 0xD9_0153


class ClientStepOut(NamedTuple):
    transmit: torch.Tensor             # (W, d) or (W, r, c_eff): sum of
                                       # gradients scaled
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


def mean_gradient(apply_loss, unflatten, forward_weights, batch, mask,
                  seed=None):
    """One client's mean gradient over its valid examples, and its summed
    loss, metrics and datapoint count."""
    n = torch.sum(mask)
    grad_sum, loss_sum, metric_sums = _masked_loss_and_grad(
        apply_loss, unflatten, forward_weights, batch, mask, seed)
    return grad_sum / torch.clamp(n, min=1.0), loss_sum, metric_sums, n


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``max_norm / norm`` where ``norm`` exceeds ``max_norm``, else 1
    (reference ``client.py:108-112``, ``utils.py:305-313``)."""
    return torch.where(norm > max_norm,
                       max_norm / torch.clamp(norm, min=1e-12), 1.0)


def _clip_to_norm(vecs: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Scale each row down to ``max_norm`` if its l2 norm exceeds it."""
    return vecs * _clip_scale(
        torch.linalg.vector_norm(vecs, dim=-1, keepdim=True), max_norm)


def _worker_noise(like: torch.Tensor, seeds) -> torch.Tensor:
    """N(0, 1) rows shaped like ``like`` (W, d), row w from
    ``fold_in(seeds[w], NOISE_FOLD)``."""
    if any(s is None for s in seeds):
        raise ValueError("worker DP needs a fresh seed per client")
    out = torch.empty_like(like)
    for w, seed in enumerate(seeds):
        gen = torch.Generator(device=like.device)
        gen.manual_seed(fold_in(seed, NOISE_FOLD))
        out[w] = torch.randn(like.shape[1:], generator=gen,
                             device=like.device, dtype=like.dtype)
    return out


def finish_gradients(grads: torch.Tensor, forward_weights: torch.Tensor,
                     cfg: FedConfig, seeds) -> torch.Tensor:
    """The (W, d) mean gradients after the reference's per-client steps
    before compression (``client.py:141-161``): the raw-gradient clip in
    the dense modes, weight decay ``(wd / W) * w`` (every worker adds it
    and the server sums), then under ``--dp`` the clip to
    ``l2_norm_clip`` and, in ``dp_mode`` worker, noise
    ``noise_multiplier * sqrt(W) * N(0, 1)`` from client w's ``seeds[w]``."""
    if cfg.max_grad_norm is not None and cfg.mode != "sketch":
        grads = _clip_to_norm(grads, cfg.max_grad_norm)
    if cfg.weight_decay != 0:
        grads = grads + (cfg.weight_decay / cfg.num_workers) * forward_weights
    if cfg.do_dp:
        grads = _clip_to_norm(grads, cfg.l2_norm_clip)
        if cfg.dp_mode == "worker":
            grads = grads + (cfg.noise_multiplier
                             * math.sqrt(cfg.num_workers)) * _worker_noise(
                                 grads, seeds)
    return grads


def sketch_and_clip(grads: torch.Tensor, cfg: FedConfig,
                    sketch: CountSketch) -> torch.Tensor:
    """The W clients' (W, r, c_eff) sketches in one batched launch, each
    scaled down to ``max_grad_norm`` where its ``l2estimate`` exceeds it
    (reference ``client.py:165-178``)."""
    tables = sketch_vec_batched(sketch, grads)
    if cfg.max_grad_norm is not None:
        scale = _clip_scale(sketch.l2estimate(tables), cfg.max_grad_norm)
        tables = tables * scale[:, None, None]
    return tables


def compute_gradient(apply_loss, unflatten, forward_weights, batch, mask,
                     cfg: FedConfig, seed=None):
    """One client's mean gradient after ``finish_gradients`` (``seed``
    feeds its dropout and its DP noise), and its summed loss, metrics and
    datapoint count."""
    grad, loss_sum, metric_sums, n = mean_gradient(
        apply_loss, unflatten, forward_weights, batch, mask, seed)
    grad = finish_gradients(grad[None], forward_weights, cfg, [seed])[0]
    return grad, loss_sum, metric_sums, n


def client_step(apply_loss, unflatten, ps_weights, batch, mask, velocity,
                error, cfg: FedConfig, seeds=None,
                sketch: CountSketch = None) -> ClientStepOut:
    """The local step of the round's W non-fedavg clients: ``batch`` is a
    tuple of ``(W, B, ...)`` tensors, ``mask`` ``(W, B)``, ``velocity`` and
    ``error`` the clients' ``(W, d)`` rows or None, ``seeds`` the W
    clients' seeds for dropout and DP noise (None: none drawn). With a
    ``sketch`` (sketch mode under a per-worker nonlinearity) every client
    transmits its own (r, c_eff) table."""
    W = mask.shape[0]
    seeds = [None] * W if seeds is None else seeds
    outs = [mean_gradient(apply_loss, unflatten, ps_weights,
                          tuple(c[w] for c in batch), mask[w], seeds[w])
            for w in range(W)]
    g, loss_sum, metric_sums, n = (torch.stack(x) for x in zip(*outs))
    g = finish_gradients(g, ps_weights, cfg, seeds)
    if sketch is not None:
        g = sketch_and_clip(g, cfg, sketch)
    # sum-of-gradients semantics: scale each mean back up by its batch
    # size so the server can divide by the total datapoints
    g = g * n.view((W,) + (1,) * (g.dim() - 1))

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
    s)``, and its DP noise (under ``--dp`` worker) from that seed's
    ``NOISE_FOLD`` domain. Returns ``(transmit (d,), loss_sum,
    metric_sums, n)``, the loss and metrics averaged over the epochs."""
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
