"""Client-side computation (port of ``commefficient_tpu/federated/client.py``).

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
order. Under ``--topk_down`` each client first reconstructs its forward
weights from its stale row and the top-k of the difference, the W rows
in one per-row radix top-k. ``--microbatch_size`` accumulates each
client's gradient over chunks of its batch.

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
from torch.utils._pytree import tree_flatten, tree_unflatten

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.ops.topk import topk

#: fold-in domain of the worker DP noise seed under a client's (or a
#: fedavg local step's) seed; the models' dropout sites fold in small
#: integers, so no site draws from it
NOISE_FOLD = 0xD9_0153
#: fold-in domain of the microbatch chunks' seeds under a client's seed
#: (the reference's ``fold_in(rng, 0x4d42)``): chunk i draws its dropout
#: from ``fold_in(fold_in(seed, MICROBATCH_FOLD), i)``
MICROBATCH_FOLD = 0x4D42


class ClientStepOut(NamedTuple):
    transmit: torch.Tensor             # (W, d) or (W, r, c_eff): sum of
                                       # gradients scaled
    velocity: Optional[torch.Tensor]   # (W, d) or None
    error: Optional[torch.Tensor]      # (W, d) or None
    client_weights: Optional[torch.Tensor]  # (W, d) new stale rows or None
    loss_sum: torch.Tensor             # (W,)
    metric_sums: torch.Tensor          # (W, M)
    num_datapoints: torch.Tensor       # (W,)


def _chunk_loss_and_grad(apply_loss, unflatten, w_flat, batch, mask, seed,
                         grad, accumulate):
    """Write (or, with ``accumulate``, add) the gradient of the summed
    loss over ``batch``'s valid examples into ``grad`` (flat
    coordinates), and return the summed loss and metrics.

    The gradient is taken with respect to one leaf per parameter (a
    detached view of ``w_flat``, the leaves of ``unflatten``'s tree) and
    each leaf's gradient goes once through the same view of ``grad``, as
    ``jax.grad`` through ``ravel_pytree`` joins it. Through the slice
    views of one flat ``w``, autograd would add a zero-filled (d,)
    gradient per leaf: a (d,) fill and add each, and every -0.0 of a
    leaf's gradient would come out +0.0. A leaf the loss does not reach
    gets zeros, as in JAX.

    On a model axis ``unflatten`` is a ``parallel.tp.TPUnflatten``: the
    leaves are this rank's compute shards, and its ``write_grads`` joins
    the ranks' shard gradients into ``grad`` (one all-gather over the
    model group), so every model rank holds the whole flat gradient."""
    views, spec = tree_flatten(unflatten(w_flat))
    leaves = [v.detach().requires_grad_(True) for v in views]
    per_ex_loss, per_ex_metrics = apply_loss(tree_unflatten(leaves, spec),
                                             batch, seed, True)
    loss_sum = torch.sum(per_ex_loss * mask)
    metric_sums = torch.sum(per_ex_metrics.detach() * mask[None, :], dim=-1)
    grads = torch.autograd.grad(loss_sum, leaves, materialize_grads=True)
    write_grads = getattr(unflatten, "write_grads", None)
    if write_grads is not None:
        write_grads(grad, tree_unflatten(list(grads), spec), accumulate)
        return loss_sum.detach(), metric_sums
    for view, g in zip(tree_flatten(unflatten(grad))[0], grads):
        if accumulate:
            view.add_(g)
        else:
            view.copy_(g)
    return loss_sum.detach(), metric_sums


def _masked_loss_and_grad(apply_loss, unflatten, w_flat, batch, mask,
                          seed=None, microbatch_size: int = -1):
    """Gradient of the summed loss over valid examples, in the flat
    weights' coordinates, plus the summed loss and metrics; ``seed`` feeds
    the model's dropout.

    ``microbatch_size`` in (0, B) splits the batch into ceil(B / mb)
    chunks, the last padded with rows of mask 0, and adds the chunks'
    gradients, losses and metric sums into zeros in chunk order, as the
    reference's scan does (so a -0.0 gradient comes out +0.0 there, as in
    the reference); chunk i draws its dropout from
    ``fold_in(fold_in(seed, MICROBATCH_FOLD), i)``, a domain apart from
    the DP noise's. Otherwise the batch is one chunk under ``seed``."""
    grad = torch.zeros_like(w_flat)
    B = mask.shape[0]
    if microbatch_size <= 0 or microbatch_size >= B:
        loss_sum, metric_sums = _chunk_loss_and_grad(
            apply_loss, unflatten, w_flat, batch, mask, seed, grad, False)
        return grad, loss_sum, metric_sums
    mb = microbatch_size
    n_chunks = -(-B // mb)
    pad = n_chunks * mb - B

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    batch = tuple(padded(c) for c in batch)
    mask = padded(mask)
    mb_seed = None if seed is None else fold_in(seed, MICROBATCH_FOLD)
    loss_sum = metric_sums = 0.0
    for i in range(n_chunks):
        sl = slice(i * mb, (i + 1) * mb)
        ls, ms = _chunk_loss_and_grad(
            apply_loss, unflatten, w_flat, tuple(c[sl] for c in batch),
            mask[sl], None if mb_seed is None else fold_in(mb_seed, i),
            grad, True)
        loss_sum = loss_sum + ls
        metric_sums = metric_sums + ms
    return grad, loss_sum, metric_sums


def mean_gradient(apply_loss, unflatten, forward_weights, batch, mask,
                  seed=None, microbatch_size: int = -1):
    """One client's mean gradient over its valid examples, and its summed
    loss, metrics and datapoint count."""
    n = torch.sum(mask)
    grad_sum, loss_sum, metric_sums = _masked_loss_and_grad(
        apply_loss, unflatten, forward_weights, batch, mask, seed,
        microbatch_size)
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
                     cfg: FedConfig, seeds,
                     trainable_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The (W, d) mean gradients after the reference's per-client steps
    before compression (``client.py:135-161``): the frozen coordinates of
    a ``trainable_mask`` zeroed, the raw-gradient clip in the dense
    modes, weight decay ``(wd / W) * w`` on the trainable coordinates
    (every worker adds it and the server sums), then under ``--dp`` the
    clip to ``l2_norm_clip`` and, in ``dp_mode`` worker, noise
    ``noise_multiplier * sqrt(W) * N(0, 1)`` from client w's ``seeds[w]``."""
    if trainable_mask is not None:
        grads = grads * trainable_mask
    if cfg.max_grad_norm is not None and cfg.mode != "sketch":
        grads = _clip_to_norm(grads, cfg.max_grad_norm)
    if cfg.weight_decay != 0:
        wd = (cfg.weight_decay / cfg.num_workers) * forward_weights
        if trainable_mask is not None:
            wd = wd * trainable_mask
        grads = grads + wd
    if cfg.do_dp:
        grads = _clip_to_norm(grads, cfg.l2_norm_clip)
        if cfg.dp_mode == "worker":
            grads = grads + (cfg.noise_multiplier
                             * math.sqrt(cfg.num_workers)) * _worker_noise(
                                 grads, seeds)
    return grads


def sketch_and_clip(grads: torch.Tensor, cfg: FedConfig,
                    sketch: CountSketch) -> torch.Tensor:
    """The W clients' (W, r, c_eff) sketches in one batched call, each
    scaled down to ``max_grad_norm`` where its ``l2estimate`` exceeds it
    (reference ``client.py:165-178``)."""
    tables = sketch.sketch_rows(grads)
    if cfg.max_grad_norm is not None:
        scale = _clip_scale(sketch.l2estimate(tables), cfg.max_grad_norm)
        tables = tables * scale[:, None, None]
    return tables


def compute_gradient(apply_loss, unflatten, forward_weights, batch, mask,
                     cfg: FedConfig, seed=None, trainable_mask=None):
    """One client's mean gradient after ``finish_gradients`` (``seed``
    feeds its dropout and its DP noise), and its summed loss, metrics and
    datapoint count."""
    grad, loss_sum, metric_sums, n = mean_gradient(
        apply_loss, unflatten, forward_weights, batch, mask, seed,
        cfg.microbatch_size)
    grad = finish_gradients(grad[None], forward_weights, cfg, [seed],
                            trainable_mask)[0]
    return grad, loss_sum, metric_sums, n


def reconstruct_worker_weights(ps_weights: torch.Tensor,
                               stale_weights: torch.Tensor,
                               cfg: FedConfig) -> torch.Tensor:
    """``--topk_down``: each client's stale weights plus the top-k of the
    server's weights less them (reference ``client.py:115-119``), the W
    ``(W, d)`` rows in one per-row top-k."""
    return stale_weights + topk(ps_weights - stale_weights, cfg.k)


def client_step(apply_loss, unflatten, ps_weights, batch, mask, velocity,
                error, cfg: FedConfig, seeds=None,
                sketch: CountSketch = None,
                stale_weights: Optional[torch.Tensor] = None,
                client_ks: Optional[torch.Tensor] = None,
                trainable_mask: Optional[torch.Tensor] = None
                ) -> ClientStepOut:
    """The local step of the round's W non-fedavg clients: ``batch`` is a
    tuple of ``(W, B, ...)`` tensors, ``mask`` ``(W, B)``, ``velocity``,
    ``error`` and (``--topk_down``) ``stale_weights`` the clients'
    ``(W, d)`` rows or None, ``seeds`` the W clients' seeds for dropout
    and DP noise (None: none drawn). With a ``sketch`` (sketch mode under
    a per-worker nonlinearity) every client transmits its own (r, c_eff)
    table. Under ``--topk_down`` client w computes at its reconstructed
    weights, which become its new stale row (``client_weights``).
    ``client_ks`` (``--client_k_dist``, a (W,) device tensor) are the
    clients' own budgets k_i <= k: each keeps the first k_i slots of its
    top-k selection in one per-row launch, and the coordinates past its
    budget stay in its error row. A ``trainable_mask`` zeroes the frozen
    coordinates of every gradient before compression."""
    W = mask.shape[0]
    seeds = [None] * W if seeds is None else seeds
    if cfg.do_topk_down:
        forward = reconstruct_worker_weights(ps_weights, stale_weights, cfg)
    else:
        forward = ps_weights.expand((W,) + tuple(ps_weights.shape))
    outs = [mean_gradient(apply_loss, unflatten, forward[w],
                          tuple(c[w] for c in batch), mask[w], seeds[w],
                          cfg.microbatch_size)
            for w in range(W)]
    g, loss_sum, metric_sums, n = (torch.stack(x) for x in zip(*outs))
    g = finish_gradients(g, forward, cfg, seeds, trainable_mask)
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
        to_transmit = topk(to_transmit, cfg.k, row_k=client_ks)
        support = to_transmit != 0
        if cfg.error_type == "local":
            error = torch.where(support, 0.0, error)       # error feedback
        if cfg.local_momentum > 0:
            velocity = torch.where(support, 0.0, velocity)  # factor masking
    return ClientStepOut(transmit=to_transmit, velocity=velocity,
                         error=error,
                         client_weights=forward if cfg.do_topk_down
                         else None, loss_sum=loss_sum,
                         metric_sums=metric_sums, num_datapoints=n)


def fedavg_client_step(apply_loss, unflatten, ps_weights, batch, mask, lr,
                       cfg: FedConfig, seed=None, trainable_mask=None):
    """FedAvg for one client: ``num_fedavg_epochs`` of local SGD over its
    whole (padded) data in chunks of ``fedavg_batch_size``, transmitting
    the weight delta scaled by its datapoint count. The lr decays per real
    local step: the exponent is ``epoch * n_real_chunks + chunk_idx``,
    padded ghost chunks (all-zero mask tails) not counted, as in the
    reference. Local step ``s`` draws its dropout from ``fold_in(seed,
    s)``, and its DP noise (under ``--dp`` worker) from that seed's
    ``NOISE_FOLD`` domain. ``lr`` is a float or a (d,) tensor of
    per-coordinate rates. Returns ``(transmit (d,), loss_sum,
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
            mask_p[sl], cfg, None if seed is None else fold_in(seed, step),
            trainable_mask)
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
