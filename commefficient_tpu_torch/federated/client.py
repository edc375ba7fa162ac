"""Client-side computation (port of ``_masked_loss_and_grad`` and
``eval_step`` in ``commefficient_tpu/federated/client.py``; per-client
steps with local state, DP and microbatching are ROADMAP.md A5)."""

from __future__ import annotations

import torch


def _masked_loss_and_grad(apply_loss, unflatten, w_flat, batch, mask):
    """Gradient of the summed loss over valid examples, with respect to
    the flat weights, plus the summed loss and metrics."""
    w = w_flat.detach().requires_grad_(True)
    per_ex_loss, per_ex_metrics = apply_loss(unflatten(w), batch, True)
    loss_sum = torch.sum(per_ex_loss * mask)
    metric_sums = torch.sum(per_ex_metrics.detach() * mask[None, :], dim=-1)
    (grad,) = torch.autograd.grad(loss_sum, w)
    return grad, loss_sum.detach(), metric_sums


@torch.no_grad()
def eval_step(apply_loss, unflatten, weights, batch, mask):
    """Validation forward pass: (loss sum, metric sums, count)."""
    per_ex_loss, per_ex_metrics = apply_loss(unflatten(weights), batch,
                                             False)
    return (torch.sum(per_ex_loss * mask),
            torch.sum(per_ex_metrics * mask[None, :], dim=-1),
            torch.sum(mask))
