"""Exact magnitude top-k (port of ``commefficient_tpu/ops/topk.py``).

The rule is the reference's ``jax.lax.top_k`` over ``v*v``: the k largest
scores, equal scores taken in ascending index order, returned in
descending-score order. ``torch.topk`` promises no order for ties, so
this takes a stable descending sort. The server's sketch-mode recovery
does not come here: it runs the radix-select kernels of
``ops/topk_kernels.py``.
"""

from __future__ import annotations

import torch


def _select(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest ``vec*vec`` along the last axis."""
    _, order = torch.sort(vec * vec, dim=-1, descending=True, stable=True)
    return order[..., :k]


def topk(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Zero all but the k largest-magnitude entries (per row if 2-D)."""
    if vec.dim() not in (1, 2):
        raise ValueError(f"topk supports 1-D/2-D inputs, got {vec.dim()}-D")
    mask = torch.zeros(vec.shape, dtype=torch.bool, device=vec.device)
    mask.scatter_(-1, _select(vec, k), True)
    return torch.where(mask, vec, 0.0)


def topk_values_indices(vec: torch.Tensor, k: int):
    """(values, indices) of the k largest-magnitude entries, per row if 2-D,
    in ``lax.top_k`` order."""
    if vec.dim() not in (1, 2):
        raise ValueError("topk_values_indices supports 1-D/2-D inputs, "
                         f"got {vec.dim()}-D")
    idx = _select(vec, k)
    return torch.gather(vec, -1, idx), idx
