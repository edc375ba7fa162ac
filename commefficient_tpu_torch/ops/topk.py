"""Exact magnitude top-k (port of ``commefficient_tpu/ops/topk.py``).

The rule is the reference's ``jax.lax.top_k`` over ``v*v``: the k largest
scores, equal scores taken in ascending index order, returned in
descending-score order. Two routes give that set, as in the reference:

* the radix top-k of ``ops/topk_kernels.py`` (``topk_select``): the
  per-row histogram radix kernels on a CUDA tensor, their plain versions
  on a CPU one. It is the default (``use_kernel=None``);
* a stable descending sort (``use_kernel=False``): the reference's
  ``lax.top_k`` chain outside any kernel, which ``--server_fused off``
  pins. ``torch.topk`` promises no order for ties, so it is not used.

``row_k``: a 2-D call may pass a per-row valid count (<= k); each row
keeps the first ``row_k`` slots of its stable selection order.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops import topk_kernels


def _select(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest ``vec*vec`` along the last axis, in
    descending-score, ascending-index order."""
    _, order = torch.sort(vec * vec, dim=-1, descending=True, stable=True)
    return order[..., :k]


def _check_dim(vec: torch.Tensor, what: str):
    if vec.dim() not in (1, 2):
        raise ValueError(f"{what} supports 1-D/2-D inputs, got "
                         f"{vec.dim()}-D")


def topk(vec: torch.Tensor, k: int, row_k=None, use_kernel=None):
    """Zero all but the k largest-magnitude entries (per row if 2-D); with
    ``row_k``, all but each row's first ``row_k`` of them."""
    _check_dim(vec, "topk")
    kk = k if row_k is None else row_k
    if use_kernel is not False:
        return topk_kernels.topk_select(vec, kk, k)
    keep = torch.arange(k, device=vec.device) < torch.as_tensor(
        kk, device=vec.device)[..., None]
    mask = torch.zeros(vec.shape, dtype=torch.bool, device=vec.device)
    mask.scatter_(-1, _select(vec, k), keep.expand(vec.shape[:-1] + (k,)))
    return torch.where(mask, vec, 0.0)


def topk_values_indices(vec: torch.Tensor, k: int, use_kernel=None):
    """(values, indices) of the k largest-magnitude entries, per row if 2-D,
    in ``lax.top_k`` order."""
    _check_dim(vec, "topk_values_indices")
    if use_kernel is False:
        idx = _select(vec, k)
        return torch.gather(vec, -1, idx), idx
    if vec.dim() == 2:
        pairs = [topk_values_indices(row, k, use_kernel) for row in vec]
        return (torch.stack([v for v, _ in pairs]),
                torch.stack([i for _, i in pairs]))
    masked, mask = topk_kernels.topk_select(vec, k, k, with_mask=True)
    return topk_kernels.values_indices_from_mask(masked, mask, k)
