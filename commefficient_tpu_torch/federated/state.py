"""Server optimizer and per-client state, the buffered server's slots, and
the transmit's bucket plan (port of ``ServerOptState``, ``ClientState``,
``CLIENT_STATE_FIELDS``, ``BufferState``, ``GradBuckets`` and
``make_grad_buckets`` in ``commefficient_tpu/federated/state.py``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GradBuckets:
    """Plan slicing the flat ``(d,)`` gradient into K transmit buckets
    (``--grad_buckets``): contiguous coordinate ranges cut at parameter
    leaf boundaries and rounded to ``align`` (the tiled sketch's 128-lane
    block when the aggregate is sketched, 1 for dense transmits)."""
    offsets: Tuple[int, ...]  # ascending, offsets[0] == 0
    sizes: Tuple[int, ...]    # sum(sizes) == grad_dim

    def __post_init__(self):
        if len(self.offsets) != len(self.sizes) or not self.offsets:
            raise ValueError("offsets and sizes must be equal-length, "
                             "non-empty")
        if self.offsets[0] != 0:
            raise ValueError("first bucket must start at coordinate 0")
        for i in range(1, len(self.offsets)):
            if self.offsets[i] != self.offsets[i - 1] + self.sizes[i - 1]:
                raise ValueError("buckets must tile the flat vector "
                                 "contiguously")
        if any(s <= 0 for s in self.sizes):
            raise ValueError("every bucket must be non-empty")

    @property
    def num_buckets(self) -> int:
        return len(self.offsets)


def make_grad_buckets(param_sizes: Sequence[int], grad_dim: int,
                      num_buckets: int, align: int = 1
                      ) -> Optional[GradBuckets]:
    """The K-bucket plan of a model's flat gradient.

    ``param_sizes`` are the parameter leaf sizes in the flat vector's
    order (``utils.params.flatten_params``). Interior cuts go to the leaf
    boundaries nearest the K equal-size targets, rounded to a multiple of
    ``align``; cuts that collide after rounding are dropped, so a small
    model may get fewer than K buckets. Returns None when no interior cut
    survives: the round then runs its unbucketed code, so
    ``--grad_buckets 1`` is the round without buckets."""
    if num_buckets <= 1 or grad_dim <= align:
        return None
    boundaries = []
    acc = 0
    for s in param_sizes:
        acc += s
        boundaries.append(acc)
    cand = sorted({min(b, grad_dim) for b in boundaries
                   if 0 < b < grad_dim})
    if not cand:
        return None
    cuts = []
    for i in range(1, num_buckets):
        target = grad_dim * i // num_buckets
        nearest = min(cand, key=lambda b: abs(b - target))
        snapped = (nearest + align // 2) // align * align
        if 0 < snapped < grad_dim:
            cuts.append(snapped)
    cuts = sorted(set(cuts))
    if not cuts:
        return None
    offsets = (0, *cuts)
    sizes = tuple(b - a for a, b in zip(offsets, (*cuts, grad_dim)))
    return GradBuckets(offsets=offsets, sizes=sizes)


@dataclass
class ServerOptState:
    """Virtual momentum / error, shaped ``cfg.transmit_shape``: an
    ``(num_rows, sketch_cols)`` table in sketch mode, ``(d,)`` otherwise."""
    Vvelocity: torch.Tensor
    Verror: torch.Tensor


#: ClientState field names in writeback order: the list the offload
#: pipeline and the host arenas iterate over
CLIENT_STATE_FIELDS = ("velocities", "errors", "weights")


@dataclass
class ClientState:
    """Per-client rows, indexed by client id, each field in the
    ``--client_state`` codec's encoding (``federated/client_store.py``):
    a ``(num_clients + 1, d)`` tensor (dense), ``{"idx", "val"}`` of
    ``(num_clients + 1, k)`` (sparse) or ``{"table": (num_clients + 1, r,
    c)}`` (sketched); the last row is a sink for the writes of padded or
    guarded slots. Under ``--client_state_offload`` the state keeps no
    rows, and the round's rows arrive and leave as ``(W, ...)``
    encodings. A field is None when the mode keeps no such rows."""
    velocities: Optional[object] = None  # local momentum
    errors: Optional[object] = None      # local error feedback
    weights: Optional[object] = None     # --topk_down stale weights


@dataclass
class BufferState:
    """The buffered server's contribution slots (``server_mode
    buffered``; reference ``state.py:145-175``). A cohort emits one with
    W slots, and the deposit copies its arrived slots into the server's
    M-slot buffer in arrival order. The clients' rows ride in the slots
    dense, so they land in client state only when their contribution is
    applied."""
    transmit: torch.Tensor         # (M, *transmit_shape)
    loss_sum: torch.Tensor         # (M,)
    metric_sums: torch.Tensor      # (M, n_metrics)
    num_datapoints: torch.Tensor   # (M,)
    download_floats: torch.Tensor  # (M,) f32: weights pulled at start
    cid: torch.Tensor              # (M,) int64 client id (num_clients = none)
    start_version: torch.Tensor    # (M,) int32 weights_version pulled
    valid: torch.Tensor            # (M,) bool: slot holds a contribution
    count: torch.Tensor            # () int32: filled slots
    velocities: Optional[torch.Tensor] = None  # (M, d) rows at finish
    errors: Optional[torch.Tensor] = None      # (M, d)
    weights: Optional[torch.Tensor] = None     # (M, d) topk_down stale
