"""Per-client state storage, dense codec (port of ``init_client_storage``,
``gather_rows`` and ``scatter_rows`` in
``commefficient_tpu/federated/client_store.py``; the sparse and sketched
codecs and host offload are ROADMAP.md A9).

The reference scatters with ``mode="drop"``: the slots of padded workers
and of a guarded round carry the out-of-bounds id ``num_clients`` and
write nothing. On CUDA, dropping them by a boolean filter would sync with
the host, and growing the rows by one for the scatter would copy the
whole ``(num_clients, d)`` array every round. So the storage keeps one
sink row, ``(num_clients + 1, d)``: the dropped slots write there, the
sink is never gathered (sampled ids are real clients), and the scatter
is an in-place ``index_put_`` with no host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.state import ClientState


def init_client_storage(cfg: FedConfig, flat_weights: torch.Tensor
                        ) -> ClientState:
    """Rows for every field the mode keeps, plus the sink row, on
    ``flat_weights``' device: zero velocities and errors, and
    ``--topk_down``'s stale weights at the initial weights (reference
    ``client_store.py:342``)."""
    shape = (cfg.num_clients + 1, cfg.grad_dim)
    device = flat_weights.device

    def rows(on: bool):
        return (torch.zeros(shape, dtype=torch.float32, device=device)
                if on else None)

    weights = (flat_weights.to(torch.float32).expand(shape).clone()
               if cfg.needs_client_weights else None)
    return ClientState(velocities=rows(cfg.needs_velocity_state),
                       errors=rows(cfg.needs_error_state), weights=weights)


def gather_rows(storage: Optional[torch.Tensor],
                ids: torch.Tensor) -> Optional[torch.Tensor]:
    """The sampled clients' rows, ``(W, d)`` (a copy)."""
    return None if storage is None else storage[ids]


def scatter_rows(storage: Optional[torch.Tensor], ids: torch.Tensor,
                 rows: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Write ``rows`` back at ``ids`` in place; an id of ``num_clients``
    (padded or guarded slot) lands in the sink row. Returns the storage."""
    if storage is None or rows is None:
        return storage
    storage.index_put_((ids,), rows)
    return storage
