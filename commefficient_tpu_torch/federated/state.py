"""Server optimizer and per-client state (port of ``ServerOptState`` and
``ClientState`` in ``commefficient_tpu/federated/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ServerOptState:
    """Virtual momentum / error, shaped ``cfg.transmit_shape``: an
    ``(num_rows, sketch_cols)`` table in sketch mode, ``(d,)`` otherwise."""
    Vvelocity: torch.Tensor
    Verror: torch.Tensor


@dataclass
class ClientState:
    """Per-client rows, indexed by client id, in the dense codec
    (``federated/client_store.py``): ``(num_clients + 1, d)`` each, the
    last row a sink for the writes of padded or guarded slots. A field is
    None when the mode keeps no such rows."""
    velocities: Optional[torch.Tensor] = None  # local momentum
    errors: Optional[torch.Tensor] = None      # local error feedback
    weights: Optional[torch.Tensor] = None     # --topk_down stale weights
