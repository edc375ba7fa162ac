"""Server optimizer state (port of ``ServerOptState`` in
``commefficient_tpu/federated/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ServerOptState:
    """Virtual momentum / error, shaped ``cfg.transmit_shape``: an
    ``(num_rows, sketch_cols)`` table in sketch mode."""
    Vvelocity: torch.Tensor
    Verror: torch.Tensor
