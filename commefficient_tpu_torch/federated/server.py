"""Server update, sketch mode (port of
``commefficient_tpu/federated/server.py``; the other four rules are
ROADMAP.md A4).

``server_update(table, state, cfg, lr, sketch) -> (weight update (d,),
new state)``: momentum and error accumulate in sketch space, the fused
unsketch + exact top-k kernels recover the k heaviest coordinates, and
the k survivors are re-sketched to zero their footprint in the momentum
and error tables.

Rounding: ``g + rho*v`` runs eagerly here and rounds the product first,
while the reference's jitted XLA program contracts it into an FMA (one
rounding) on the CPU. The two differ by at most 1 ulp of ``rho*v`` plus 1
ulp of the result; ``tests/test_torch_round.py`` pins that bound, and
holds the rest of the server step bitwise at a momentum whose products
are exact.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.state import ServerOptState
from commefficient_tpu_torch.ops.countsketch import CountSketch


def init_server_opt_state(cfg: FedConfig, device="cpu") -> ServerOptState:
    """Zero virtual momentum/error of the mode's shape."""
    shape = cfg.transmit_shape
    return ServerOptState(
        Vvelocity=torch.zeros(shape, dtype=torch.float32, device=device),
        Verror=torch.zeros(shape, dtype=torch.float32, device=device))


def make_sketch(cfg: FedConfig) -> CountSketch:
    """Sketch with hashes shared by clients and server (seed 42)."""
    return CountSketch(d=cfg.grad_dim, c=cfg.num_cols, r=cfg.num_rows,
                       seed=42, scheme=cfg.sketch_scheme)


def _momentum(gradient, velocity, rho):
    """v <- gradient + rho * v."""
    return gradient + rho * velocity


def _sketched(sketched_grad, state, cfg, lr, sketch: CountSketch):
    v = _momentum(sketched_grad, state.Vvelocity, cfg.virtual_momentum)
    # 'virtual' accumulates; 'none' recovers straight from the momentum table
    err = state.Verror + v if cfg.error_type == "virtual" else v
    vals, idxs = sketch.unsketch_values_indices(err, cfg.k)
    update = torch.zeros(cfg.grad_dim, dtype=torch.float32,
                         device=err.device)
    update[idxs] = vals
    # the update's footprint in sketch space, from its k nonzeros
    support = sketch.sketch_sparse(vals, idxs) != 0
    if cfg.error_type == "virtual":
        err = torch.where(support, 0.0, err)
    # momentum factor masking, approximated in sketch space
    v = torch.where(support, 0.0, v)
    return update * lr, ServerOptState(Vvelocity=v, Verror=err)


def server_update(gradient: torch.Tensor, state: ServerOptState,
                  cfg: FedConfig, lr, sketch: CountSketch = None):
    """Dispatch to the mode's update rule (sketch mode only here)."""
    if cfg.mode != "sketch":
        raise NotImplementedError(f"server rule {cfg.mode!r} is not ported "
                                  "to PyTorch yet (ROADMAP.md A4)")
    if sketch is None:
        sketch = make_sketch(cfg)
    return _sketched(gradient, state, cfg, lr, sketch)
