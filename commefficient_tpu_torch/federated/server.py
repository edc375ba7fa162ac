"""The five server update rules (port of
``commefficient_tpu/federated/server.py``).

``server_update(gradient, state, cfg, lr, sketch, noise_seed) -> (weight
update (d,), new state)``. ``gradient`` is the round's aggregate: ``(d,)``
in every mode but sketch, where it is the ``(r, c_eff)`` table.

* fedavg: momentum only; the clients already applied the lr.
* uncompressed: momentum, then ``lr * v``; under ``--dp --dp_mode
  server`` ``lr * (v + noise_multiplier * N(0, 1))``, the noise from a
  ``torch.Generator`` seeded with the round's fresh ``noise_seed`` on the
  update's device (the reference's ``jax.random.normal``, matched in
  distribution).
* true_topk: momentum, virtual error, the exact top-k of the error, and
  both residuals masked on the update's support. ``server_fused`` auto
  runs the fused radix top-k (count kernels over err, the resid select
  epilogue); off runs the reference's incumbent chain, a stable sort.
* local_topk: momentum on the sum of the clients' top-ks, no masking.
* sketch: momentum and error in sketch space; auto runs the fused
  unsketch + top-k kernels, off the estimates kernel and a stable sort;
  then the k survivors are re-sketched to zero their footprint.

Rounding: ``g + rho*v`` runs eagerly here and rounds the product first,
while the reference's jitted XLA program contracts it into an FMA (one
rounding) on the CPU. The two differ by at most 1 ulp of ``rho*v`` plus 1
ulp of the result (ROADMAP.md C2); the tests hold the rest of each rule
bitwise at a momentum whose products are exact.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.state import ServerOptState
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.topk import topk
from commefficient_tpu_torch.ops.topk_kernels import fused_true_topk


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


def _fedavg(avg_update, state, cfg, lr):
    # lr is applied client-side during local SGD; the server applies
    # momentum only (the round passes lr = 1)
    v = _momentum(avg_update, state.Vvelocity, cfg.virtual_momentum)
    return v, ServerOptState(Vvelocity=v, Verror=state.Verror)


def _uncompressed(gradient, state, cfg, lr, noise_seed):
    v = _momentum(gradient, state.Vvelocity, cfg.virtual_momentum)
    update = v
    if cfg.do_dp and cfg.dp_mode == "server":
        if noise_seed is None:
            raise ValueError("server DP requires a fresh noise_seed per "
                             "round")
        gen = torch.Generator(device=update.device)
        gen.manual_seed(int(noise_seed))
        update = update + cfg.noise_multiplier * torch.randn(
            update.shape, generator=gen, device=update.device,
            dtype=update.dtype)
    return update * lr, ServerOptState(Vvelocity=v, Verror=state.Verror)


def _true_topk(gradient, state, cfg, lr):
    if cfg.server_fused != "off":
        update, v, err = fused_true_topk(gradient, state.Vvelocity,
                                         state.Verror, cfg.k,
                                         cfg.virtual_momentum)
        return update * lr, ServerOptState(Vvelocity=v, Verror=err)
    v = _momentum(gradient, state.Vvelocity, cfg.virtual_momentum)
    err = state.Verror + v
    update = topk(err, cfg.k, use_kernel=False)
    support = update != 0
    # error feedback + momentum factor masking on the global top-k support
    err = torch.where(support, 0.0, err)
    v = torch.where(support, 0.0, v)
    return update * lr, ServerOptState(Vvelocity=v, Verror=err)


def _local_topk(summed_local_topk, state, cfg, lr):
    # momentum on the already-sparse sum of the clients' top-ks; no
    # virtual error and no factor masking
    v = _momentum(summed_local_topk, state.Vvelocity, cfg.virtual_momentum)
    return v * lr, ServerOptState(Vvelocity=v, Verror=state.Verror)


def _sketched(sketched_grad, state, cfg, lr, sketch: CountSketch):
    v = _momentum(sketched_grad, state.Vvelocity, cfg.virtual_momentum)
    # 'virtual' accumulates; 'none' recovers straight from the momentum table
    err = state.Verror + v if cfg.error_type == "virtual" else v
    vals, idxs = sketch.unsketch_values_indices(
        err, cfg.k, fused=cfg.server_fused != "off")
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
                  cfg: FedConfig, lr, sketch: CountSketch = None,
                  noise_seed=None):
    """Dispatch to the mode's update rule; ``noise_seed`` seeds the
    uncompressed rule's server DP noise."""
    if cfg.mode == "fedavg":
        return _fedavg(gradient, state, cfg, lr)
    if cfg.mode == "uncompressed":
        return _uncompressed(gradient, state, cfg, lr, noise_seed)
    if cfg.mode == "true_topk":
        return _true_topk(gradient, state, cfg, lr)
    if cfg.mode == "local_topk":
        return _local_topk(gradient, state, cfg, lr)
    if cfg.mode == "sketch":
        if sketch is None:
            sketch = make_sketch(cfg)
        return _sketched(gradient, state, cfg, lr, sketch)
    raise ValueError(f"unknown mode {cfg.mode!r}")
