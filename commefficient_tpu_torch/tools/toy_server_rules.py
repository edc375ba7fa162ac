"""Every server rule on the reference's toy problem, on the CPU: each mode
must drive w to 1.

    python -m commefficient_tpu_torch.tools.toy_server_rules

The model is y = w * x on x = [0, 1, 2, 3] with targets y = x and loss
(w x - y)^2, so the round's mean gradient is 7 (w - 1) in each
coordinate. w has D coordinates started apart (from -1 to 0), so the
top-k modes pick a different k each round. Each mode runs ``ROUNDS``
rounds of ``w -= update`` through ``federated.server.server_update``: the
uncompressed rule with momentum, true_topk and sketch (5 x 2,000, exact
recovery at this d) with virtual error, local_topk on the sum of the
clients' top-k (the transmit is the top-k of the gradient), and fedavg
on the clients' mean weight delta (``LR`` times the gradient, the server
at lr 1). Prints each mode's largest |w - 1| and exits 1 if one is above
``TOL``.
"""

from __future__ import annotations

import sys

import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.server import (init_server_opt_state,
                                                      make_sketch,
                                                      server_update)
from commefficient_tpu_torch.ops.topk import topk

D, K, LR, MOMENTUM, ROUNDS, TOL = 64, 32, 0.05, 0.5, 60, 1e-3

CONFIGS = {
    "uncompressed": dict(mode="uncompressed", error_type="none"),
    "true_topk": dict(mode="true_topk", error_type="virtual", k=K),
    "local_topk": dict(mode="local_topk", error_type="none", k=K),
    "sketch": dict(mode="sketch", error_type="virtual", k=K, num_rows=5,
                   num_cols=2_000),
    "fedavg": dict(mode="fedavg", error_type="none", local_batch_size=-1),
}


def mean_grad(w: torch.Tensor) -> torch.Tensor:
    return 7.0 * (w - 1.0)


def run(mode: str) -> torch.Tensor:
    """``w`` after ``ROUNDS`` rounds of ``mode``'s server rule."""
    cfg = FedConfig(virtual_momentum=MOMENTUM, local_momentum=0.0,
                    **CONFIGS[mode]).finalize(D)
    sketch = make_sketch(cfg) if mode == "sketch" else None
    state = init_server_opt_state(cfg)
    w = -torch.arange(D, dtype=torch.float32) / D
    for _ in range(ROUNDS):
        g = mean_grad(w)
        if mode == "sketch":
            g = sketch.sketch_vec(g)
        elif mode == "local_topk":
            g = topk(g, K)
        elif mode == "fedavg":
            g = LR * g
        update, state = server_update(g, state, cfg,
                                      1.0 if mode == "fedavg" else LR,
                                      sketch=sketch)
        w = w - update
    return w


def main() -> int:
    bad = []
    for mode in CONFIGS:
        err = float((run(mode) - 1.0).abs().max())
        print(f"{mode}: max |w - 1| = {err:.3e} after {ROUNDS} rounds "
              f"(d {D}, k {K}, lr {LR}, momentum {MOMENTUM})")
        if not err <= TOL:
            bad.append(mode)
    if bad:
        print(f"not converged: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
