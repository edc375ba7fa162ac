"""High-level federated training API (port of ``FedLearner`` in
``commefficient_tpu/federated/api.py``; mesh, host offload, scanned
rounds and pipelines are ROADMAP.md A7/A9/A12).

    learner = FedLearner(model, cfg, loss_train, loss_val, device="cuda")
    metrics = learner.train_round(client_ids, batch, mask)   # one fed round
    metrics = learner.evaluate(batches)                      # centralized val

The model's current parameters are the initial weights; the learner
keeps them as one flat vector in the reference's coordinates
(utils/params.py) and runs the model functionally on views of it. Its
``state`` carries the server's momentum and error and, in the modes that
keep them, the clients' rows (``state.clients``).

Dropout: the learner owns a ``torch.Generator`` seeded with ``seed``
(the reference's round rng) and draws one seed from it per round.

Per-coordinate LR: ``lr_scale_vec``, a (d,) vector or a callable that
builds one from the model (``utils.params.scalar_lr_multipliers``, the
Fixup recipe), makes each round's lr ``lr * vec`` in float32, which the
server rules and fedavg's local steps multiply into the update as they
do a scalar lr.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.round import (FedState,
                                                     build_eval_step,
                                                     build_round_step,
                                                     init_fed_state)
from commefficient_tpu_torch.utils.device import resolve_device
from commefficient_tpu_torch.utils.params import flatten_params


class FedLearner:
    def __init__(self, model: torch.nn.Module, cfg: FedConfig,
                 loss_train: Callable, loss_val: Optional[Callable] = None,
                 lr_schedule: Optional[Callable] = None, device="cuda",
                 seed: int = 0, lr_scale_vec=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.model = model.to(self.device)
        flat, self.unflatten = flatten_params(self.model)
        self.cfg = cfg.finalize(flat.shape[0])
        self.state: FedState = init_fed_state(self.cfg, flat)
        self._round = build_round_step(loss_train, self.unflatten, self.cfg)
        self._eval = build_eval_step(loss_val or loss_train, self.unflatten)
        self.lr_schedule = lr_schedule or (lambda t: cfg.lr_scale)
        if callable(lr_scale_vec):
            lr_scale_vec = lr_scale_vec(self.model)
        if lr_scale_vec is not None:
            lr_scale_vec = torch.as_tensor(lr_scale_vec, dtype=torch.float32,
                                           device=self.device)
            if lr_scale_vec.shape != (self.cfg.grad_size,):
                raise ValueError(
                    f"lr_scale_vec must have shape ({self.cfg.grad_size},), "
                    f"got {tuple(lr_scale_vec.shape)}")
        self.lr_scale_vec = lr_scale_vec
        self.rounds_done = 0
        self.total_download_bytes = 0.0
        self.total_upload_bytes = 0.0

    def lr_at(self, t: float) -> float:
        return float(self.lr_schedule(t))

    def _to_device(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def train_round(self, client_ids, batch, mask, epoch_frac=None):
        """Run one federated round and return its host metrics."""
        lr = self.lr_at(self.rounds_done if epoch_frac is None
                        else epoch_frac)
        seed = int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.generator))
        # the reference's lr_in: float32(lr) times the vector, rounded once
        lr_in = lr if self.lr_scale_vec is None else lr * self.lr_scale_vec
        self.state, raw = self._round(
            self.state, self._to_device(client_ids, torch.int32),
            tuple(self._to_device(c) for c in batch),
            self._to_device(mask, torch.float32), lr_in, seed)
        self.rounds_done += 1
        n = max(float(raw["num_datapoints"]), 1.0)
        out = {
            "loss": float(raw["loss_sum"]) / n,
            "metrics": raw["metric_sums"].cpu().numpy() / n,
            "num_datapoints": n,
            "download_bytes": float(raw["download_bytes"]),
            "upload_bytes": float(raw["upload_bytes"]),
            "update_l2": float(raw["update_l2"]),
            "aborted": bool(raw["aborted"]),
            "lr": lr,
        }
        self.total_download_bytes += out["download_bytes"]
        self.total_upload_bytes += out["upload_bytes"]
        return out

    def evaluate(self, batches: Iterable):
        """Centralized validation over an iterable of (batch_tuple, mask)."""
        loss_sum, metric_sums, n_total, num_batches = 0.0, None, 0.0, 0
        for batch, mask in batches:
            num_batches += 1
            out = self._eval(self.state.weights,
                             tuple(self._to_device(c) for c in batch),
                             self._to_device(mask, torch.float32))
            loss_sum += float(out["loss_sum"])
            ms = out["metric_sums"].cpu().numpy()
            metric_sums = ms if metric_sums is None else metric_sums + ms
            n_total += float(out["num_datapoints"])
        n = max(n_total, 1.0)
        return {"loss": loss_sum / n,
                "metrics": (metric_sums if metric_sums is not None
                            else np.zeros(1)) / n,
                "num_datapoints": n, "num_batches": num_batches}
