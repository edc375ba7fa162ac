"""Loss callables (port of ``make_cv_loss`` in
``commefficient_tpu/federated/losses.py``).

Contract: ``apply_loss(params, batch_tuple, train) -> (per-example loss
(B,), per-example metrics (M, B))``, where ``params`` is a ``{torch name:
tensor}`` dict for ``torch.func.functional_call``. The reference's rng
argument is dropped: no ported model draws random numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call


def make_cv_loss(model: torch.nn.Module):
    """Cross-entropy + top-1 correctness for image classifiers."""

    def apply_loss(params, batch, train):
        images, targets = batch
        logits = functional_call(model, params, (images,))
        targets = targets.long()
        loss = F.cross_entropy(logits, targets, reduction="none")
        correct = (torch.argmax(logits, -1) == targets).to(torch.float32)
        return loss, correct[None, :]

    return apply_loss
