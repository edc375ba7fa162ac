"""Tiny models for the tests (port of ``commefficient_tpu/models/toy.py``).

flax infers a dense layer's input size; here it is a parameter:
``in_features`` of ``ToyLinear``, and ``in_channels * image_size ** 2``
for ``TinyMLP``, which flattens its NHWC input in NHWC order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models.resnet9 import he_lecun_init_


class ToyLinear(nn.Module):
    """y = w . x, no bias, zero init: the unit-test model."""

    def __init__(self, features: int = 1, in_features: int = 1):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.zeros_(self.Dense_0.weight)
        return self

    def forward(self, x):
        return self.Dense_0(x)


class TinyMLP(nn.Module):
    """Small MLP classifier for fast end-to-end federated tests."""

    def __init__(self, num_classes: int = 10, hidden: int = 32,
                 in_channels: int = 3, image_size: int = 32):
        super().__init__()
        self.Dense_0 = nn.Linear(in_channels * image_size ** 2, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's default dense init: lecun_normal kernels, zero biases."""
        return he_lecun_init_(self, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))
