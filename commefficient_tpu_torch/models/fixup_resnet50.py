"""BN-free Fixup ResNet-50 (port of
``commefficient_tpu/models/fixup_resnet50.py``).

The bottleneck Fixup rules of the reference: scalar biases around every
conv (``bias1a`` .. ``bias3b``) and a scalar ``scale`` after the last
conv of each block; the first two convs ~ N(0, he_std *
num_layers ** -0.25), the third zero; the downsample conv reads the
bias1a-shifted input with a plain he std; a zero classifier. The stem is
a 7x7 stride-2 conv (padding 3), ``bias1``, relu, and a 3x3 stride-2
max-pool (padding 1); ``bias2`` before the head. ``layers`` stays a
parameter, so tests can build (1, 1, 1, 1). NHWC public input, NCHW
inside; flax's auto-names (``Conv_0``, ``FixupBottleneck_12``,
``Dense_0``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models.fixup_resnet9 import (FixupModule,
                                                          fixup_conv,
                                                          fixup_init_)


def _he_std(c_out: int, k: int) -> float:
    return math.sqrt(2.0 / (c_out * k * k))


class FixupBottleneck(FixupModule):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 num_layers: int = 16):
        super().__init__(bias1a=0.0, bias1b=0.0, bias2a=0.0, bias2b=0.0,
                         bias3a=0.0, bias3b=0.0, scale=1.0)
        out_ch = planes * self.expansion
        depth_scale = num_layers ** -0.25
        self.Conv_0 = fixup_conv(c_in, planes, 1,
                                 _he_std(planes, 1) * depth_scale)
        self.Conv_1 = fixup_conv(planes, planes, 3,
                                 _he_std(planes, 3) * depth_scale,
                                 stride=stride, padding=1)
        self.Conv_2 = fixup_conv(planes, out_ch, 1, 0.0)
        self.needs_proj = stride != 1 or c_in != out_ch
        if self.needs_proj:
            self.Conv_3 = fixup_conv(c_in, out_ch, 1, _he_std(out_ch, 1),
                                     stride=stride)

    def forward(self, x):
        out = F.relu(self.Conv_0(x + self.bias1a) + self.bias1b)
        out = F.relu(self.Conv_1(out + self.bias2a) + self.bias2b)
        out = self.Conv_2(out + self.bias3a) * self.scale + self.bias3b
        identity = self.Conv_3(x + self.bias1a) if self.needs_proj else x
        return F.relu(out + identity)


class FixupResNet50(FixupModule):
    def __init__(self, num_classes: int = 1000,
                 layers: tuple = (3, 4, 6, 3), in_channels: int = 3):
        super().__init__(bias1=0.0, bias2=0.0)
        num_layers = sum(layers)
        self.Conv_0 = fixup_conv(in_channels, 64, 7, _he_std(64, 7),
                                 stride=2, padding=3)
        self.blocks = []
        c_in, planes = 64, 64
        for stage, n in enumerate(layers):
            for i in range(n):
                name = f"FixupBottleneck_{len(self.blocks)}"
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, name, FixupBottleneck(c_in, planes, stride,
                                                    num_layers))
                self.blocks.append(name)
                c_in = planes * FixupBottleneck.expansion
            planes *= 2
        self.Dense_0 = nn.Linear(c_in, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        return fixup_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = F.relu(self.Conv_0(x.permute(0, 3, 1, 2)) + self.bias1)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean((2, 3)) + self.bias2)
