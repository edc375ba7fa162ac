"""BN-free ResNet-9 with Fixup initialization (port of
``commefficient_tpu/models/fixup_resnet9.py``).

Same structure as the reference: a scalar bias before and after each
conv and a scalar ``scale`` after the last conv of each unit (flax
leaves of shape (1,), which ``utils.params.scalar_lr_multipliers``
trains at a reduced LR); convs ~ N(0, sqrt(2 / (c_out * k * k))), the
residual branch's first conv scaled by ``num_layers ** -0.5``, its second
conv zero, and a zero classifier. NHWC public input, NCHW inside;
submodules carry flax's auto-names (``Conv_0``, ``FixupLayer_1``,
``FixupBasicBlock_0``, ``Dense_0``).

``fixup_init_`` is the Fixup initializer of every model of the family
(``fixup_resnet18.py``, ``fixup_resnet50.py``): each conv made by
``fixup_conv`` carries its std (0 for a zero conv), dense layers start at
zero, and each module's ``scalar_init`` names its scalars' values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _fixup_std(c_out: int, k: int = 3) -> float:
    # the reference's fixup_resnet9.py:18: std = sqrt(2 / (out_ch * k * k))
    return math.sqrt(2.0 / (c_out * k * k))


def fixup_conv(c_in: int, c_out: int, k: int, std: float, stride: int = 1,
               padding: int = 0) -> nn.Conv2d:
    """A bias-free conv whose Fixup init is N(0, std) (zeros at std 0)."""
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding,
                     bias=False)
    conv.fixup_std = std
    return conv


class FixupModule(nn.Module):
    """A module with Fixup's scalar leaves: ``scalar_init`` maps each
    scalar's name to its initial value."""

    def __init__(self, **scalar_init: float):
        super().__init__()
        self.scalar_init = scalar_init
        for name, value in scalar_init.items():
            setattr(self, name, nn.Parameter(torch.full((1,), value)))


@torch.no_grad()
def fixup_init_(module: nn.Module,
                generator: Optional[torch.Generator] = None):
    """The reference's Fixup initializers over every submodule."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            if m.fixup_std:
                nn.init.normal_(m.weight, 0.0, m.fixup_std,
                                generator=generator)
            else:
                nn.init.zeros_(m.weight)
        elif isinstance(m, nn.Linear):
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)
        for name, value in getattr(m, "scalar_init", {}).items():
            getattr(m, name).fill_(value)
    return module


class FixupBasicBlock(FixupModule):
    """bias1a -> conv1 -> bias1b -> relu -> bias2a -> conv2 -> *scale ->
    bias2b, residual add, relu."""

    def __init__(self, c: int, num_layers: int):
        super().__init__(bias1a=0.0, bias1b=0.0, bias2a=0.0, bias2b=0.0,
                         scale=1.0)
        std = _fixup_std(c) * num_layers ** -0.5
        self.Conv_0 = fixup_conv(c, c, 3, std, padding=1)
        self.Conv_1 = fixup_conv(c, c, 3, 0.0, padding=1)

    def forward(self, x):
        out = F.relu(self.Conv_0(x + self.bias1a) + self.bias1b)
        out = self.Conv_1(out + self.bias2a) * self.scale + self.bias2b
        return F.relu(out + x)


class FixupLayer(FixupModule):
    """conv + bias/scale + relu + pool, then ``num_blocks``
    FixupBasicBlocks (reference fixup_resnet9.py:58-77)."""

    def __init__(self, c_in: int, c_out: int, num_blocks: int,
                 total_layers: int):
        super().__init__(bias1a=0.0, bias1b=0.0, scale=1.0)
        self.Conv_0 = fixup_conv(c_in, c_out, 3, _fixup_std(c_out),
                                 padding=1)
        for i in range(num_blocks):
            setattr(self, f"FixupBasicBlock_{i}",
                    FixupBasicBlock(c_out, total_layers))
        self.num_blocks = num_blocks

    def forward(self, x):
        out = F.max_pool2d(
            F.relu(self.Conv_0(x + self.bias1a) * self.scale + self.bias1b), 2)
        for i in range(self.num_blocks):
            out = getattr(self, f"FixupBasicBlock_{i}")(out)
        return out


class FixupResNet9(FixupModule):
    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__(bias1a=0.0, bias1b=0.0, scale=1.0, bias2=0.0)
        ch = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}
        num_layers = 2   # two residual blocks in all (reference :86)
        self.Conv_0 = fixup_conv(in_channels, ch["prep"], 3,
                                 _fixup_std(ch["prep"]), padding=1)
        self.FixupLayer_0 = FixupLayer(ch["prep"], ch["layer1"], 1,
                                       num_layers)
        self.FixupLayer_1 = FixupLayer(ch["layer1"], ch["layer2"], 0,
                                       num_layers)
        self.FixupLayer_2 = FixupLayer(ch["layer2"], ch["layer3"], 1,
                                       num_layers)
        self.Dense_0 = nn.Linear(ch["layer3"], num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        return fixup_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = x.permute(0, 3, 1, 2)
        out = F.relu(self.Conv_0(x + self.bias1a) * self.scale + self.bias1b)
        out = self.FixupLayer_0(out)
        out = self.FixupLayer_1(out)
        out = self.FixupLayer_2(out)
        out = F.max_pool2d(out, 4)
        # flatten in the reference's NHWC order
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
        return self.Dense_0(out + self.bias2)
