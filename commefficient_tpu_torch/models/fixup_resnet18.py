"""Fixup ResNet-18 and a BatchNorm ResNet-18 for CIFAR (port of
``commefficient_tpu/models/fixup_resnet18.py``).

The reference's head quirk is kept: the last stage stays at 256 channels
and the classifier sees concat(avg pool, max pool) = 512 features. NHWC
public input, NCHW inside; flax's auto-names (``_Stem18_0``,
``FixupBlock_3``, ``_BNBlock_0``, ``Conv_0``, ``BatchNorm_1``,
``Dense_0``). ``ResNet18`` has BatchNorm, which the federated round
refuses (``training/cv.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models.fixup_resnet9 import (FixupModule,
                                                          _fixup_std,
                                                          fixup_conv,
                                                          fixup_init_)
from commefficient_tpu_torch.models.norms import BatchNorm
from commefficient_tpu_torch.models.resnet9 import he_lecun_init_


class FixupBlock(FixupModule):
    """A Fixup basic block with a 1x1 projection shortcut where the stride
    or the width changes (created first, so it is ``Conv_0``)."""

    def __init__(self, c_in: int, c_out: int, stride: int, num_layers: int):
        super().__init__(add1a=0.0, add1b=0.0, add2a=0.0, add2b=0.0,
                         mul=1.0)
        self.needs_proj = stride != 1 or c_in != c_out
        i = 0
        if self.needs_proj:
            self.Conv_0 = fixup_conv(c_in, c_out, 1, _fixup_std(c_out, 1),
                                     stride=stride)
            i = 1
        std = _fixup_std(c_out) * num_layers ** -0.5
        self.conv1 = f"Conv_{i}"
        self.conv2 = f"Conv_{i + 1}"
        setattr(self, self.conv1, fixup_conv(c_in, c_out, 3, std,
                                             stride=stride, padding=1))
        setattr(self, self.conv2, fixup_conv(c_out, c_out, 3, 0.0,
                                             padding=1))

    def forward(self, x):
        shortcut = self.Conv_0(x) if self.needs_proj else x
        out = F.relu(getattr(self, self.conv1)(x + self.add1a) + self.add1b)
        out = getattr(self, self.conv2)(out + self.add2a) * self.mul \
            + self.add2b
        return F.relu(out + shortcut)


class _Stem18(nn.Module):
    """3x3 prep conv + relu shared by both 18-layer CIFAR nets (Fixup's
    std, or he_normal under ``he_lecun_init_``)."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.Conv_0 = fixup_conv(in_channels, 64, 3, _fixup_std(64),
                                 padding=1)

    def forward(self, x):
        return F.relu(self.Conv_0(x))


def _dual_pool_head(x):
    """concat of the global avg and max pools over NCHW's spatial dims,
    in channel order (reference fixup_resnet18.py:55-59)."""
    return torch.cat([x.mean((2, 3)), x.amax((2, 3))], dim=1)


_STAGES = ((64, 1), (128, 2), (256, 2), (256, 2))


def _stage_blocks(num_blocks):
    """(c_in, c_out, stride) of every block in order."""
    c_in = 64
    for (c, stride), n in zip(_STAGES, num_blocks):
        for i in range(n):
            yield c_in, c, stride if i == 0 else 1
            c_in = c


class FixupResNet18(nn.Module):
    def __init__(self, num_classes: int = 10,
                 num_blocks: tuple = (2, 2, 2, 2), in_channels: int = 3):
        super().__init__()
        num_layers = sum(num_blocks)
        self._Stem18_0 = _Stem18(in_channels)
        self.blocks = [f"FixupBlock_{i}" for i in range(num_layers)]
        for name, (c_in, c, stride) in zip(self.blocks,
                                           _stage_blocks(num_blocks)):
            setattr(self, name, FixupBlock(c_in, c, stride, num_layers))
        self.Dense_0 = nn.Linear(2 * _STAGES[-1][0], num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        return fixup_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = self._Stem18_0(x.permute(0, 3, 1, 2))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(_dual_pool_head(x))


class _BNBlock(nn.Module):
    """conv-BN-relu twice, plus a 1x1 projection shortcut (``Conv_2``,
    created last) where the stride or the width changes."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1,
                                bias=False)
        self.BatchNorm_0 = BatchNorm(c_out)
        self.Conv_1 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False)
        self.BatchNorm_1 = BatchNorm(c_out)
        self.needs_proj = stride != 1 or c_in != c_out
        if self.needs_proj:
            self.Conv_2 = nn.Conv2d(c_in, c_out, 1, stride=stride,
                                    bias=False)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        return out + (self.Conv_2(x) if self.needs_proj else x)


class ResNet18(nn.Module):
    """The reference's CIFAR 'ResNet18' (post-activation blocks)."""

    def __init__(self, num_classes: int = 10,
                 num_blocks: tuple = (2, 2, 2, 2), in_channels: int = 3):
        super().__init__()
        self._Stem18_0 = _Stem18(in_channels)
        self.blocks = [f"_BNBlock_{i}" for i in range(sum(num_blocks))]
        for name, (c_in, c, stride) in zip(self.blocks,
                                           _stage_blocks(num_blocks)):
            setattr(self, name, _BNBlock(c_in, c, stride))
        self.Dense_0 = nn.Linear(2 * _STAGES[-1][0], num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """he_normal convs (the stem too), flax's default dense init."""
        return he_lecun_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = self._Stem18_0(x.permute(0, 3, 1, 2))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(_dual_pool_head(x))
