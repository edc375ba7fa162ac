"""torchvision-style ResNets with a choice of normalization (port of
``commefficient_tpu/models/resnets.py``).

``norm`` is ``batch`` (flax BatchNorm, which the federated round refuses,
``training/cv.py``), ``layer`` (flax LayerNorm over the channels alone, as
the reference's), ``group`` (32 groups of contiguous channels) or
``none``. ResNeXt's cardinality is the 3x3 conv's ``groups``; WideResNet
doubles ``width_per_group``. The input channels are a parameter (flax
infers them): 1 gives the reference's EMNIST stem. NHWC public input,
NCHW inside; flax's auto-names (``Conv_0``, ``_Norm_1``,
``LayerNorm_0``, ``Bottleneck_10``, ``Dense_0``); a ``none`` norm has no
leaves, as in flax.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models.norms import (BatchNorm, GroupNorm,
                                                  LayerNorm)
from commefficient_tpu_torch.models.resnet9 import he_lecun_init_

_NORMS = {"batch": BatchNorm, "layer": LayerNorm, "group": GroupNorm}


class _Norm(nn.Module):
    def __init__(self, kind: str, c: int):
        super().__init__()
        if kind not in (*_NORMS, "none"):
            raise ValueError(f"unknown norm {kind!r}")
        if kind != "none":
            setattr(self, f"{_NORMS[kind].__name__}_0", _NORMS[kind](c))

    def forward(self, x):
        for norm in self.children():
            x = norm(x)
        return x


def _conv(c_in, c_out, k, stride=1, padding=0, groups=1):
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding,
                     groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 norm: str = "batch"):
        super().__init__()
        self.Conv_0 = _conv(c_in, planes, 3, stride, 1)
        self._Norm_0 = _Norm(norm, planes)
        self.Conv_1 = _conv(planes, planes, 3, 1, 1)
        self._Norm_1 = _Norm(norm, planes)
        self.needs_proj = stride != 1 or c_in != planes
        if self.needs_proj:
            self.Conv_2 = _conv(c_in, planes, 1, stride)
            self._Norm_2 = _Norm(norm, planes)

    def forward(self, x):
        out = F.relu(self._Norm_0(self.Conv_0(x)))
        out = self._Norm_1(self.Conv_1(out))
        if self.needs_proj:
            x = self._Norm_2(self.Conv_2(x))
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 norm: str = "batch", groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out_ch = planes * self.expansion
        self.Conv_0 = _conv(c_in, width, 1)
        self._Norm_0 = _Norm(norm, width)
        self.Conv_1 = _conv(width, width, 3, stride, 1, groups)
        self._Norm_1 = _Norm(norm, width)
        self.Conv_2 = _conv(width, out_ch, 1)
        self._Norm_2 = _Norm(norm, out_ch)
        self.needs_proj = stride != 1 or c_in != out_ch
        if self.needs_proj:
            self.Conv_3 = _conv(c_in, out_ch, 1, stride)
            self._Norm_3 = _Norm(norm, out_ch)

    def forward(self, x):
        out = F.relu(self._Norm_0(self.Conv_0(x)))
        out = F.relu(self._Norm_1(self.Conv_1(out)))
        out = self._Norm_2(self.Conv_2(out))
        if self.needs_proj:
            x = self._Norm_3(self.Conv_3(x))
        return F.relu(out + x)


class ResNetTV(nn.Module):
    """ImageNet-style ResNet: 7x7/2 stem + maxpool + 4 stages + avgpool."""

    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, norm: str = "batch",
                 in_channels: int = 3):
        super().__init__()
        # a block's flax name is its class's, also under functools.partial
        kind = getattr(block, "func", block)
        self.Conv_0 = _conv(in_channels, 64, 7, 2, 3)
        self._Norm_0 = _Norm(norm, 64)
        self.blocks = []
        c_in, planes = 64, 64
        for stage, n in enumerate(layers):
            for i in range(n):
                name = f"{kind.__name__}_{len(self.blocks)}"
                stride = 2 if (stage > 0 and i == 0) else 1
                setattr(self, name, block(c_in, planes, stride, norm))
                self.blocks.append(name)
                c_in = planes * kind.expansion
            planes *= 2
        self.Dense_0 = nn.Linear(c_in, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """he_normal convs, flax's default dense init, norms at 1 and 0."""
        return he_lecun_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = F.relu(self._Norm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean((2, 3)))


def resnet18(**kw):
    return ResNetTV(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def resnet34(**kw):
    return ResNetTV(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def resnet50(**kw):
    return ResNetTV(block=Bottleneck, layers=(3, 4, 6, 3), **kw)


def resnet101(**kw):
    return ResNetTV(block=Bottleneck, layers=(3, 4, 23, 3), **kw)


def resnet152(**kw):
    return ResNetTV(block=Bottleneck, layers=(3, 8, 36, 3), **kw)


def resnext50_32x4d(**kw):
    return ResNetTV(block=partial(Bottleneck, groups=32, width_per_group=4),
                    layers=(3, 4, 6, 3), **kw)


def resnext101_32x8d(**kw):
    return ResNetTV(block=partial(Bottleneck, groups=32, width_per_group=8),
                    layers=(3, 4, 23, 3), **kw)


def wide_resnet50_2(**kw):
    return ResNetTV(block=partial(Bottleneck, width_per_group=128),
                    layers=(3, 4, 6, 3), **kw)


def wide_resnet101_2(**kw):
    return ResNetTV(block=partial(Bottleneck, width_per_group=128),
                    layers=(3, 4, 23, 3), **kw)


def ResNet101LN(**kw):
    """ResNet-101 with LayerNorm."""
    kw.setdefault("norm", "layer")
    return resnet101(**kw)


def ResNet50LN(**kw):
    kw.setdefault("norm", "layer")
    return resnet50(**kw)
