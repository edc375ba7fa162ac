"""ResNet-9 (port of ``commefficient_tpu/models/resnet9.py``).

Same architecture as the reference: prep ConvBN(c->64), layer1 (64->128)
+ pool2, residual, layer2 (128->256) + pool2, layer3 (256->512) + pool2,
residual, maxpool4, bias-free linear head and the 0.125 logit scale.
Convolutions are bias-free; BatchNorm is off (ROADMAP.md A6 for
``do_batchnorm``). The public input is NHWC, as in JAX; the forward pass
permutes to NCHW for cuDNN.

Submodules carry flax's auto-names (``ConvBN_0``, ``Residual_1``,
``Dense_0``, ``Conv_0``) so that parameter names map onto the reference's
flax params tree one to one (utils/params.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}

# flax's truncated-normal initializers rescale the standard deviation so
# that the normal truncated at +-2 std keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]):
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class ConvBN(nn.Module):
    """3x3 bias-free conv, relu, optional 2x2 max-pool."""

    def __init__(self, c_in: int, c_out: int, pool: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)
        self.pool = pool

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        return F.max_pool2d(x, 2) if self.pool else x


class Residual(nn.Module):
    """x + res2(res1(x)) (reference resnet9.py:68)."""

    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, c)
        self.ConvBN_1 = ConvBN(c, c)

    def forward(self, x):
        return x + self.ConvBN_1(self.ConvBN_0(x))


class ResNet9(nn.Module):
    def __init__(self, num_classes: int = 10, do_batchnorm: bool = False,
                 logit_weight: float = 0.125,
                 channels: Optional[dict] = None, in_channels: int = 3):
        super().__init__()
        if do_batchnorm:
            raise NotImplementedError(
                "ResNet9 BatchNorm is not ported to PyTorch yet "
                "(ROADMAP.md A6)")
        ch = channels or DEFAULT_CHANNELS
        self.logit_weight = logit_weight
        self.ConvBN_0 = ConvBN(in_channels, ch["prep"])
        self.ConvBN_1 = ConvBN(ch["prep"], ch["layer1"], pool=True)
        self.Residual_0 = Residual(ch["layer1"])
        self.ConvBN_2 = ConvBN(ch["layer1"], ch["layer2"], pool=True)
        self.ConvBN_3 = ConvBN(ch["layer2"], ch["layer3"], pool=True)
        self.Residual_1 = Residual(ch["layer3"])
        self.Dense_0 = nn.Linear(ch["layer3"], num_classes, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initializers: he_normal convs, lecun_normal
        head (flax variance scaling, truncated normal, fan-in)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                _variance_scaling_(m.weight, 2.0, fan_in, generator)
            elif isinstance(m, nn.Linear):
                _variance_scaling_(m.weight, 1.0, m.in_features, generator)
        return self

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        x = x.permute(0, 3, 1, 2)
        x = self.ConvBN_0(x)
        x = self.ConvBN_1(x)
        x = self.Residual_0(x)
        x = self.ConvBN_2(x)
        x = self.ConvBN_3(x)
        x = self.Residual_1(x)
        x = F.max_pool2d(x, 4)
        # flatten in the reference's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.Dense_0(x) * self.logit_weight
