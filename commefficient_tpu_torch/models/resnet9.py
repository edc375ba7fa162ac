"""ResNet-9 (port of ``commefficient_tpu/models/resnet9.py``).

Same architecture as the reference: prep ConvBN(c->64), layer1 (64->128)
+ pool2, residual, layer2 (128->256) + pool2, layer3 (256->512) + pool2,
residual, maxpool4, bias-free linear head and the 0.125 logit scale.
Convolutions are bias-free; with ``do_batchnorm`` each ConvBN has flax's
BatchNorm (momentum 0.9) between its conv and relu (``models/norms.py``;
the federated round refuses it, ``training/cv.py``). The public input is
NHWC, as in JAX; the forward pass permutes to NCHW for cuDNN.

``dtype="bfloat16"`` is the reference's compute dtype: the parameters
stay float32, x is cast at the entry, every convolution and the Dense
compute in bfloat16 with their kernels cast at use (flax's
``promote_dtype``), and the logits go back to float32 before the 0.125
scale. The casts are explicit, op by op, not ``torch.autocast``.

Submodules carry flax's auto-names (``ConvBN_0``, ``Residual_1``,
``Dense_0``, ``Conv_0``, ``BatchNorm_0``) so that parameter names map
onto the reference's flax params tree one to one (utils/params.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models.norms import BatchNorm, _Affine

DEFAULT_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's truncated-normal initializers rescale the standard deviation so
# that the normal truncated at +-2 std keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: Optional[torch.Generator]):
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def he_lecun_init_(module: nn.Module,
                   generator: Optional[torch.Generator] = None):
    """flax's initializers as the reference's CV models set them:
    he_normal convolutions, lecun_normal dense kernels (both flax variance
    scaling, truncated normal, fan-in; a grouped conv's fan-in is its
    group's), zero dense biases, norms at scale 1, bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            _variance_scaling_(m.weight, 2.0, m.weight[0].numel(), generator)
        elif isinstance(m, nn.Linear):
            _variance_scaling_(m.weight, 1.0, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, _Affine):
            m.reset_parameters()
    return module


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv`` with a compute dtype: input and kernel cast to it
    at use (the parameters stay float32), the output in it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class ConvBN(nn.Module):
    """3x3 bias-free conv, optional BatchNorm, relu, optional 2x2
    max-pool, in the compute dtype ``dtype``."""

    def __init__(self, c_in: int, c_out: int, pool: bool = False,
                 do_batchnorm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(c_in, c_out, 3, padding=1, bias=False,
                             dtype=dtype)
        self.BatchNorm_0 = (BatchNorm(c_out, momentum=0.9) if do_batchnorm
                            else nn.Identity())
        self.pool = pool
        self.compute_dtype = dtype

    def forward(self, x):
        x = self.Conv_0(x)
        if isinstance(self.BatchNorm_0, BatchNorm):
            # flax's BatchNorm normalizes in float32 and returns the
            # compute dtype
            x = self.BatchNorm_0(x.float()).to(self.compute_dtype)
        x = F.relu(x)
        return F.max_pool2d(x, 2) if self.pool else x


class Residual(nn.Module):
    """x + res2(res1(x)) (reference resnet9.py:68)."""

    def __init__(self, c: int, do_batchnorm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, c, do_batchnorm=do_batchnorm, dtype=dtype)
        self.ConvBN_1 = ConvBN(c, c, do_batchnorm=do_batchnorm, dtype=dtype)

    def forward(self, x):
        return x + self.ConvBN_1(self.ConvBN_0(x))


class ResNet9(nn.Module):
    def __init__(self, num_classes: int = 10, do_batchnorm: bool = False,
                 logit_weight: float = 0.125,
                 channels: Optional[dict] = None, in_channels: int = 3,
                 dtype: str = "float32"):
        super().__init__()
        ch = channels or DEFAULT_CHANNELS
        bn = do_batchnorm
        dt = self.compute_dtype = _DTYPES[dtype]
        self.logit_weight = logit_weight
        self.ConvBN_0 = ConvBN(in_channels, ch["prep"], do_batchnorm=bn,
                               dtype=dt)
        self.ConvBN_1 = ConvBN(ch["prep"], ch["layer1"], True, bn, dt)
        self.Residual_0 = Residual(ch["layer1"], bn, dt)
        self.ConvBN_2 = ConvBN(ch["layer1"], ch["layer2"], True, bn, dt)
        self.ConvBN_3 = ConvBN(ch["layer2"], ch["layer3"], True, bn, dt)
        self.Residual_1 = Residual(ch["layer3"], bn, dt)
        self.Dense_0 = nn.Linear(ch["layer3"], num_classes, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initializers: he_normal convs, lecun_normal
        head."""
        return he_lecun_init_(self, generator)

    def forward(self, x):
        """NHWC images -> float32 logits (B, num_classes)."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = self.ConvBN_0(x)
        x = self.ConvBN_1(x)
        x = self.Residual_0(x)
        x = self.ConvBN_2(x)
        x = self.ConvBN_3(x)
        x = self.Residual_1(x)
        x = F.max_pool2d(x, 4)
        # flatten in the reference's NHWC order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        logits = F.linear(x, self.Dense_0.weight.to(dt))
        return logits.to(torch.float32) * self.logit_weight
