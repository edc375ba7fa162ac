"""flax's normalization layers on NCHW tensors, with flax's arithmetic
and leaf names, for the CV models.

All three compute their statistics as flax does: in float32, the
variance by flax's fast form ``E[x^2] - E[x]^2`` clipped at 0, and
normalize as ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. Their
parameters are flax's ``scale`` and ``bias``; BatchNorm's running
statistics are buffers named after flax's ``batch_stats`` leaves,
``mean`` and ``var``.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _normalize(x, mean, var, scale, bias, epsilon):
    """flax's ``_normalize`` over the channel dim 1 of x, with the
    statistics already broadcastable to x."""
    c = (1, -1, 1, 1)
    return ((x - mean) * (torch.rsqrt(var + epsilon) * scale.view(c))
            + bias.view(c))


def _fast_stats(x, dims):
    mean = x.mean(dims, keepdim=True)
    var = torch.clamp((x * x).mean(dims, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, var


class _Affine(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    @torch.no_grad()
    def reset_parameters(self):
        """flax's initializers: ``scale`` ones, ``bias`` zeros."""
        self.scale.fill_(1.0)
        self.bias.zero_()


class BatchNorm(_Affine):
    """flax ``nn.BatchNorm`` over the batch and spatial dims. Training
    mode (``module.train()``) normalizes by the batch's statistics and
    moves the running ones to ``momentum * running + (1 - momentum) *
    batch``, the batch variance biased (flax's, not ``nn.BatchNorm2d``'s
    unbiased one); eval mode normalizes by the running statistics.
    ``momentum`` is flax's (0.99 by default; torch's is ``1 - m``);
    epsilon 1e-5."""

    epsilon = 1e-5

    def __init__(self, c: int, momentum: float = 0.99):
        super().__init__(c)
        self.momentum = momentum
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    @torch.no_grad()
    def reset_parameters(self):
        super().reset_parameters()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x):
        c = (1, -1, 1, 1)
        if self.training:
            mean, var = _fast_stats(x, (0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.view(-1))
                self.var.copy_(m * self.var + (1 - m) * var.view(-1))
        else:
            mean, var = self.mean.view(c), self.var.view(c)
        return _normalize(x, mean, var, self.scale, self.bias, self.epsilon)


class LayerNorm(_Affine):
    """flax ``nn.LayerNorm()`` on NHWC, i.e. over the channels alone (the
    reference's conv LayerNorm, ``models/resnets.py:6-9``): dim 1 here,
    epsilon 1e-6."""

    epsilon = 1e-6

    def forward(self, x):
        mean, var = _fast_stats(x, (1,))
        return _normalize(x, mean, var, self.scale, self.bias, self.epsilon)


class GroupNorm(_Affine):
    """flax ``nn.GroupNorm(num_groups=32)``: statistics over the spatial
    dims and each group of contiguous channels, epsilon 1e-6."""

    epsilon = 1e-6
    num_groups = 32

    def __init__(self, c: int):
        super().__init__(c)
        if c % self.num_groups:
            raise ValueError(f"Number of groups ({self.num_groups}) does "
                             f"not divide the number of channels ({c}).")

    def forward(self, x):
        n, c, h, w = x.shape
        g, size = self.num_groups, c // self.num_groups
        mean, var = _fast_stats(x.reshape(n, g, size, h, w), (2, 3, 4))
        # each group's statistics repeated over its channels, as flax does
        mean, var = (t.expand(n, g, size, 1, 1).reshape(n, c, 1, 1)
                     for t in (mean, var))
        return _normalize(x, mean, var, self.scale, self.bias, self.epsilon)
