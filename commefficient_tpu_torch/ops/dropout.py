"""Recompute-in-backward dropout (port of ``commefficient_tpu/ops/dropout.py``).

``masked_dropout`` keeps the reference's contract and design: iid
Bernoulli keep with probability ``1 - rate`` and ``1/(1-rate)`` scaling,
and the only residual of the backward is the seed. The backward
regenerates the keep bits from it instead of reading a saved mask, so the
forward and backward masks are equal by construction.

Seeds are Python ints. The bits come from a ``torch.Generator`` seeded
with them on the tensor's device, so they are not JAX's bits: the two
packages agree in distribution, and the tests compare them at dropout 0
or through the attention kernel's counter hash (``ops/flash_attention``).
Each call site draws from its own seed, made by ``fold_in`` from the
round's, as flax folds the module path into the ``'dropout'`` rng.

``FusedDropout(impl="tpu_bits")`` needs the hardware-RNG kernel
``_hw_kernel``, which is not ported (ROADMAP.md B8).
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (the splitmix64
    finalizer over their mix): distinct call sites and clients draw
    distinct streams from one round seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def seed_words(seed: int):
    """Two int32 seed words from a seed (the kernels' per-call seeds, as
    ``_seeds_from_key`` folds a JAX key into two words)."""
    lo = int(seed) & 0xFFFFFFFF
    hi = ((int(seed) >> 32) & 0xFFFFFFFF) ^ 0x9E3779B9

    def i32(u):
        return u - (1 << 32) if u >= 1 << 31 else u

    return i32(lo), i32(hi)


def _scaled_mask(seed: int, rate: float, shape, dtype, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    keep = torch.rand(shape, generator=gen, device=device) < (1.0 - rate)
    return keep.to(dtype) / (1.0 - rate)


class _MaskedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate = seed, rate
        return x * _scaled_mask(seed, rate, x.shape, x.dtype, x.device)

    @staticmethod
    def backward(ctx, g):
        # same seed -> same bits -> the forward's mask, regenerated
        return (g * _scaled_mask(ctx.seed, ctx.rate, g.shape, g.dtype,
                                 g.device), None, None)


def masked_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """x * Bernoulli(1-rate)/(1-rate); the backward keeps only ``seed``."""
    return _MaskedDropout.apply(x, int(seed), float(rate))


class FusedDropout(torch.nn.Module):
    """Drop-in for the reference's ``FusedDropout(rate, impl)``:
    ``forward(x, seed, train)``. ``impl="xla_rbg"`` only chose the TPU's
    bit generator in the reference; here it is the same path as ``"xla"``."""

    def __init__(self, rate: float, impl: str = "xla"):
        super().__init__()
        if impl == "tpu_bits":
            raise NotImplementedError(
                "FusedDropout(impl='tpu_bits') needs the hardware-RNG "
                "dropout kernel _hw_kernel, not ported to PyTorch yet "
                "(ROADMAP.md B8)")
        if impl not in ("xla", "xla_rbg"):
            raise ValueError(f"unknown dropout impl {impl!r}")
        self.rate = float(rate)
        self.impl = impl

    def forward(self, x, seed, train: bool):
        if self.rate == 0.0 or not train:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if seed is None:
            raise ValueError("dropout in training needs a seed")
        return masked_dropout(x, seed, self.rate)
