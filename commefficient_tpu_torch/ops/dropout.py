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

``hw_dropout`` replaces the reference's hardware-RNG kernel ``_hw_kernel``
(``FusedDropout(impl="tpu_bits")``): ``where(bits >= thr, x *
f32(1/(1-rate)), 0)`` over the reference's ``(rows, 1024)`` view of x in
``(256, 1024)`` blocks, with ``thr = min(round(rate * 2**32), 2**32 - 1)``,
so P(keep) = 1 - rate to 2**-32. The TPU core's PRNG cannot be reproduced,
and the reference does not promise its realized bits, only their
distribution, exact scaling, equal forward and backward masks and seed
sensitivity. The bits here are the reference's own counter hash
(``ops/flash_attention.py::_hash_bits``) of each element's (row within its
block, lane) under the seed words ``(s0 + block * 0x9E3779B9 mod 2**32,
s1)``, the block's stream as ``_hw_kernel`` seeds it. They depend on the
logical block only, so the CUDA kernel (``csrc/hw_dropout.cu``, launch key
``hw_dropout``) and the plain version ``hw_dropout_plain`` draw the same
bits whatever the tiling. The backward is the same op on the cotangent
with the same seed words.

``FusedDropout(impl="tpu_bits")`` routes as the reference does: a shape
whose element count is no multiple of 1024 (``hw_dropout_supported``)
takes ``masked_dropout``, any other the kernel on a CUDA tensor. Where the
reference leaves the TPU it takes ``masked_dropout`` for every shape; the
port on the CPU takes ``hw_dropout_plain`` instead, so the CPU tests hold
the very bits the card draws.

A site whose tensor is one head shard of a larger one (tensor
parallelism, ``parallel/tp.py``) passes ``shard = (dim, offset, full)``:
its x is ``[offset, offset + n)`` of ``full`` along ``dim``, and it draws
the keep bits of the whole tensor and applies its slice, so every
element keeps the bit it has in the unsharded run (``sharded_dropout``;
under ``tpu_bits`` the whole tensor's bits come from one kernel launch
on a CUDA tensor).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from commefficient_tpu_torch.ops import cuda_lib

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF
#: the reference's kernel view: (rows, 1024) lanes in (256, 1024) blocks
HW_LANES = 1024
HW_BLOCK_ROWS = 256
_MIX_BLOCK = 0x9E3779B9          # the block index's seed multiplier
_HW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)
_SIGNATURES = {"hw_dropout_launch": [_P, _P, _LL, _I, _U, _U, _U, _F, _P]}


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


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors holding uint32 values (PyTorch
    on the CPU has no uint32 shifts): ``b`` in 16-bit halves, so no
    product reaches 2**49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def counter_hash(r: torch.Tensor, c: torch.Tensor, s0, s1) -> torch.Tensor:
    """The reference's ``_hash_bits``: uint32 bits of position (r, c)
    under the seed words (s0, s1), all int64 tensors (or ints) holding
    uint32 values and broadcast together."""
    x = (mul32(r, 2654435761) + mul32(c, 2246822519)) & _MASK32
    x = x ^ s0
    x = mul32(x ^ (x >> 16), 2246822507)
    x = x ^ s1
    x = mul32(x ^ (x >> 13), 3266489909)
    return x ^ (x >> 16)


def hw_threshold(rate: float) -> int:
    """keep = bits >= rate * 2**32: P(keep) = 1 - rate to 2**-32."""
    return min(int(round(float(rate) * 2.0 ** 32)), 2 ** 32 - 1)


def hw_dropout_supported(shape) -> bool:
    """The reference's rule: the element count folds into (rows, 1024)."""
    n = math.prod(int(s) for s in shape)
    return n >= HW_LANES and n % HW_LANES == 0


def _inv_keep(rate: float) -> float:
    """f32(1/(1-rate)), the quotient taken in double and rounded to
    nearest float32."""
    return struct.unpack("f", struct.pack("f", 1.0 / (1.0 - rate)))[0]


@functools.lru_cache(maxsize=64)
def hw_constants(rate: float):
    """``(hw_threshold(rate), _inv_keep(rate))``, computed once a rate:
    the kernel's call reads them on every launch."""
    return hw_threshold(rate), _inv_keep(rate)


def hw_bits(n: int, seeds, device="cpu") -> torch.Tensor:
    """The (n,) uint32 bits (in int64) of the flattened tensor: element i
    sits at row i // 1024, lane i % 1024 of the (rows, 1024) view, in
    block row // 256 at its row % 256."""
    s0, s1 = (int(s) & _MASK32 for s in seeds)
    i = torch.arange(n, dtype=torch.int64, device=device)
    row = i >> 10
    s0_b = (s0 + (row >> 8) * _MIX_BLOCK) & _MASK32
    return counter_hash(row & (HW_BLOCK_ROWS - 1), i & (HW_LANES - 1),
                        s0_b, s1)


def hw_dropout_plain(x: torch.Tensor, seeds, rate: float) -> torch.Tensor:
    """Plain version of the kernel: ``where(bits >= thr, f32(x) * f32(1/(1
    - rate)), 0)`` in x's dtype, the bits from ``hw_bits``."""
    keep = (hw_bits(x.numel(), seeds, x.device)
            >= hw_threshold(rate)).view(x.shape)
    scaled = x.float() * _inv_keep(rate)
    return torch.where(keep, scaled, 0.0).to(x.dtype)


@functools.cache
def _hw_entry():
    """The kernel's ctypes entry point, resolved at the first launch."""
    return cuda_lib.load("hw_dropout", _SIGNATURES).hw_dropout_launch


def _hw_kernel(x: torch.Tensor, seeds, rate: float) -> torch.Tensor:
    """One launch of ``csrc/hw_dropout.cu`` on a CUDA tensor. The host
    work is kept to what a call needs: the per-rate constants and the
    entry point are looked up once, the seed words pass as given (ctypes
    takes their low 32 bits), and a contiguous aligned x is not copied."""
    dtype = _HW_DTYPES.get(x.dtype)
    if dtype is None:
        raise ValueError(f"hw_dropout kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        # the kernel's 16- or 8-byte vector loads
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    threshold, inv_keep = hw_constants(rate)
    err = _hw_entry()(x.data_ptr(), out.data_ptr(), x.numel(), dtype,
                      seeds[0], seeds[1], threshold, inv_keep,
                      cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "hw_dropout")
    cuda_lib.LAUNCHES["hw_dropout"] += 1
    return out


def _hw_apply(x: torch.Tensor, seeds, rate: float) -> torch.Tensor:
    if x.is_cuda:
        return _hw_kernel(x, seeds, rate)
    if x.device.type == "cpu":
        return hw_dropout_plain(x, seeds, rate)
    raise ValueError(f"hw_dropout: unsupported device {x.device}")


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seeds, rate: float):
        ctx.seeds, ctx.rate = seeds, rate
        return _hw_apply(x, seeds, rate)

    @staticmethod
    def backward(ctx, g):
        # the same seed words -> the forward's mask on the cotangent
        return _hw_apply(g, ctx.seeds, ctx.rate), None, None


def hw_dropout(x: torch.Tensor, seeds, rate: float) -> torch.Tensor:
    """x * Bernoulli(1-rate)/(1-rate) with the counter-hash bits of the
    seed words ``seeds`` (the two ints of ``seed_words``); differentiable,
    the backward the same op with the same seeds. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"hw_dropout rate must be in [0, 1), got {rate}")
    if not hw_dropout_supported(x.shape):
        raise ValueError(f"hw_dropout needs an element count that is a "
                         f"multiple of {HW_LANES}, got {tuple(x.shape)}")
    return _HwDropout.apply(x, seeds, rate)


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


def sharded_dropout(x: torch.Tensor, seed: int, rate: float, impl: str,
                    shard) -> torch.Tensor:
    """``FusedDropout``'s result on ``x``, one slice of a larger tensor
    (``shard = (dim, offset, full)``): the whole tensor's keep bits,
    sliced, so each element is what the unsharded site gives it. The
    backward applies the same slice of the mask (autograd of the
    product)."""
    dim, offset, full = shard
    shape = list(x.shape)
    shape[dim] = full
    n = x.shape[dim]
    if impl == "tpu_bits" and hw_dropout_supported(shape):
        seeds = seed_words(seed)
        if x.is_cuda:
            # the kernel on ones: inv_keep where kept, 0 where dropped
            ones = torch.ones(shape, dtype=torch.float32, device=x.device)
            keep = _hw_kernel(ones, seeds, rate) != 0
        else:
            keep = (hw_bits(math.prod(shape), seeds, x.device)
                    >= hw_threshold(rate)).view(shape)
        keep = keep.narrow(dim, offset, n)
        return torch.where(keep, x.float() * _inv_keep(rate),
                           0.0).to(x.dtype)
    mask = _scaled_mask(seed, rate, shape, x.dtype, x.device)
    return x * mask.narrow(dim, offset, n)


class FusedDropout(torch.nn.Module):
    """Drop-in for the reference's ``FusedDropout(rate, impl)``:
    ``forward(x, seed, train)``. ``impl="xla_rbg"`` only chose the TPU's
    bit generator in the reference; here it is the same path as ``"xla"``.
    ``impl="tpu_bits"`` takes ``hw_dropout`` where
    ``hw_dropout_supported``, else ``masked_dropout``."""

    def __init__(self, rate: float, impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "xla_rbg", "tpu_bits"):
            raise ValueError(f"unknown dropout impl {impl!r}")
        self.rate = float(rate)
        self.impl = impl

    def forward(self, x, seed, train: bool, shard=None):
        """``shard``: ``(dim, offset, full)`` when ``x`` is a slice of the
        site's tensor (``sharded_dropout``)."""
        if self.rate == 0.0 or not train:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if seed is None:
            raise ValueError("dropout in training needs a seed")
        if shard is not None:
            return sharded_dropout(x, seed, self.rate, self.impl, shard)
        if self.impl == "tpu_bits" and hw_dropout_supported(x.shape):
            return hw_dropout(x, seed_words(seed), self.rate)
        return masked_dropout(x, seed, self.rate)
