"""Per-page KV quantization codec of the block-paged serving cache (port of
``commefficient_tpu/ops/kv_quant.py``).

* ``int8`` — each (page, head) tile of ``page_size * head_dim`` values is
  scaled by ``amax / 127`` into int8: a quarter of the float32 pool's
  bytes, plus one float32 scale per (page, head).
* ``int4`` — ``amax / 7`` scaling, two values packed per byte along the
  head dim as offset-binary nibbles (value + 8, so unpacking is a
  subtraction); the head dim must be even.

Quantization happens when a page is written (the prompt pack of
``DecodeEngine.paged_insert``, the decode and verify frontier writes of
``models/gpt2.py``) and dequantization after the page gather of
``ops/attention.paged_verify_attention``, so no float array of a pool's
shape is ever made. A frontier write requantizes its page: dequantize,
write the token, recompute the scale, quantize. A multi-token window
inserts one position at a time, because consecutive tokens usually land
in the same page. An all-zero tile stores scale 0 and dequantizes to
exact zeros. A tile is one head's, so a tensor-parallel rank's pools
(its H/M heads, ``parallel/tp.py``) carry exactly their heads' scale
rows: the (num_pages, H/M) columns of the unsharded pool's.

Every function here is bitwise the reference's on the same inputs
(``round`` is half-to-even on both sides).
"""

from __future__ import annotations

import numpy as np
import torch

#: accepted --kv_quant modes ("none" keeps the float pools)
KV_QUANT_MODES = ("none", "int8", "int4")

_QMAX = {"int8": 127.0, "int4": 7.0}


def validate_mode(mode: str) -> str:
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES}, "
                         f"got {mode!r}")
    return mode


def pool_dtype(mode: str) -> torch.dtype:
    """Storage dtype of a quantized pool (int4 packs nibble pairs into
    uint8 along the head dim, halving that axis)."""
    validate_mode(mode)
    if mode == "int8":
        return torch.int8
    if mode == "int4":
        return torch.uint8
    raise ValueError("mode 'none' pools keep the model compute dtype")


def packed_head_dim(head_dim: int, mode: str) -> int:
    """The pool's last-axis size for ``mode``."""
    if mode == "int4":
        if head_dim % 2:
            raise ValueError(f"int4 packs value pairs along head_dim, "
                             f"which must be even; got {head_dim}")
        return head_dim // 2
    return head_dim


def infer_mode(pool: torch.Tensor, head_dim: int) -> str:
    """The codec mode of a pool, from its dtype and shape."""
    if pool.dtype == torch.int8:
        return "int8"
    if pool.dtype == torch.uint8 and pool.shape[-1] == head_dim // 2:
        return "int4"
    raise ValueError(f"cannot infer kv_quant mode from pool dtype "
                     f"{pool.dtype} shape {tuple(pool.shape)} (head_dim "
                     f"{head_dim})")


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., D) int32 in [-7, 7] -> (..., D/2) uint8 offset-binary pairs."""
    n = (q + 8).to(torch.uint8)
    return n[..., 0::2] | (n[..., 1::2] << 4)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2) uint8 -> (..., D) int32 in [-7, 7]."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))


def quantize_pages(x: torch.Tensor, mode: str):
    """Pages (..., page_size, H, head_dim) -> (quantized pages (...,
    page_size, H, head_dim[/2]), scales (..., H) float32). The scale is
    the amax over the (page_size, head_dim) tile over qmax."""
    qmax = _QMAX[mode]
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=(-3, -1))         # (..., H)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can differ from the quotient in the last bit
    scale = amax / torch.full_like(amax, qmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None, :, None]),
                    -qmax, qmax).to(torch.int32)
    if mode == "int4":
        return _pack_int4(q), scale
    return q.to(torch.int8), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Quantized pages and their (..., H) scales -> float32 pages (...,
    page_size, H, head_dim)."""
    if mode == "int4":
        q = _unpack_int4(q)
    return q.float() * scale[..., None, :, None]


def insert_tokens(qpool: torch.Tensor, scales: torch.Tensor,
                  vals: torch.Tensor, phys: torch.Tensor, off: torch.Tensor,
                  mode: str):
    """Requantize-on-write of per-row tokens into quantized pool pages, one
    window position at a time, in place: ``qpool`` (num_pages, page_size,
    H, Dq), ``scales`` (num_pages, H), ``vals`` (B, T, H, head_dim) the
    new tokens' k or v, ``phys``/``off`` (B, T) their pool pages and
    in-page offsets. Rows never share a real page within a position;
    rows routed to the garbage page may collide there, which nothing
    reads. Returns ``(qpool, scales)``."""
    B, T = phys.shape
    rows = torch.arange(B, device=qpool.device)
    phys = phys.long()
    off = off.long()
    for t in range(T):
        page = dequantize_pages(qpool[phys[:, t]], scales[phys[:, t]],
                                mode)                      # (B, P, H, D)
        page[rows, off[:, t]] = vals[:, t].float()
        qpage, nscale = quantize_pages(page, mode)
        qpool[phys[:, t]] = qpage
        scales[phys[:, t]] = nscale
    return qpool, scales


def pool_bytes(num_pages: int, page_size: int, n_head: int,
               head_dim: int, n_layer: int, mode: str,
               base_dtype=np.float32) -> int:
    """Total KV pool bytes (k and v, all layers), scale arrays included."""
    validate_mode(mode)
    per_layer_elems = num_pages * page_size * n_head * head_dim
    if mode == "none":
        itemsize = (torch.empty((), dtype=base_dtype).element_size()
                    if isinstance(base_dtype, torch.dtype)
                    else np.dtype(base_dtype).itemsize)
        return 2 * n_layer * per_layer_elems * itemsize
    elems = num_pages * page_size * n_head * packed_head_dim(head_dim, mode)
    scale_bytes = num_pages * n_head * 4
    return 2 * n_layer * (elems + scale_bytes)


def capacity_multiplier_vs_f32(num_pages: int, page_size: int,
                               n_head: int, head_dim: int, n_layer: int,
                               mode: str) -> float:
    """How many times the users fit in the same memory as float32 pools:
    the pool byte ratio (1.0 at 'none', about 3.97 at int8 and 7.8 at int4
    with 16 x 64 tiles)."""
    f32 = pool_bytes(num_pages, page_size, n_head, head_dim, n_layer,
                     "none", base_dtype=np.float32)
    got = pool_bytes(num_pages, page_size, n_head, head_dim, n_layer, mode)
    return f32 / got
