"""Attention ops (port of ``full_attention``, ``blockwise_attention`` and
``kernel_prob_dropout_eligible`` from ``commefficient_tpu/ops/attention.py``).

* ``full_attention`` — plain O(T^2)-memory attention, the correctness
  reference.
* ``blockwise_attention`` — flash-style attention. A CUDA call that the
  fused kernels support (``ops/flash_attention.supported``: causal
  self-attention without a key mask) goes to them, with optional dropout
  on the attention probabilities inside the kernels; anything else runs
  the reference's online softmax over key/value blocks as a loop in plain
  PyTorch (no dropout there: it would need the (T, T) mask).

* ``decode_attention`` — the decode mode: a few query rows against a
  (B, S, H, D) key/value cache with per-row positions; scores are
  (B, H, Tq, S), never (B, H, S, S).
* ``paged_verify_attention`` / ``paged_decode_attention`` — the same
  against block-paged pools reached through a (B, M) page table, masked
  by logical position; the verify form takes Tq = speculate_k + 1
  queries, the decode form Tq = 1. Quantized pools (``ops/kv_quant.py``)
  are dequantized after the gather, never as a whole.

The decode forms are plain PyTorch, as the reference computes them
outside any Pallas kernel. Layout: q/k/v are (B, T, H, D); ``kv_mask``
(B, T) marks valid keys. Ring attention is ROADMAP.md A12.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from commefficient_tpu_torch.ops import flash_attention as _fa

_NEG = -1e30


def full_attention(q, k, v, *, causal: bool = True,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention with float32 scores; fully masked queries emit 0."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        qp = torch.arange(Tq, device=q.device)[:, None]
        kp = torch.arange(Tk, device=q.device)[None, :]
        s = s + torch.where(kp <= qp, 0.0, _NEG)[None, None]
    if kv_mask is not None:
        s = s + torch.where(kv_mask[:, None, None, :].bool(), 0.0, _NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    if causal and kv_mask is None and Tq == Tk:
        return out
    any_valid = torch.any(s > _NEG / 2, dim=-1)            # (B, H, Tq)
    return torch.where(any_valid.permute(0, 2, 1)[..., None], out, 0.0)


def decode_attention(q, k, v, q_pos, *,
                     kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q`` (B, Tq, H, D) with small Tq against the cache ``k``/``v`` (B,
    S, H, D); ``q_pos`` (B,) is each row's position of its first query.
    Key position kp is attended iff kp <= q_pos[b] + t, so slots above a
    row's position may hold anything. Every query sees at least its own
    position: no fully masked rows."""
    B, Tq, H, D = q.shape
    S = k.shape[1]
    dev = q.device
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    kp = torch.arange(S, device=dev)
    qp = q_pos.long()[:, None] + torch.arange(Tq, device=dev)[None, :]
    mask = kp[None, None, :] <= qp[:, :, None]             # (B, Tq, S)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, :].bool()
    s = s + torch.where(mask, 0.0, _NEG)[:, None]          # broadcast H
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def paged_verify_attention(q, k_pool, v_pool, page_table, q_pos, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``q`` (B, Tq, H, D) against the pools (num_pages, page_size, H, D)
    through ``page_table`` (B, M): row b's logical page m is pool page
    ``page_table[b, m]`` (page 0 is the never-attended garbage page). The
    mask is by logical position ``m * page_size + p <= q_pos[b] + t``, so
    unallocated pages and rejected speculative entries above a row's
    frontier are never attended. With ``k_scale``/``v_scale`` ((num_pages,
    H) float32) the pools are quantized and only the gathered (B, M, P,
    H, D) pages are dequantized."""
    B, Tq, H, D = q.shape
    P = k_pool.shape[1]
    M = page_table.shape[1]
    dev = q.device
    pt = page_table.long()
    k = k_pool[pt]                                         # (B, M, P, H, D)
    v = v_pool[pt]
    if k_scale is not None:
        from commefficient_tpu_torch.ops import kv_quant
        mode = kv_quant.infer_mode(k_pool, D)
        k = kv_quant.dequantize_pages(k, k_scale[pt], mode).to(q.dtype)
        v = kv_quant.dequantize_pages(v, v_scale[pt], mode).to(q.dtype)
    s = torch.einsum("bqhd,bmphd->bhqmp", q.float(),
                     k.float()) / math.sqrt(D)
    logical = (torch.arange(M, device=dev)[:, None] * P
               + torch.arange(P, device=dev)[None, :])     # (M, P)
    qp = q_pos.long()[:, None] + torch.arange(Tq, device=dev)[None, :]
    mask = logical[None, None] <= qp[:, :, None, None]     # (B, Tq, M, P)
    s = s + torch.where(mask, 0.0, _NEG)[:, None]          # broadcast H
    p = torch.softmax(s.reshape(B, H, Tq, M * P), dim=-1)
    p = p.reshape(B, H, Tq, M, P).to(q.dtype)
    return torch.einsum("bhqmp,bmphd->bqhd", p, v)


def paged_decode_attention(q, k_pool, v_pool, page_table, q_pos, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The Tq == 1 decode against the paged pools: the same math as
    ``paged_verify_attention``."""
    return paged_verify_attention(q, k_pool, v_pool, page_table, q_pos,
                                  k_scale=k_scale, v_scale=v_scale)


def _fold_block(acc, q, kb, vb, q_pos, k_pos, kv_mask_b, causal):
    """Fold one k/v block into the online-softmax accumulator
    ``(m (B,H,Tq), l (B,H,Tq), o (B,Tq,H,D))``, float32 statistics."""
    m, l, o = acc
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) / math.sqrt(D)
    if causal:
        s = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None], s,
                        _NEG)
    if kv_mask_b is not None:
        s = torch.where(kv_mask_b[:, None, None, :], s, _NEG)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    # explicit zero for masked entries (exp(s - m_new) would be 1 while
    # every score so far is _NEG); exponents clamped at 0
    p = torch.where(s <= _NEG / 2, 0.0,
                    torch.exp(torch.clamp(s - m_new[..., None], max=0.0)))
    corr = torch.exp(torch.clamp(m - m_new, max=0.0))
    l_new = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vb)
    o_new = o * corr.permute(0, 2, 1)[..., None] + pv.float()
    return m_new, l_new, o_new


def kernel_prob_dropout_eligible(q, k, v, *, causal: bool = True,
                                 kv_mask: Optional[torch.Tensor] = None
                                 ) -> bool:
    """True when ``blockwise_attention`` would dispatch the fused kernels
    (a CUDA call they support), i.e. when in-kernel attention-probability
    dropout is available."""
    return q.device.type == "cuda" and _fa.supported(q, k, v, causal,
                                                     kv_mask)


def blockwise_attention(q, k, v, *, causal: bool = True,
                        kv_mask: Optional[torch.Tensor] = None,
                        block_size: int = 512,
                        use_kernel: Optional[bool] = None,
                        dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        head_offset: int = 0,
                        num_heads: Optional[int] = None) -> torch.Tensor:
    """Flash-style attention. ``use_kernel`` forces the choice (None =
    the fused kernels when ``kernel_prob_dropout_eligible``); on a CPU
    tensor the kernel route runs the kernels' plain versions.
    ``block_size`` applies to the loop path only; ``block_q``/``block_k``
    set the kernels' logical dropout tiles. ``dropout_rate > 0`` needs the
    kernel route and a ``dropout_seed``. A head shard (tensor
    parallelism) passes ``head_offset`` and the unsharded ``num_heads``,
    so its heads draw the dropout bits of the unsharded call."""
    if use_kernel is None:
        use_kernel = kernel_prob_dropout_eligible(q, k, v, causal=causal,
                                                  kv_mask=kv_mask)
    if use_kernel:
        if not _fa.supported(q, k, v, causal, kv_mask):
            raise ValueError(
                "use_kernel=True but the call is not kernel-supported "
                "(needs causal self-attention without kv_mask)")
        kw = {}
        if block_q is not None:
            kw["block_q"] = block_q
        if block_k is not None:
            kw["block_k"] = block_k
        return _fa.flash_attention(q, k, v, causal=causal,
                                   dropout_rate=dropout_rate,
                                   dropout_seed=dropout_seed,
                                   head_offset=head_offset,
                                   num_heads=num_heads, **kw)
    if dropout_rate > 0.0:
        raise ValueError(
            "attention-probability dropout needs the fused kernel path "
            "(the loop formulation would materialize the (T, T) mask); "
            "use output dropout on this device/shape instead")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    bs = min(block_size, Tk)
    dev = q.device
    km = (torch.ones((B, Tk), dtype=torch.bool, device=dev)
          if kv_mask is None else kv_mask.bool())
    q_pos = torch.arange(Tq, device=dev)
    acc = (torch.full((B, H, Tq), _NEG, device=dev),
           torch.zeros((B, H, Tq), device=dev),
           torch.zeros((B, Tq, H, D), device=dev))
    for s0 in range(0, Tk, bs):
        # the reference pads the last block and masks the pad via kv_mask;
        # a shorter last block is the same arithmetic on the valid keys
        k_pos = torch.arange(s0, min(s0 + bs, Tk), device=dev)
        acc = _fold_block(acc, q, k[:, s0:s0 + bs], v[:, s0:s0 + bs],
                          q_pos, k_pos, km[:, s0:s0 + bs], causal)
    m, l, o = acc
    l = torch.clamp(l, min=1e-30)
    return (o / l.permute(0, 2, 1)[..., None]).to(q.dtype)
