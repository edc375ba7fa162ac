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

* ``ring_attention`` — sequence-parallel attention over a ``seq``
  process group (``parallel/seq.py``): each rank holds a (B, T/S, H, D)
  block of q, k and v; k, v (and the key mask) travel the ring while
  each rank folds every visiting block into its online softmax, the
  reference's ``_fold_block`` and ``_finish`` at global positions.
  ``ring_attention_sharded`` is the same on global inputs.

The decode and ring forms are plain PyTorch, as the reference computes
them outside any Pallas kernel (its ring is einsums in ``_fold_block``).
Layout: q/k/v are (B, T, H, D); ``kv_mask`` (B, T) marks valid keys.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

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


def _finish(m, l, o, dtype):
    # fully masked queries (all-pad rows) have l == 0: emit 0, not NaN
    l = torch.clamp(l, min=1e-30)
    return (o / l.permute(0, 2, 1)[..., None]).to(dtype)


def _ring_send_recv(xs, group, step: int):
    """Each tensor of ``xs`` sent to the rank ``step`` ahead on the ring
    of ``group`` and replaced by the one from the rank ``step`` behind
    (one ``batch_isend_irecv``). Over gloo, whose sends read host memory
    (several ranks share one card over gloo), CUDA tensors cross through
    host copies."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    host = dist.get_backend(group) == "gloo"
    send = [x.contiguous().cpu() if host else x.contiguous() for x in xs]
    out = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
           for x in send]
    ops = []
    for x, o in zip(send, out):
        ops.append(dist.P2POp(dist.isend, x, dst, group))
        ops.append(dist.P2POp(dist.irecv, o, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(x.device) for o, x in zip(out, xs)]


class _RingShift(torch.autograd.Function):
    """One hop of the ring: forward sends each input to the next rank
    and receives the previous rank's; backward sends each cotangent the
    other way (the transpose of JAX's ``ppermute``)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_ring_send_recv(xs, group, 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_ring_send_recv(gs, ctx.group, -1))


def ring_attention(q, k, v, group=None, causal: bool = True,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence-parallel attention over the ranks of ``group`` (the seq
    axis; every rank calls it with its block). q/k/v are this rank's
    (B, T_loc, H, D) block of the sequence, ``kv_mask`` its (B, T_loc)
    keys. Rank s's queries sit at global positions ``s T_loc + t``; at
    step j it folds the block of rank ``(s - j) mod S`` (so causal
    masking is exact across blocks), then k, v and the mask move one hop
    (``_RingShift``; the reference's last hop, whose result nothing
    reads, is skipped). Returns this rank's (B, T_loc, H, D) output."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    B, T, H, D = q.shape
    dev = q.device
    q_pos = me * T + torch.arange(T, device=dev)
    acc = (torch.full((B, H, T), _NEG, device=dev),
           torch.zeros((B, H, T), device=dev),
           torch.zeros((B, T, H, D), device=dev))
    kb, vb = k, v
    kmb = None if kv_mask is None else kv_mask.bool()
    for step in range(n):
        src = (me - step) % n          # the ring owner of the visiting block
        k_pos = src * T + torch.arange(T, device=dev)
        acc = _fold_block(acc, q, kb, vb, q_pos, k_pos, kmb, causal)
        if step == n - 1:
            break
        kb, vb = _RingShift.apply(group, kb, vb)
        if kmb is not None:
            kmb = _ring_send_recv([kmb.to(torch.uint8)], group, 1)[0].bool()
    return _finish(*acc, q.dtype)


def ring_attention_sharded(q, k, v, group=None, causal: bool = True,
                           kv_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``ring_attention`` on global (B, T, H, D) inputs: each rank of
    ``group`` takes its block of T, and the blocks of the output are
    joined back into the global (B, T, H, D) on every rank."""
    group = group or dist.group.WORLD
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by seq axis "
                         f"size {n}")
    Tl = T // n
    sl = slice(me * Tl, (me + 1) * Tl)
    out = ring_attention(q[:, sl], k[:, sl], v[:, sl], group, causal,
                         None if kv_mask is None else kv_mask[:, sl])
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1)


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
    return _finish(*acc, q.dtype)
