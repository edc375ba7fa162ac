"""GPT-2 with double heads, LM + multiple-choice (port of
``commefficient_tpu/models/gpt2.py``, the training forward).

Same architecture and parameters as the reference: token and position
embeddings (token types index the token table), pre-LN blocks for
``arch="gpt2"`` and post-LN blocks without a final LayerNorm for
``arch="openai-gpt"``, the LM head tied to ``wte``, and a scalar
multiple-choice head read at each candidate's ``mc_token_ids`` position.
Inputs are (batch, num_candidates, seq_len); padded positions are attended
and masked in the loss only, as in the reference.

Submodules carry flax's auto-names (``Block_0.CausalSelfAttention_0.
Dense_0``, ``LayerNorm_0``, ``wte``, ``mc_head``) and the leaves flax's
names (``weight`` is flax's ``kernel``; ``embedding``, ``scale`` and
``bias`` as they are), so ``utils/params.py`` maps the reference's params
tree one to one.

Two traps carry over from flax: ``nn.gelu`` is the tanh approximation, and
the LayerNorm epsilon is 1e-5.

``attn_impl``: ``"full"`` materializes the (T, T) scores with dropout on
the probabilities; ``"blockwise"`` calls ``ops.attention.
blockwise_attention``, which on a CUDA tensor runs the flash kernels.
There ``attn_dropout`` places the attention dropout: ``"auto"`` drops the
probabilities inside the kernels when they are eligible and the output
otherwise, ``"output"`` always drops the output, ``"kernel"`` requires the
kernels and raises without them.

Dropout seeds: ``forward(..., train, seed)`` takes one int a call; each
dropout site draws from ``fold_in`` of it by its place in the model, as
flax folds the module path into the ``'dropout'`` rng. ``dropout_impl``
picks every ``FusedDropout`` site's bits: ``"xla"`` and ``"xla_rbg"`` a
seeded ``torch.Generator``; ``"tpu_bits"`` the hardware-RNG dropout kernel
(``ops/dropout.py::hw_dropout``) under the site's two seed words, for
every tensor whose size is a multiple of 1024.

``fused_lm_head``: the forward returns the final hidden states (B, C,
T, E) in place of the logits, and the loss applies the vocab-chunked
fused head (``ops/fused_ce.py``) with the tied ``wte``.

``remat``: in training each ``Block`` runs under
``torch.utils.checkpoint`` (non-reentrant), so its activations are
recomputed in the backward. The block's parameters are the checkpointed
function's inputs, so the recomputation reads the same tensors as the
forward under ``torch.func.functional_call``; the dropout sites draw
from seeds folded per site and the flash and hardware-RNG dropout
kernels from counter hashes, so the recomputed forward draws the same
masks and the gradient is bitwise the one without remat. Each flash
forward then launches twice a step.

KV-cached inference (the serving stack, ``serving/``): ``forward(...,
train=False, cache=..., position=..., logits_at=...)`` returns
``(lm_logits (B*C, V), mc_logits, new_cache)``, the LM logits only at
each row's ``logits_at`` (default its last token). The cache is a tuple of
per-layer dicts, written in place: dense ``{"k", "v"}`` of (B, S, H, hd)
from ``init_decode_cache``, or paged ``{"k", "v", "pt"}`` (pools of
(num_pages, page_size, H, hd) and a (B, M) page table, plus ``k_scale``
and ``v_scale`` when quantized, ``ops/kv_quant.py``). T > 1 prefills from
position 0 (k/v written at offset 0, causal attention within the window:
under ``blockwise`` on a CUDA tensor that is the flash forward); T == 1
decodes, writing each row at its own position clipped to the capacity;
``verify=True`` with T > 1 writes T tokens at ``position + arange(T)``,
dropping writes past the capacity (the paged form routes them to the
garbage page), and with ``logits_all`` returns (B*C, T, V) logits.

``moe_experts`` > 0: each block's MLP is the Switch MoE FFN
(``ops/moe.py``) under the submodule name ``moe``, with
``moe_capacity_factor``; ``forward(..., return_aux=True)`` also returns
the blocks' load-balancing term averaged over the layers, in the order
the reference's loss collects it (the block names sorted as strings). A
KV cache with MoE blocks raises the reference's ValueError.

Tensor parallelism (``parallel/tp.py``): with ``config.tp`` set
(``tp.attach``), each block's attention runs the rank's H/M heads (the
qkv product column-parallel, sliced by head; the out product
row-parallel, closed by one all-reduce before its bias) and its MLP the
rank's 4C/M hidden units (up column-parallel, down row-parallel, one
all-reduce); the backward all-reduces once at each column-parallel
input. A block takes either its shards (a training round's
``TPUnflatten``) or whole weights (serving), which it cuts. The flash
kernels draw each head's dropout bits by its global index
(``head_offset``), and the attention dropout sites that act on the
head-sharded probabilities or outputs draw the unsharded tensor's bits
and keep their heads' (``FusedDropout(..., shard=)``); every other site
acts on replicated activations and draws the same bits on every rank.
KV caches hold the rank's heads. An MoE block computes whole on every
model rank, on the replicated activation (its router too: the routing
is one process's bit for bit).

Expert parallelism (``parallel/ep.py``): with ``config.ep`` set
(``ep.attach``) each MoE block routes whole and computes the rank's
experts, its output summed over the expert group (``ops/moe.py``); every
other layer computes whole, replicated.

Sequence parallelism (``parallel/seq.py``): with ``attn_impl="ring"``
the model runs on a seq axis (``config.seq``, set by ``seq.attach``) and
takes a rank's block of T_loc columns: positions are global (``s T_loc +
t``), attention is ``ring_attention`` over the group followed by output
dropout, and the MC head reads the hidden state of the rank that owns
each global ``mc_token_ids`` position (zero elsewhere), drops it out
there and sums it over the group; its parameters' gradient counts on seq
rank 0 only (``seq.grad_once``). Outside a seq context, with a KV cache
or with ``fused_lm_head``, ring raises the reference's ValueErrors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from commefficient_tpu_torch.ops.attention import (
    blockwise_attention, decode_attention, full_attention,
    kernel_prob_dropout_eligible, paged_verify_attention, ring_attention)
from commefficient_tpu_torch.ops.dropout import FusedDropout, fold_in
from commefficient_tpu_torch.ops.moe import MoEFFN
from commefficient_tpu_torch.parallel import tp as tp_lib

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sub(seed: Optional[int], i: int) -> Optional[int]:
    return None if seed is None else fold_in(seed, i)


class GPT2Config:
    def __init__(self, vocab_size=50262, n_positions=512, n_embd=768,
                 n_layer=12, n_head=12, dropout=0.1, dtype="float32",
                 attn_impl="full", attn_block_size=512, remat=False,
                 arch="gpt2"):
        if arch not in ("gpt2", "openai-gpt"):
            raise ValueError(f"unknown arch {arch!r}")
        if attn_impl not in ("full", "blockwise", "ring"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.arch = arch
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.dropout = dropout
        self.dtype = dtype            # "float32" | "bfloat16" compute dtype
        self.attn_impl = attn_impl
        self.attn_block_size = attn_block_size
        self.remat = remat
        self.moe_experts = 0
        self.moe_capacity_factor = 1.25
        self.dropout_impl = "xla"     # "xla" | "xla_rbg" | "tpu_bits"
        self.attn_dropout = "auto"    # "auto" | "output" | "kernel"
        self.fused_lm_head = False
        self.tp = None                # a parallel.tp.TPContext, or None
        self.seq = None               # a parallel.seq.SeqContext, or None
        self.ep = None                # a parallel.ep.EPContext, or None

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def small(cls, vocab_size=50262):
        return cls(vocab_size=vocab_size)

    @classmethod
    def tiny(cls, vocab_size=300):
        """For tests and offline byte-tokenizer runs."""
        return cls(vocab_size=vocab_size, n_positions=256, n_embd=128,
                   n_layer=2, n_head=4, dropout=0.0)

    @classmethod
    def openai_gpt(cls, vocab_size=40478 + 5):
        """GPT-1 double heads: 12 post-LN layers, 512 positions."""
        return cls(vocab_size=vocab_size, n_positions=512, n_embd=768,
                   n_layer=12, n_head=12, arch="openai-gpt")


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in the compute dtype (the
    parameters stay float32)."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_in, n_out)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def column(self, x, tp, kind: str, local_out: int):
        """The column-parallel product: the rank's output columns (its
        piece of the weight and bias) of the replicated ``x``, whose
        gradient the backward all-reduces."""
        dt = self.compute_dtype
        w = tp_lib.local_piece(self.weight, kind, tp, local_out)
        b = tp_lib.local_piece(self.bias, kind, tp, local_out)
        return F.linear(tp_lib.copy_to_tp(x, tp).to(dt), w.to(dt), b.to(dt))

    def row(self, x, tp, local_in: int):
        """The row-parallel product: the rank's input rows of the weight
        against its piece of ``x``, summed over the model axis, then the
        (replicated) bias."""
        dt = self.compute_dtype
        w = tp_lib.local_piece(self.weight, "rows", tp, local_in)
        y = tp_lib.reduce_from_tp(F.linear(x.to(dt), w.to(dt)), tp)
        return y + self.bias.to(dt)


class Embed(nn.Module):
    """flax ``nn.Embed``: a (num, features) ``embedding`` table; ``attend``
    is the tied output head ``x @ embedding.T``."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, ids):
        return F.embedding(ids, self.embedding)

    def attend(self, x):
        return x @ self.embedding.T


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` with its arithmetic: statistics
    in float32, the variance as ``E[x^2] - E[x]^2`` clipped at 0 (flax's
    fast variance), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
    output in the compute dtype."""

    def __init__(self, n: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (x - mean) * (torch.rsqrt(var + 1e-5) * self.scale) + self.bias
        return y.to(self.compute_dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        C, dt = cfg.n_embd, cfg.torch_dtype
        if cfg.attn_dropout not in ("auto", "output", "kernel"):
            raise ValueError(f"unknown attn_dropout {cfg.attn_dropout!r}")
        self.config = cfg
        self.n_head = cfg.n_head
        self.rate = cfg.dropout
        self.attn_impl = cfg.attn_impl
        self.attn_block_size = cfg.attn_block_size
        self.attn_dropout = cfg.attn_dropout
        self.Dense_0 = Dense(C, 3 * C, dt)
        self.Dense_1 = Dense(C, C, dt)
        # the probabilities ('full'), or the output ('blockwise' off-kernel)
        self.attn_drop = FusedDropout(cfg.dropout, cfg.dropout_impl)
        self.resid_drop = FusedDropout(cfg.dropout, cfg.dropout_impl)

    def forward(self, x, train: bool, seed: Optional[int], cache=None,
                position=None, verify: bool = False):
        B, T, C = x.shape
        tp = getattr(self.config, "tp", None)
        H, hd = self.n_head, C // self.n_head
        # this rank's heads [h0, h0 + Hl) (all of them off a model axis)
        Hl = H if tp is None else H // tp.size
        h0 = 0 if tp is None else tp.rank * Hl
        Cl = Hl * hd
        if tp is None:
            qkv = self.Dense_0(x)
        else:
            qkv = self.Dense_0.column(x, tp, "qkv", 3 * Cl)
        q, k, v = torch.split(qkv, Cl, dim=-1)
        heads = lambda t: t.reshape(B, T, Hl, hd)
        q, k, v = heads(q), heads(k), heads(v)

        def out(y):
            y = y.reshape(B, T, Cl)
            return self.Dense_1(y) if tp is None else \
                self.Dense_1.row(y, tp, Cl)
        # a dropout site on the head-sharded (B, T, H, hd) output or (B,
        # H, T, T) probabilities draws the unsharded tensor's bits
        shard = (lambda dim: None) if tp is None else \
            (lambda dim: (dim, h0, H))
        if cache is not None:
            if self.attn_impl == "ring":
                raise ValueError("KV-cache decoding does not compose with "
                                 "attn_impl='ring' (no shard_map at serve "
                                 "time); serve with 'full' or 'blockwise'")
            y = self._cached(q, k, v, cache, position, verify)
            return self.resid_drop(out(y), _sub(seed, 1), train), cache
        if self.attn_impl == "ring":
            from commefficient_tpu_torch.parallel import seq as seq_lib
            y = ring_attention(q, k, v, seq_lib.context(self).group,
                               causal=True)
            y = self.attn_drop(y, _sub(seed, 0), train)
        elif self.attn_impl == "blockwise":
            rate = self.rate if train else 0.0
            in_kernel = (rate > 0.0 and self.attn_dropout != "output"
                         and kernel_prob_dropout_eligible(q, k, v))
            if self.attn_dropout == "kernel" and rate > 0.0 \
                    and not in_kernel:
                raise ValueError(
                    "attn_dropout='kernel' but the fused kernels are not "
                    "eligible for this device/shape; use 'auto' to fall "
                    "back to output dropout")
            if in_kernel:
                # dropout on the attention PROBABILITIES inside the kernels
                y = blockwise_attention(q, k, v, causal=True,
                                        block_size=self.attn_block_size,
                                        dropout_rate=rate,
                                        dropout_seed=_sub(seed, 0),
                                        head_offset=h0, num_heads=H)
            else:
                y = blockwise_attention(q, k, v, causal=True,
                                        block_size=self.attn_block_size)
                y = self.attn_drop(y, _sub(seed, 0), train, shard(2))
        else:
            att = (torch.einsum("bqhd,bkhd->bhqk", q, k)
                   / math.sqrt(C // self.n_head))
            causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                           device=x.device))
            att = att + torch.where(causal, 0.0,
                                    torch.finfo(att.dtype).min)[None, None]
            att = torch.softmax(att, dim=-1)
            att = self.attn_drop(att, _sub(seed, 0), train, shard(1))
            y = torch.einsum("bhqk,bkhd->bqhd", att, v)
        return self.resid_drop(out(y), _sub(seed, 1), train)

    def _cached(self, q, k, v, cache, position, verify):
        """Attention of the cached forms, writing k/v into ``cache`` in
        place (see the module docstring)."""
        B, T, H, hd = q.shape
        dev = q.device
        if "pt" in cache:
            if T != 1 and not verify:
                raise ValueError(
                    "paged KV cache decodes one token per step "
                    "(or a verify=True multi-token window); "
                    "prefill runs dense and is packed host-side")
            Pg = cache["k"].shape[1]
            M = cache["pt"].shape[1]
            b = torch.arange(B, device=dev)[:, None]
            p = position.long()[:, None] + torch.arange(T, device=dev)
            # writes past the capacity go to the garbage page (page 0),
            # not to a clipped position that would collide with a real one
            in_range = p < M * Pg
            pc = torch.clamp(p, max=M * Pg - 1)
            phys = torch.where(in_range, cache["pt"].long()[b, pc // Pg], 0)
            off = pc % Pg
            q_pos = torch.clamp(position.long(), max=M * Pg - 1)
            if "k_scale" in cache:
                from commefficient_tpu_torch.ops import kv_quant
                mode = kv_quant.infer_mode(cache["k"], hd)
                kv_quant.insert_tokens(cache["k"], cache["k_scale"], k,
                                       phys, off, mode)
                kv_quant.insert_tokens(cache["v"], cache["v_scale"], v,
                                       phys, off, mode)
                return paged_verify_attention(
                    q, cache["k"], cache["v"], cache["pt"], q_pos,
                    k_scale=cache["k_scale"], v_scale=cache["v_scale"])
            cache["k"][phys, off] = k.to(cache["k"].dtype)
            cache["v"][phys, off] = v.to(cache["v"].dtype)
            return paged_verify_attention(q, cache["k"], cache["v"],
                                          cache["pt"], q_pos)
        S = cache["k"].shape[1]
        if verify and T > 1:
            # T rows at each row's own positions; writes past the capacity
            # are dropped
            p = position.long()[:, None] + torch.arange(T, device=dev)
            keep = p < S
            b = torch.arange(B, device=dev)[:, None].expand(B, T)
            cache["k"][b[keep], p[keep]] = k[keep].to(cache["k"].dtype)
            cache["v"][b[keep], p[keep]] = v[keep].to(cache["v"].dtype)
            return decode_attention(q, cache["k"], cache["v"],
                                    torch.clamp(position.long(), max=S - 1))
        if T == 1:
            p = torch.clamp(position.long(), max=S - 1)
            b = torch.arange(B, device=dev)
            cache["k"][b, p] = k[:, 0].to(cache["k"].dtype)
            cache["v"][b, p] = v[:, 0].to(cache["v"].dtype)
            return decode_attention(q, cache["k"], cache["v"], p)
        if T > S:
            raise ValueError(f"prefill length {T} exceeds cache capacity {S}")
        cache["k"][:, :T] = k.to(cache["k"].dtype)
        cache["v"][:, :T] = v.to(cache["v"].dtype)
        if self.attn_impl == "blockwise":
            # the flash forward on a CUDA tensor, by the same rule as
            # training's dispatch
            return blockwise_attention(q, k, v, causal=True,
                                       block_size=self.attn_block_size)
        return full_attention(q, k, v, causal=True)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        C, dt = cfg.n_embd, cfg.torch_dtype
        self.config = cfg
        self.post_ln = cfg.arch == "openai-gpt"
        # LayerNorm_0 is the first one applied, LayerNorm_1 the second
        self.LayerNorm_0 = LayerNorm(C, dt)
        self.LayerNorm_1 = LayerNorm(C, dt)
        self.CausalSelfAttention_0 = CausalSelfAttention(cfg)
        if cfg.moe_experts > 0:
            self.moe = MoEFFN(C, cfg.moe_experts, 4 * C,
                              cfg.moe_capacity_factor, dt)
        else:
            self.Dense_0 = Dense(C, 4 * C, dt)
            self.Dense_1 = Dense(4 * C, C, dt)
        self.mlp_drop = FusedDropout(cfg.dropout, cfg.dropout_impl)

    def _mlp(self, h):
        """(MLP output, the MoE layer's aux or None)."""
        if hasattr(self, "moe"):
            return self.moe(h, getattr(self.config, "ep", None))
        tp = getattr(self.config, "tp", None)
        if tp is None:
            return self.Dense_1(F.gelu(self.Dense_0(h),
                                       approximate="tanh")), None
        units = 4 * h.shape[-1] // tp.size      # this rank's hidden units
        u = F.gelu(self.Dense_0.column(h, tp, "cols", units),
                   approximate="tanh")
        return self.Dense_1.row(u, tp, units), None

    def forward(self, x, train: bool, seed: Optional[int], cache=None,
                position=None, verify: bool = False):
        """``(output, aux)``: aux the MoE layer's load-balancing term, None
        for a dense block."""
        def attn(h):
            if cache is None:
                return self.CausalSelfAttention_0(h, train, _sub(seed, 0))
            return self.CausalSelfAttention_0(h, train, _sub(seed, 0),
                                              cache, position, verify)[0]

        drop = lambda t: self.mlp_drop(t, _sub(seed, 1), train)
        if self.post_ln:
            x = self.LayerNorm_0(x + attn(x))
            m, aux = self._mlp(x)
            return self.LayerNorm_1(x + drop(m)), aux
        x = x + attn(self.LayerNorm_0(x))
        m, aux = self._mlp(self.LayerNorm_1(x))
        return x + drop(m), aux


def _remat_block(block: Block, x, train: bool, seed: Optional[int],
                 params: Optional[dict] = None):
    """``block(x, train, seed)`` under non-reentrant activation
    checkpointing, with the block's current parameters (or ``params``,
    ``{local name: tensor}``) passed in as the checkpointed function's
    inputs (the recomputation in the backward runs after
    ``functional_call`` has put the module's own back)."""
    names, params = zip(*(params.items() if params is not None
                          else block.named_parameters()))

    def run(h, *ps):
        return functional_call(block, dict(zip(names, ps)), (h, train, seed))

    return checkpoint(run, x, *params, use_reentrant=False)


class GPT2DoubleHeads(nn.Module):
    """``forward(input_ids, token_type_ids, mc_token_ids, train, seed)`` ->
    ``(lm_logits (B, C, T, V) float32, mc_logits (B, C))``, or with
    ``config.fused_lm_head`` ``(hidden (B, C, T, E) float32, mc_logits)``;
    with ``return_aux`` a third entry, the MoE blocks' mean load-balancing
    term (0 for a dense model).
    """

    def __init__(self, config: GPT2Config):
        super().__init__()
        cfg = self.config = config
        self.wte = Embed(cfg.vocab_size, cfg.n_embd)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd)
        self.emb_drop = FusedDropout(cfg.dropout, cfg.dropout_impl)
        for i in range(cfg.n_layer):
            self.add_module(f"Block_{i}", Block(cfg))
        if cfg.arch == "gpt2":
            self.LayerNorm_0 = LayerNorm(cfg.n_embd)
        self.mc_drop = FusedDropout(cfg.dropout, cfg.dropout_impl)
        self.mc_head = Dense(cfg.n_embd, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The reference's initializers: normal(0.02) kernels, expert
        weights and token embeddings, normal(0.01) positions, zero biases,
        unit scales."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if name == "wpe.embedding":
                    p.normal_(0.0, 0.01, generator=generator)
                elif leaf in ("weight", "embedding", "moe_w1", "moe_w2"):
                    p.normal_(0.0, 0.02, generator=generator)
                elif leaf in ("bias", "moe_b1", "moe_b2"):
                    p.zero_()
                else:
                    p.fill_(1.0)
        return self

    def forward(self, input_ids, token_type_ids, mc_token_ids,
                train: bool = True, seed: Optional[int] = None, cache=None,
                position=None, logits_at=None, verify: bool = False,
                logits_all: bool = False, return_aux: bool = False):
        cfg = self.config
        ring = cfg.attn_impl == "ring"
        if cfg.fused_lm_head and ring:
            raise ValueError("fused_lm_head is not supported with "
                             "attn_impl='ring' (the seq-parallel losses "
                             "own their logits handling)")
        if cache is not None and train:
            raise ValueError("cache decoding is inference-only; "
                             "call with train=False")
        if cache is not None and cfg.moe_experts > 0:
            raise ValueError("KV-cache decoding does not support MoE "
                             "blocks yet (capacity routing at T=1)")
        B, C, T = input_ids.shape
        ids = input_ids.reshape(B * C, T).long()
        types = token_type_ids.reshape(B * C, T).long()
        pos = torch.arange(T, device=ids.device)[None, :]
        seq = None
        if ring and cache is None:
            from commefficient_tpu_torch.parallel import seq as seq_lib
            seq = seq_lib.context(self)
            # T is this rank's block: positions (and the MC pick) global
            pos = pos + seq.rank * T
        if cache is not None:
            pos = position.long()[:, None] + pos   # per-row decode offsets
            if verify:
                pos = torch.clamp(pos, max=cfg.n_positions - 1)
        x = self.wte(ids) + self.wpe(pos) + self.wte(types)
        x = self.emb_drop(x, _sub(seed, 0), train)
        remat = (cfg.remat and train and torch.is_grad_enabled()
                 and cache is None)
        auxes = {}
        for i in range(cfg.n_layer):
            block = getattr(self, f"Block_{i}")
            if cache is not None:
                x, aux = block(x, train, _sub(seed, 1 + i), cache[i],
                               position, verify)
            elif remat:
                x, aux = _remat_block(block, x, train, _sub(seed, 1 + i))
            else:
                x, aux = block(x, train, _sub(seed, 1 + i))
            if aux is not None:
                auxes[f"Block_{i}"] = aux
        x = x.float()
        if cfg.arch == "gpt2":
            x = self.LayerNorm_0(x)
        if cache is not None:
            # logits at the sampled positions only: (B*C, V), or (B*C, T,
            # V) for a verify window
            if logits_all:
                lm_out = self.wte.attend(x)
            else:
                idx = (torch.full((B * C,), T - 1, dtype=torch.long,
                                  device=x.device)
                       if logits_at is None else logits_at.long())
                lm_out = self.wte.attend(
                    x[torch.arange(B * C, device=x.device), idx])
        elif cfg.fused_lm_head:
            # the loss applies the fused head to these with the tied wte
            lm_out = x.reshape(B, C, T, cfg.n_embd)
        else:
            lm_out = self.wte.attend(x).reshape(B, C, T, cfg.vocab_size)
        mc_ids = mc_token_ids.reshape(B * C).long()
        rows = torch.arange(B * C, device=x.device)
        if seq is not None:
            # the rank that owns each global position contributes its
            # hidden state, dropped out there before the sum (a dropout
            # after it would draw another mask on every rank)
            off = seq.rank * T
            mine = (mc_ids >= off) & (mc_ids < off + T)
            val = x[rows, torch.clamp(mc_ids - off, 0, T - 1)]
            contrib = torch.where(mine[:, None], val, 0.0)
            contrib = self.mc_drop(contrib, _sub(seed, cfg.n_layer + 1),
                                   train)
            picked = seq_lib.reduce_from_seq(contrib, seq)
            head = self.mc_head
            mc_logits = F.linear(picked, seq_lib.grad_once(head.weight, seq),
                                 seq_lib.grad_once(head.bias, seq))
            mc_logits = mc_logits.reshape(B, C)
        else:
            picked = x[rows, mc_ids]
            picked = self.mc_drop(picked, _sub(seed, cfg.n_layer + 1),
                                  train)
            mc_logits = self.mc_head(picked).reshape(B, C)
        if cache is not None:
            return lm_out, mc_logits, cache
        if return_aux:
            # the reference sums the sown terms in its tree's key order
            aux = sum(auxes[k] for k in sorted(auxes)) / max(len(auxes), 1)
            return lm_out, mc_logits, aux
        return lm_out, mc_logits


def init_decode_cache(config: GPT2Config, batch_size: int, max_len: int,
                      device=None):
    """Zero KV cache for cached inference: one ``{"k", "v"}`` dict per
    layer, each (batch, max_len, n_head, head_dim) in the compute dtype
    (the rank's n_head / M heads on an M-way model axis). ``max_len``
    (prompt plus generated tokens) is bounded by the position table."""
    if max_len > config.n_positions:
        raise ValueError(f"cache capacity {max_len} exceeds n_positions "
                         f"{config.n_positions}")
    head_dim = config.n_embd // config.n_head
    shape = (batch_size, max_len, tp_lib.local_heads(config), head_dim)
    return tuple({"k": torch.zeros(shape, dtype=config.torch_dtype,
                                   device=device),
                  "v": torch.zeros(shape, dtype=config.torch_dtype,
                                   device=device)}
                 for _ in range(config.n_layer))
