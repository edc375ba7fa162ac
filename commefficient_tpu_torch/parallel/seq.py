"""Sequence parallelism for GPT2 over a ``seq`` process group (port of
``commefficient_tpu/parallel/seq.py``).

The reference runs a ring-attention GPT2 inside ``shard_map`` with the
sequence sharded over the mesh's ``seq`` axis. Here each rank of a
``seq`` group holds a block of T / S columns of every sequence, the model
reads the group from ``config.seq`` (``attach``, as ``parallel/tp.py``
sets ``config.tp``), and the collectives are written out:

* attention keys and values travel the ring (``ops/attention.
  ring_attention``; its hop is an autograd Function whose backward sends
  the cotangent back), positions are global (``s T_loc + t``);
* the multiple-choice head takes the hidden state of the rank that owns
  each candidate's ``mc_token_ids`` (global positions), zero elsewhere,
  drops it out there and sums it over the group (``reduce_from_seq``);
* the losses sum each dialog's token NLL and token count over the group.

The gradient: every seq rank computes the same loss from the group's
sums, and each rank backpropagates it through its own block. The sums
are all-reduces whose backward is the identity (``reduce_from_seq``):
rank s's block gets d loss / d (its part), which every rank holds after
the forward. So each rank's parameter gradient is its block's share, and
the shares summed over the seq group (the round's reduce spans both
axes) are the unsharded gradient. The one parameter used after a sum,
the MC head, would be counted on every rank: ``grad_once`` keeps its
gradient on seq rank 0 and gives zeros elsewhere.

Dropout: ``shard_seed`` folds a rank's (clients, seq) position into the
round's seed (the reference's ``_shard_rngs``), so the masks of the
blocks are independent draws, the unsharded model's distribution but not
its bits (ROADMAP.md C6).

``SeqCut`` cuts a rank's columns out of a batch: the worker block is the
``clients`` axis's (``mesh.worker_block``), the sequence block
``[s T/S, (s+1) T/S)`` of every column with a sequence dimension (the
losses' ``seq_columns``). The labels are cut like the ids: a loss shifts
them by a one-column halo from the next rank (``shift_labels_halo``),
which gives each rank the columns of the labels shifted at global shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from commefficient_tpu_torch.ops.attention import _ring_send_recv
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.parallel import mesh as mesh_lib
from commefficient_tpu_torch.parallel.tp import _ReduceFromTP

AXIS = "seq"
#: the GPT2 batch columns with a sequence dimension: input ids, LM
#: labels, token types (``(ids, mc_ids, labels, mc_labels, types)``)
GPT2_SEQ_COLUMNS = (0, 2, 4)


@dataclass(frozen=True)
class SeqContext:
    """A rank's place on the seq axis: its group, rank and size."""
    group: object
    rank: int
    size: int

    @classmethod
    def from_mesh(cls, mesh) -> Optional["SeqContext"]:
        """The ``seq`` axis of ``mesh`` (None without one above 1)."""
        if mesh_lib.seq_size(mesh) == 1:
            return None
        return cls(mesh_lib.seq_group(mesh), mesh_lib.seq_rank(mesh),
                   mesh_lib.seq_size(mesh))


def attach(model: torch.nn.Module, ctx: Optional[SeqContext]) -> None:
    """Run ``model`` (a ring-attention ``GPT2DoubleHeads``) on ``ctx``'s
    seq axis (None: detached)."""
    cfg = model.config
    if ctx is not None and cfg.attn_impl != "ring":
        raise ValueError("a seq axis needs attn_impl='ring' (got "
                         f"{cfg.attn_impl!r})")
    cfg.seq = ctx


def context(model) -> SeqContext:
    ctx = getattr(model.config, "seq", None)
    if ctx is None:
        raise ValueError("attn_impl='ring' runs on a seq mesh axis: build "
                         "the learner on a --mesh ...,seq=N>1 mesh (or "
                         "parallel.seq.attach the model to one)")
    return ctx


def reduce_from_seq(x: torch.Tensor, ctx: SeqContext) -> torch.Tensor:
    """The sum of ``x`` over the seq group; identity backward."""
    return _ReduceFromTP.apply(x, ctx.group)


def sum_over_seq(x: torch.Tensor, ctx: SeqContext) -> torch.Tensor:
    """The sum of ``x`` over the seq group, outside autograd (counts)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=ctx.group)
    return out


class _GradOnce(torch.autograd.Function):
    """Identity forward; backward keeps the gradient on seq rank 0 and
    gives zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def grad_once(t: torch.Tensor, ctx: SeqContext) -> torch.Tensor:
    """``t`` whose gradient counts once over the seq group: a parameter
    read by work that every seq rank repeats after a sum."""
    return _GradOnce.apply(t, ctx.rank == 0)


def shard_seed(seed: Optional[int], mesh) -> Optional[int]:
    """The round's dropout seed folded with this rank's (clients, seq)
    position ``c * S + s`` (the reference's ``_shard_rngs``)."""
    if seed is None:
        return None
    idx = (mesh_lib.clients_rank(mesh) * mesh_lib.seq_size(mesh)
           + mesh_lib.seq_rank(mesh))
    return fold_in(seed, idx)


def shift_labels_halo(labels: torch.Tensor, ctx: SeqContext) -> torch.Tensor:
    """``losses.shift_labels`` on a (..., T_loc) block of the sequence:
    shifted[t] = labels[t + 1] at global position, so the block's last
    column is the next rank's first (a one-column halo over the ring)
    and the last rank's is -1."""
    head = labels[..., :1].contiguous()
    nxt = _ring_send_recv([head], ctx.group, -1)[0]
    if ctx.rank == ctx.size - 1:
        nxt = torch.full_like(nxt, -1)
    return torch.cat([labels[..., 1:], nxt], dim=-1)


class SeqCut:
    """A rank's block ``[s T/S, (s+1) T/S)`` of the last dim of the batch
    columns in ``columns`` whose last dim is the global ``T``."""

    def __init__(self, columns, T: int, rank: int, size: int):
        if T % size:
            raise ValueError(f"sequence length {T} not divisible by seq "
                             f"axis size {size}")
        self.columns = tuple(columns)
        self.T = T
        per = T // size
        self.block = slice(rank * per, (rank + 1) * per)

    def apply(self, i: int, a):
        """Column ``i`` cut to the block (a numpy array or a tensor; one
        that is cut already, or has no sequence dim, as it is)."""
        if i in self.columns and a.shape[-1] == self.T:
            return a[..., self.block]
        return a


def _cut(x, ctx: SeqContext):
    per = x.shape[-1] // ctx.size
    return x[..., ctx.rank * per:(ctx.rank + 1) * per]


def seq_parallel_apply(model, params, input_ids, token_type_ids,
                       mc_token_ids, *, train: bool = False,
                       seed: Optional[int] = None):
    """Apply a ring-attention ``GPT2DoubleHeads`` (attached to a seq
    axis) with T sharded over it. Args are global: ids and types (B, C,
    T), T divisible by the axis; ``mc_token_ids`` (B, C) GLOBAL
    positions. Returns (this rank's (B, C, T/S, V) block of the LM
    logits, the (B, C) MC logits, the same on every rank)."""
    if model.config.attn_impl != "ring":
        raise ValueError("seq_parallel_apply requires attn_impl='ring' "
                         f"(got {model.config.attn_impl!r})")
    ctx = context(model)
    T = input_ids.shape[-1]
    if T % ctx.size:
        raise ValueError(f"sequence length {T} not divisible by seq axis "
                         f"size {ctx.size}")
    return functional_call(model, params,
                           (_cut(input_ids, ctx), _cut(token_type_ids, ctx),
                            mc_token_ids), {"train": train, "seed": seed})


def _nll_sums(lm_logits, shifted, ctx: SeqContext):
    """(nll token-sum, labeled-token count) per dialog over the seq group:
    the sum differentiable (identity backward), the count not."""
    valid = shifted != -1
    safe = torch.where(valid, shifted, 0)
    V = lm_logits.shape[-1]
    nll = F.cross_entropy(lm_logits.float().reshape(-1, V),
                          safe.reshape(-1).long(),
                          reduction="none").reshape(shifted.shape)
    nll = torch.where(valid, nll, 0.0)
    nll_sum = reduce_from_seq(torch.sum(nll, dim=(-2, -1)), ctx)
    tokens = sum_over_seq(torch.sum(valid, dim=(-2, -1)).to(torch.float32),
                          ctx)
    return nll_sum, tokens


def _forward(model, params, batch, seed, train):
    input_ids, mc_token_ids, _, _, token_type_ids = batch
    return functional_call(model, params,
                           (input_ids, token_type_ids, mc_token_ids),
                           {"train": train, "seed": seed})


def make_gpt2_train_loss_seq(model, lm_coef: float = 1.0,
                             mc_coef: float = 1.0):
    """The sequence-parallel LM + MC loss (the contract of
    ``losses.make_gpt2_train_loss``) on a rank's block of the batch (its
    ``SeqCut``; ``mc_token_ids`` global): the next-token labels shifted at
    global position (``shift_labels_halo``), each dialog's NLL sum and
    token count summed over the seq group, loss = lm_coef * lm + mc_coef
    * mc, the same on every seq rank. ``seq_columns`` names the columns
    the learner cuts."""
    if model.config.attn_impl != "ring":
        raise ValueError("seq federated loss requires attn_impl='ring'")

    def apply_loss(params, batch, seed, train):
        ctx = context(model)
        lm, mc = _forward(model, params, batch, seed, train)
        nll_sum, tokens = _nll_sums(
            lm, shift_labels_halo(batch[2].long(), ctx), ctx)
        lm_loss = nll_sum / torch.clamp(tokens, min=1.0)
        mc_loss = F.cross_entropy(mc, batch[3].long(), reduction="none")
        loss = lm_coef * lm_loss + mc_coef * mc_loss
        return loss, torch.zeros((1, loss.shape[0]), device=loss.device)

    apply_loss.seq_columns = GPT2_SEQ_COLUMNS
    return apply_loss


def make_gpt2_val_loss_seq(model):
    """The sequence-parallel twin of ``losses.make_gpt2_val_loss``: the
    raw labels shifted by the halo inside; metric rows [mc accuracy, nll
    token-sum, token count] summed over the seq group, for the exact
    token-weighted rollup."""
    if model.config.attn_impl != "ring":
        raise ValueError("seq federated loss requires attn_impl='ring'")

    def apply_loss(params, batch, seed, train):
        ctx = context(model)
        lm, mc = _forward(model, params, batch, None, False)
        nll_sum, tokens = _nll_sums(
            lm, shift_labels_halo(batch[2].long(), ctx), ctx)
        acc = (torch.argmax(mc, -1) == batch[3].long()).to(torch.float32)
        return (nll_sum / torch.clamp(tokens, min=1.0),
                torch.stack([acc, nll_sum, tokens]))

    apply_loss.seq_columns = GPT2_SEQ_COLUMNS
    return apply_loss


def seq_dp_lm_train_step(mesh, model, params, input_ids, token_type_ids,
                         labels, *, train: bool = False,
                         seed: Optional[int] = None):
    """One data + sequence parallel LM step on a ``clients x seq`` mesh:
    batch rows split over ``clients``, the sequence over ``seq`` (ring
    attention inside the model), the gradients summed over both axes.
    Args are global (B, C, T), B divisible by the clients axis and T by
    the seq axis; ``labels`` pre-shifted next-token targets, -1 where
    nothing counts. ``train`` draws dropout from ``seed`` folded with the
    rank's position (``shard_seed``). Returns (mean NLL over the labeled
    tokens, ``{name: gradient}``), the same on every rank."""
    if model.config.attn_impl != "ring":
        raise ValueError("seq_dp_lm_train_step requires attn_impl='ring'")
    ctx = context(model)
    B, C, T = input_ids.shape
    n_dp = mesh_lib.clients_size(mesh)
    if B % n_dp or T % ctx.size:
        raise ValueError(f"batch {B} / seq {T} not divisible by mesh axes "
                         f"({n_dp}, {ctx.size})")
    rows = mesh_lib.worker_block(B, mesh)
    ids, types, labs = (_cut(x[rows], ctx)
                        for x in (input_ids, token_type_ids, labels))
    mc = torch.zeros((ids.shape[0], C), dtype=torch.long,
                     device=input_ids.device)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    lm, _ = functional_call(model, leaves, (ids, types, mc),
                            {"train": train,
                             "seed": shard_seed(seed, mesh) if train
                             else None})
    lp = torch.log_softmax(lm.float(), dim=-1)
    valid = labs >= 0
    tgt = torch.where(valid, labs, 0).long()
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    loss_sum = torch.sum(nll * valid)
    grads = torch.autograd.grad(loss_sum, list(leaves.values()),
                                materialize_grads=True)
    total = torch.clamp(mesh_lib.world_all_reduce(
        torch.sum(valid.to(torch.float32))), min=1.0)
    loss = mesh_lib.world_all_reduce(loss_sum.detach()) / total
    return loss, {k: mesh_lib.world_all_reduce(g) / total
                  for k, g in zip(leaves, grads)}
