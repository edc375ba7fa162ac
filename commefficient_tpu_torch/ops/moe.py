"""Switch Mixture-of-Experts FFN (port of ``commefficient_tpu/ops/moe.py``
``MoEFFN``, the single-device layer).

Top-1 routing with a capacity: a float32 router ``Linear(C, E)``, softmax,
argmax, the gate the chosen expert's probability; each token's slot in
its expert is its place among that expert's tokens in token order
(``cumsum(onehot) * onehot - onehot``), and a token whose slot is at or
past the capacity ``max(1, int(capacity_factor * N / E))`` is dropped
(its output is zero; the transformer's residual carries it). N is every
token of the call, so the capacity group is the whole forward: the
round's fused path routes all clients' tokens together, the per-worker
paths one client (or one chunk) at a time, as in the reference.
Dispatch and combine are dense (N, E, cap) one-hot einsums over the
stacked expert weights ``moe_w1`` (E, C, d_ff), ``moe_b1``, ``moe_w2``
(E, d_ff, C), ``moe_b2``, with the reference's einsum strings; the
reference computes them outside any Pallas kernel, and so does the port.

``forward`` returns ``(output, aux)``, the Switch load-balancing term
``E * sum(frac * mean_prob)`` beside the output, where the reference sows
it (a returned value, not an attribute: ``torch.utils.checkpoint``
recomputes the forward under remat).

Whole-batch routing on a ``clients`` axis (``routing_group``): the
reference's fused round is one GSPMD-partitioned loss call over every
client's tokens, so its capacity, its slots and its aux term are those of
the whole batch. A rank of the port's clients axis holds only its
workers' tokens; inside ``routing_group(RouteGroup(...))`` (the fused
round enters it on a clients axis above 1) the layer routes over the
group as one call would: the ranks' per-expert counts are all-gathered
once, the capacity is ``max(1, int(capacity_factor * N / E))`` with N
their sum (every token has one expert), a token's slot is its local
cumsum slot plus the counts of the lower ranks in rank order, and
``frac`` and ``mean_prob`` are the group's sums over N, the router
probabilities' sum through an all-reduce whose backward all-reduces its
cotangent (so the ranks' ``n_r * w * aux`` terms sum to one process's
``n * w * aux`` and to its gradient). Off it (one process, the
per-worker paths, validation) nothing changes.

Expert parallelism (``config.ep``, an ``parallel.ep.EPContext``): the
router, softmax, slots, capacity and aux run whole and replicated on
every expert rank, over all N tokens and all E experts; rank e holds the
experts ``[e E / size, (e + 1) E / size)`` (their stacked weights cut on
dim 0 by ``moe_ep_specs``' rule, or whole weights it cuts), builds only
its (N, E / size, cap) slice of the dispatch and runs the reference's
einsums on it. Megatron's f (identity forward, all-reduce backward over
the expert group) takes ``xt`` and the gate into the local compute and
Megatron's g (all-reduce forward, identity backward) closes the combined
output: each token has one nonzero dispatch entry, so the sums add exact
zeros.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

#: the stacked expert leaves, cut on dim 0 over an ``expert`` axis
EXPERT_LEAVES = ("moe_w1", "moe_b1", "moe_w2", "moe_b2")


def is_expert_leaf(name: str) -> bool:
    """Whether the torch name ``name`` is a stacked expert leaf (at any
    depth)."""
    return name.rsplit(".", 1)[-1] in EXPERT_LEAVES


class RouteGroup(NamedTuple):
    """The ranks whose tokens route together: a ``clients`` process
    group, this rank's place in it and its size."""
    group: object
    rank: int
    size: int


#: the routing group of the calls in the current context (dynamic scope)
_ROUTE: contextvars.ContextVar = contextvars.ContextVar("moe_route",
                                                       default=None)


@contextlib.contextmanager
def routing_group(ctx: Optional[RouteGroup]):
    """Route every MoE call inside over ``ctx``'s ranks (None: alone)."""
    token = _ROUTE.set(ctx)
    try:
        yield
    finally:
        _ROUTE.reset(token)


def _gather_rows(t: torch.Tensor, ctx: RouteGroup) -> torch.Tensor:
    """(size, ...) every rank's ``t`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(ctx.size)]
    dist.all_gather(parts, t.contiguous(), group=ctx.group)
    return torch.stack(parts)


class _GroupSum(torch.autograd.Function):
    """All-reduce forward, all-reduce of the cotangent backward: the sum
    over the group of a term every rank's loss reads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class Routing(NamedTuple):
    """One call's routing: router ``probs`` (N, E), the chosen ``expert``
    (N,), its float32 ``onehot`` (N, E) and ``gate`` (N,), each token's
    ``slot`` (N,) in its expert, ``keep`` (N,) = slot < ``capacity``, and
    the load-balancing term ``aux``."""
    probs: torch.Tensor
    expert: torch.Tensor
    onehot: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor


class MoEFFN(nn.Module):
    """Drop-in replacement for a transformer MLP: (..., C) -> ((..., C),
    aux). Parameters in the reference's names: ``router.weight`` (flax's
    ``router/kernel``, transposed) and ``router.bias``; ``moe_w1``,
    ``moe_b1``, ``moe_w2``, ``moe_b2`` in the reference's layout."""

    def __init__(self, n_embd: int, num_experts: int, d_ff: int,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E, C = num_experts, n_embd
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.compute_dtype = dtype
        self.router = nn.Linear(C, E)
        self.moe_w1 = nn.Parameter(torch.empty(E, C, d_ff))
        self.moe_b1 = nn.Parameter(torch.zeros(E, d_ff))
        self.moe_w2 = nn.Parameter(torch.empty(E, d_ff, C))
        self.moe_b2 = nn.Parameter(torch.zeros(E, C))

    def route(self, xt: torch.Tensor) -> Routing:
        """The routing of the (N, C) tokens ``xt`` (over the
        ``routing_group`` inside one)."""
        E = self.num_experts
        logits = F.linear(xt.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, 1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, E).float()
        slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot - onehot,
                         dim=-1).int()
        grp = _ROUTE.get()
        if grp is None:
            # Python float arithmetic, as the reference computes it
            cap = max(1, int(self.capacity_factor * xt.shape[0] / E))
            # Switch load balancing: E * sum_e f_e * p_e, f_e the fraction
            # of tokens routed to e and p_e its mean router probability
            aux = E * torch.sum(torch.mean(onehot, dim=0)
                                * torch.mean(probs, dim=0))
        else:
            # the ranks' (E,) counts, one host read: N and the slot offsets
            counts = _gather_rows(onehot.sum(0), grp)
            rows = counts.to(torch.int64).tolist()
            n = sum(map(sum, rows))
            before = [sum(r[e] for r in rows[:grp.rank]) for e in range(E)]
            slot = slot + torch.tensor(before, dtype=slot.dtype,
                                       device=slot.device)[expert]
            cap = max(1, int(self.capacity_factor * n / E))
            aux = E * torch.sum((counts.sum(0) / n)
                                * (_GroupSum.apply(probs.sum(0), grp.group)
                                   / n))
        return Routing(probs, expert, onehot, gate, slot, slot < cap, cap,
                       aux)

    def forward(self, x: torch.Tensor, ep=None):
        """``(output, aux)``; with ``ep`` (an ``EPContext``) this rank
        computes its experts' share and the group sums the output."""
        shape = x.shape
        xt = x.reshape(-1, shape[-1])
        E = self.num_experts
        r = self.route(xt)
        onehot, gate = r.onehot, r.gate
        w1, b1, w2, b2 = self.moe_w1, self.moe_b1, self.moe_w2, self.moe_b2
        if ep is not None:
            from commefficient_tpu_torch.parallel import ep as ep_lib
            per = E // ep.size
            lo = ep.rank * per
            onehot = onehot[:, lo:lo + per]
            # a training round's cut leaves, or whole weights to cut
            w1, b1, w2, b2 = (t if t.shape[0] == per else
                              t.narrow(0, lo, per) for t in (w1, b1, w2, b2))
            xt, gate = (ep_lib.copy_to_experts(t, ep) for t in (xt, gate))
        # (N, E, cap) one-hot dispatch (this rank's experts' slice); a slot
        # at or past the capacity has no column, so its token's row is zero
        # (the reference's keep mask)
        slots = torch.arange(r.capacity, device=x.device, dtype=r.slot.dtype)
        dispatch = onehot[:, :, None] * (r.slot[:, None] == slots).float()[
            :, None, :]

        dt = self.compute_dtype
        xin = torch.einsum("nec,nd->ecd", dispatch.to(dt), xt.to(dt))
        h = F.gelu(torch.einsum("ecd,edh->ech", xin, w1.to(dt))
                   + b1[:, None, :].to(dt), approximate="tanh")
        out_e = (torch.einsum("ech,ehd->ecd", h, w2.to(dt))
                 + b2[:, None, :].to(dt))
        combine = dispatch * gate[:, None, None]
        out = torch.einsum("nec,ecd->nd", combine.to(dt), out_e)
        if ep is not None:
            out = ep_lib.reduce_from_experts(out, ep)
        return out.to(x.dtype).reshape(shape), r.aux


def moe_ep_specs(params: Dict[str, torch.Tensor], axis: str = "expert"
                 ) -> Dict[str, tuple]:
    """``{torch name: spec}`` of a ``{torch name: tensor}`` tree: the
    reference's ``PartitionSpec`` per leaf as a tuple, ``(axis,)`` for a
    stacked expert leaf (``moe_w1``, ``moe_b1``, ``moe_w2``, ``moe_b2`` at
    any depth, dim 0 the experts) and ``()`` (replicated) for the rest."""
    return {name: (axis,) if is_expert_leaf(name) and t.dim() >= 1 else ()
            for name, t in params.items()}


def shard_params_ep(params: Dict[str, torch.Tensor], rank: int, size: int
                    ) -> Dict[str, torch.Tensor]:
    """``rank``'s tree on a ``size``-way expert axis: each stacked expert
    leaf cut to its block of dim 0 (the layout ``moe_ep_specs`` gives the
    reference's ``shard_params_ep``), the rest whole (the same
    tensors)."""
    out = {}
    for name, t in params.items():
        if is_expert_leaf(name) and t.dim() >= 1:
            per = t.shape[0] // size
            t = t.narrow(0, rank * per, per)
        out[name] = t
    return out
