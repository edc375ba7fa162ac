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
recomputes the forward under remat). The expert sharding
(``moe_ep_specs``, ``shard_params_ep``) is ROADMAP.md A12.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class Routing(NamedTuple):
    """One call's routing: router ``probs`` (N, E), the chosen ``expert``
    (N,), its float32 ``onehot`` (N, E) and ``gate`` (N,), each token's
    ``slot`` (N,) in its expert, ``keep`` (N,) = slot < ``capacity``."""
    probs: torch.Tensor
    expert: torch.Tensor
    onehot: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


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
        """The routing of the (N, C) tokens ``xt``."""
        logits = F.linear(xt.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, 1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, self.num_experts).float()
        slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot - onehot,
                         dim=-1).int()
        # Python float arithmetic, as the reference computes it
        cap = max(1, int(self.capacity_factor * xt.shape[0]
                         / self.num_experts))
        return Routing(probs, expert, onehot, gate, slot, slot < cap, cap)

    def forward(self, x: torch.Tensor):
        shape = x.shape
        xt = x.reshape(-1, shape[-1])
        E = self.num_experts
        r = self.route(xt)
        # (N, E, cap) one-hot dispatch; a slot at or past the capacity has
        # no column, so its token's row is zero (the reference's keep mask)
        slots = torch.arange(r.capacity, device=x.device, dtype=r.slot.dtype)
        dispatch = r.onehot[:, :, None] * (r.slot[:, None] == slots).float()[
            :, None, :]

        dt = self.compute_dtype
        xin = torch.einsum("nec,nd->ecd", dispatch.to(dt), xt.to(dt))
        h = F.gelu(torch.einsum("ecd,edh->ech", xin, self.moe_w1.to(dt))
                   + self.moe_b1[:, None, :].to(dt), approximate="tanh")
        out_e = (torch.einsum("ech,ehd->ecd", h, self.moe_w2.to(dt))
                 + self.moe_b2[:, None, :].to(dt))
        combine = dispatch * r.gate[:, None, None]
        out = torch.einsum("nec,ecd->nd", combine.to(dt), out_e)

        # Switch load balancing: E * sum_e f_e * p_e, f_e the fraction of
        # tokens routed to e and p_e its mean router probability
        aux = E * torch.sum(torch.mean(r.onehot, dim=0)
                            * torch.mean(r.probs, dim=0))
        return out.to(x.dtype).reshape(shape), aux
