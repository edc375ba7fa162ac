"""MoE expert parallelism for GPT2 over an ``expert`` process group (the
reference's ``--mesh clients=C,expert=E``: ``commefficient_tpu/ops/moe.py``
``moe_ep_specs``/``shard_params_ep`` and ``training/gpt2.py``'s EP
federation).

The reference shards the stacked expert leaves (``moe_w1``, ``moe_b1``,
``moe_w2``, ``moe_b2``) on dim 0 over the ``expert`` axis, replicates the
rest and lets GSPMD partition the expert einsums. The port writes the
layout out:

* every rank of an expert group holds the same tokens (the group is one
  client shard: the round hands it the shard's workers) and computes
  everything but the experts whole and replicated: the attention, the
  LayerNorms, the heads, and each MoE block's router, softmax, slots,
  capacity and aux term over all N tokens and all E experts (the
  capacity is never taken from E / size);
* rank e computes the experts ``[e E / size, (e + 1) E / size)`` on its
  slice of the dispatch; two autograd Functions over the expert group
  carry the collectives, as Megatron's do on a model axis (``tp.py``):
  ``copy_to_experts`` (f: identity forward, all-reduce backward) where
  the tokens and the gate enter the local compute, ``reduce_from_experts``
  (g: all-reduce forward, identity backward) on the combined output.
  Each token has exactly one nonzero dispatch entry, so the sums add
  exact zeros.

``EPLayout`` (a ``tp.CutLayout``) cuts a rank's expert leaves from a full
``{torch name: tensor}`` tree and joins the ranks' expert-leaf gradients
into the flat gradient by ONE all-gather over the expert group, placed by
copy (a -0.0 stays -0.0; the flat order is the reference's
``ravel_pytree`` order). Every other leaf is replicated: after f and g
its gradient is the same on every expert rank, and it is taken as it is,
not summed. ``EPUnflatten`` wraps a learner's ``unflatten`` with it. The
flat state stays replicated over ``expert``, as in the reference
(``fed_state_shardings`` shards only a ``model`` axis), and the round
sums the gradient over the clients group only.

The collectives go through ``combine_sum``, ``grad_sum`` and
``gather_grads`` (module functions, looked up at each call), so a clock
can time the three kinds apart (``tools/mesh_run.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from commefficient_tpu_torch.ops.moe import is_expert_leaf
from commefficient_tpu_torch.parallel import tp as tp_lib

AXIS = "expert"


@dataclass(frozen=True)
class EPContext:
    """A rank's place on the expert axis: its group, rank and size."""
    group: object
    rank: int
    size: int

    @classmethod
    def from_mesh(cls, mesh, axis: str = AXIS) -> Optional["EPContext"]:
        """The ``axis`` of ``mesh`` (None without one above 1)."""
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if axis not in names or mesh[axis].size() == 1:
            return None
        return cls(mesh.get_group(axis), mesh.get_local_rank(axis),
                   mesh[axis].size())


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def combine_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The combined MoE output's sum over the expert group (g)."""
    return _summed(t, group)


def grad_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A replicated input's gradient summed over the expert group (f)."""
    return _summed(t, group)


def gather_grads(t: torch.Tensor, group, size: int) -> list:
    """Every expert rank's expert-leaf gradients, in rank order."""
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


class _CopyToExperts(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return grad_sum(g, ctx.group), None


class _ReduceFromExperts(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return combine_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_experts(x: torch.Tensor, ep: EPContext) -> torch.Tensor:
    return _CopyToExperts.apply(x, ep.group)


def reduce_from_experts(x: torch.Tensor, ep: EPContext) -> torch.Tensor:
    return _ReduceFromExperts.apply(x, ep.group)


class EPLayout(tp_lib.CutLayout):
    """The expert cuts of one parameter tree on a ``size``-way expert
    axis: each stacked expert leaf's block of dim 0, the rest whole
    (``attach`` checks that the experts divide)."""

    def __init__(self, shapes: Dict[str, tuple], size: int):
        super().__init__(shapes, {n: tp_lib._COLS for n in shapes
                                  if is_expert_leaf(n)}, size)

    def gather(self, mine: torch.Tensor, group) -> list:
        return gather_grads(mine, group, self.size)


class EPUnflatten(tp_lib.TPUnflatten):
    """A learner's ``unflatten`` on an expert axis: ``flat`` -> this
    rank's compute tree (its expert leaves' blocks, the rest whole);
    ``write_grads`` joins the expert ranks' expert-leaf gradients into
    the flat gradient (``federated/client.py`` calls it)."""


def attach(model: torch.nn.Module, ep: Optional[EPContext]) -> None:
    """Run ``model`` (a ``GPT2DoubleHeads`` with MoE blocks) expert-
    parallel on ``ep``'s expert axis (None: replicated again)."""
    cfg = model.config
    if ep is not None:
        if cfg.moe_experts <= 0:
            raise ValueError("--mesh expert=E shards MoE expert weights; "
                             "pass --moe_experts > 0 (got 0)")
        if cfg.moe_experts % ep.size:
            raise ValueError(f"expert parallelism shards the experts: "
                             f"--moe_experts {cfg.moe_experts} must be "
                             f"divisible by the 'expert' mesh axis size "
                             f"{ep.size}")
    cfg.ep = ep
