"""Megatron tensor parallelism for GPT2 over a ``model`` process group
(port of ``commefficient_tpu/parallel/tp.py``).

The reference annotates the weights' shardings and lets GSPMD insert the
collectives. PyTorch has no GSPMD here, so the layout is written out as
Megatron's: each block's attention and MLP run on the rank's heads and
hidden units, and two autograd Functions over the model group carry the
collectives:

* ``copy_to_tp`` (Megatron's f): identity forward, all-reduce backward,
  at the input of each column-parallel product, so the replicated
  activation's gradient sums every rank's part;
* ``reduce_from_tp`` (Megatron's g): all-reduce forward, identity
  backward, after each row-parallel product (its bias added once, after
  the sum).

So a block's forward closes attention and the MLP with one all-reduce
each, and its backward all-reduces once at each column-parallel input.

The layout (``gpt2_tp_specs``, the reference's rule by parameter path,
in flax's ``(in, out)`` kernel layout):

* column-parallel (``P(None, axis)``): the attention's qkv
  (``CausalSelfAttention_0/Dense_0``, (C, 3C)) and the MLP up (C, 4C);
* row-parallel (``P(axis, None)``): the attention's out (C, C) and the
  MLP down (4C, C);
* everything else replicated (embeddings, LayerNorms, biases, heads).

MoE blocks (``--moe_experts``): the reference's rule row-shards the
router kernel (C, E) over the model axis (its "up-projection" test,
``shape[1] > shape[0]``, is false) and GSPMD computes the MoE FFN under
that layout. The port computes every MoE leaf whole on every model rank,
on the replicated activation, with no f or g around it (``leaf_cut``
leaves ``Block_i.moe.*`` whole), so the routing is bitwise one
process's; their gradients are equal on every model rank and join the
flat gradient as the other whole leaves do.

The qkv kernel is sliced BY HEAD: rank m of M takes heads ``[h0, h1) =
[m H / M, (m + 1) H / M)``, i.e. columns ``[h0 hd, h1 hd)`` of each of
the q, k and v thirds. The reference's spec takes a contiguous third of
the fused (C, 3C) columns, which straddles q/k/v, and GSPMD reshards it
to heads after the split; the products and sums are the same, this
layout only skips that reshard. The column-parallel biases (qkv's and
the MLP up's) are replicated in the reference's spec and in the port's
storage; in the compute each rank adds its slice of them, so their
gradients are joined with the sharded kernels'.

``TPLayout`` (a ``CutLayout``, which ``parallel/ep.py`` shares) cuts a
full ``{torch name: tensor}`` tree into a rank's compute shards
(``shard``) and joins the ranks' shard gradients back into
the flat gradient (``join_grads``: one all-gather of every sharded leaf's
gradient over the model group, placed by copy, so a -0.0 stays -0.0 and
the flat order is the reference's ``ravel_pytree`` order). ``TPUnflatten``
wraps a learner's ``unflatten`` with it.

Serving (``kv_spec_for``/``kv_cache_specs``): the KV state shards along
the head axis with the qkv columns: ``k``/``v`` (dense slabs (B, S, H,
hd) and pools (num_pages, page_size, H, hd)) on dim 2, the quantized
pools' ``k_scale``/``v_scale`` (num_pages, H) on dim 1; the page table
is replicated. Every rank holds H/M heads of every cache and pool (the
engine allocates its heads' pools; ``kv_cache_specs`` states the layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from commefficient_tpu_torch.utils.params import flax_path

AXIS = "model"
#: the column-parallel leaves' cuts: the qkv kernel and bias by head, the
#: MLP up's kernel and bias by hidden unit (torch layout, dim 0)
_QKV, _COLS, _ROWS = "qkv", "cols", "rows"


# --------------------------------------------------------------------------
# the reference's specs
# --------------------------------------------------------------------------


def _spec_for(path: tuple, ndim: int, shape, axis: str) -> tuple:
    names = list(path)
    joined = "/".join(names)
    if ndim == 2 and "Block_" in joined and "kernel" in names:
        if "CausalSelfAttention_0" in joined:
            col = "Dense_0" in names
        else:
            col = shape[1] > shape[0]     # up-projection, flax (in, out)
        return (None, axis) if col else (axis, None)
    return ()


def gpt2_tp_specs(params: Dict[str, torch.Tensor], axis: str = AXIS
                  ) -> Dict[str, tuple]:
    """``{torch name: spec}`` of a ``{torch name: tensor}`` GPT2 tree: the
    reference's ``PartitionSpec`` per leaf as a tuple over the leaf's
    flax-layout dims (``(None, axis)``, ``(axis, None)``, or ``()`` for
    replicated)."""
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        if t.dim() == 2 and name.endswith(".weight"):
            shape = shape[::-1]           # torch (out, in) -> flax (in, out)
        out[name] = _spec_for(flax_path(name), t.dim(), shape, axis)
    return out


# --------------------------------------------------------------------------
# the process group and its collectives
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TPContext:
    """A rank's place on the model axis: its group, rank and size."""
    group: object
    rank: int
    size: int

    @classmethod
    def from_mesh(cls, mesh, axis: str = AXIS) -> Optional["TPContext"]:
        """The ``axis`` of ``mesh`` (None without one above 1)."""
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if axis not in names or mesh[axis].size() == 1:
            return None
        return cls(mesh.get_group(axis), mesh.get_local_rank(axis),
                   mesh[axis].size())


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp.group)


# --------------------------------------------------------------------------
# the compute layout
# --------------------------------------------------------------------------


def leaf_cut(name: str) -> Optional[str]:
    """How a GPT2 leaf is cut for the compute: ``"qkv"`` (by head, dim 0),
    ``"cols"`` (a contiguous block of dim 0: the MLP up's kernel and
    bias), ``"rows"`` (a contiguous block of dim 1: the row-parallel
    kernels), or None (whole)."""
    parts = name.split(".")
    if not parts[0].startswith("Block_") or len(parts) < 3:
        return None
    leaf, dense = parts[-1], parts[-2]
    if len(parts) == 4 and parts[1] == "CausalSelfAttention_0":
        if dense == "Dense_0":
            return _QKV
        if dense == "Dense_1" and leaf == "weight":
            return _ROWS
        return None
    if len(parts) == 3 and dense == "Dense_0":
        return _COLS
    if len(parts) == 3 and dense == "Dense_1" and leaf == "weight":
        return _ROWS
    return None


def cut_index(kind: str, full: int, rank: int, size: int,
              device=None) -> torch.Tensor:
    """(full / size,) int64: the indices along the cut dim that ``rank``
    holds of a leaf whose cut dim has ``full`` entries."""
    if kind == _QKV:
        C = full // 3
        per = C // size                   # (H / size) heads of C / H each
        base = torch.arange(rank * per, (rank + 1) * per, device=device)
        return torch.cat([base, base + C, base + 2 * C])
    per = full // size
    return torch.arange(rank * per, (rank + 1) * per, device=device)


def cut_dim(kind: str) -> int:
    return 1 if kind == _ROWS else 0


def local_piece(t: torch.Tensor, kind: str, tp: TPContext,
                local_extent: int) -> torch.Tensor:
    """``t`` cut to this rank's piece, unless it is one already
    (``t.shape[dim] == local_extent``): a serving or drafting call passes
    whole weights, a training round the shards ``TPUnflatten`` cut."""
    dim = cut_dim(kind)
    if t.shape[dim] == local_extent:
        return t
    if kind == _QKV:
        return t.index_select(dim, cut_index(kind, t.shape[dim], tp.rank,
                                             tp.size, t.device))
    return t.narrow(dim, tp.rank * local_extent, local_extent)


class CutLayout:
    """The compute cuts of one parameter tree over a ``size``-rank group:
    ``cuts`` maps a cut leaf's name to its kind (``leaf_cut``'s kinds),
    every other leaf of ``shapes`` (the tree's, in its order) is whole."""

    def __init__(self, shapes: Dict[str, tuple], cuts: Dict[str, str],
                 size: int):
        self.shapes = dict(shapes)
        self.size = size
        self.cuts = dict(cuts)

    def index(self, name: str, rank: int, device=None) -> torch.Tensor:
        kind = self.cuts[name]
        return cut_index(kind, self.shapes[name][cut_dim(kind)], rank,
                         self.size, device)

    def shard(self, params: Dict[str, torch.Tensor], rank: int
              ) -> Dict[str, torch.Tensor]:
        """``rank``'s compute tree: the cut leaves' pieces, the rest
        whole (the same tensors)."""
        out = {}
        for name, t in params.items():
            kind = self.cuts.get(name)
            if kind is None:
                out[name] = t
            elif kind == _QKV:
                out[name] = t.index_select(
                    0, self.index(name, rank, t.device))
            else:
                dim = cut_dim(kind)
                per = t.shape[dim] // self.size
                out[name] = t.narrow(dim, rank * per, per)
        return out

    def gather(self, mine: torch.Tensor, group) -> list:
        """Every rank's ``mine`` over ``group``, in rank order."""
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=group)
        return parts

    def join_grads(self, views: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], group,
                   accumulate: bool) -> None:
        """Write (or add, with ``accumulate``) each leaf's gradient into
        its view of the flat gradient (``views``: the full leaves). A cut
        leaf's gradient is this rank's piece: the pieces of every cut
        leaf go over the group in ONE all-gather, and each rank's piece
        lands at its indices; whole leaves' gradients are equal on every
        rank and go as they are."""
        cut = [n for n in grads if n in self.cuts]
        for name, g in grads.items():
            if name in self.cuts:
                continue
            if accumulate:
                views[name].add_(g)
            else:
                views[name].copy_(g)
        if not cut:
            return
        mine = torch.cat([grads[n].reshape(-1) for n in cut])
        for r, flat in enumerate(self.gather(mine, group)):
            off = 0
            for name in cut:
                g = grads[name]
                piece = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
                dim = cut_dim(self.cuts[name])
                idx = self.index(name, r, g.device)
                if accumulate:
                    views[name].index_add_(dim, idx, piece)
                else:
                    views[name].index_copy_(dim, idx, piece)


class TPLayout(CutLayout):
    """The compute cuts of one GPT2 parameter tree on an M-way model axis
    (``leaf_cut``), in the order of ``names`` (the tree's)."""

    def __init__(self, shapes: Dict[str, tuple], n_head: int, size: int):
        if n_head % size:
            raise ValueError(f"tensor parallelism shards the heads: n_head "
                             f"{n_head} must be divisible by the 'model' "
                             f"mesh axis size {size}")
        super().__init__(shapes, {n: k for n in shapes
                                  if (k := leaf_cut(n)) is not None}, size)
        self.n_head = n_head


def shard_params_tp(params: Dict[str, torch.Tensor], rank: int, size: int,
                    n_head: int) -> Dict[str, torch.Tensor]:
    """``rank``'s compute tree of a whole ``{torch name: tensor}`` GPT2
    tree on a ``size``-way model axis (``TPLayout.shard``)."""
    return TPLayout({n: tuple(t.shape) for n, t in params.items()}, n_head,
                    size).shard(params, rank)


class TPUnflatten:
    """A learner's ``unflatten`` on a model axis: ``flat`` (the padded
    vector, every coordinate) -> this rank's compute tree of the logical
    prefix; ``write_grads`` joins the ranks' shard gradients into a flat
    gradient (``federated/client.py`` calls it in place of the views)."""

    def __init__(self, base, d_logical: int, layout: CutLayout,
                 tp: TPContext):
        self.base = base
        self.d = int(d_logical)
        self.layout = layout
        self.tp = tp

    def full(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every leaf whole (views of ``flat``)."""
        return self.base(flat[:self.d])

    def __call__(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.layout.shard(self.full(flat), self.tp.rank)

    def write_grads(self, grad_flat: torch.Tensor,
                    grads: Dict[str, torch.Tensor], accumulate: bool
                    ) -> None:
        self.layout.join_grads(self.full(grad_flat), grads, self.tp.group,
                               accumulate)


def attach(model: torch.nn.Module, tp: Optional[TPContext]) -> None:
    """Run ``model`` (a ``GPT2DoubleHeads``) tensor-parallel on ``tp``'s
    model axis (None: replicated again). Its blocks then compute on H/M
    heads and 4C/M hidden units (an MoE block whole) and its caches hold
    H/M heads."""
    cfg = model.config
    if tp is not None:
        if cfg.n_head % tp.size:
            raise ValueError(f"tensor parallelism shards the heads: n_head "
                             f"{cfg.n_head} must be divisible by the "
                             f"'model' mesh axis size {tp.size}")
    cfg.tp = tp


def local_heads(config) -> int:
    """The heads a rank holds (all of them off a model axis)."""
    tp = getattr(config, "tp", None)
    return config.n_head // (tp.size if tp is not None else 1)


# --------------------------------------------------------------------------
# serving: KV cache and page-pool layout
# --------------------------------------------------------------------------


def kv_spec_for(key: str, leaf, axis: str = AXIS) -> tuple:
    """The spec of one KV-cache leaf by its key: ``k``/``v`` (4-D) shard
    dim 2, ``k_scale``/``v_scale`` (2-D) dim 1, the rest (the page table
    ``pt``) is replicated."""
    if key in ("k", "v") and leaf.dim() == 4:
        return (None, None, axis)
    if key in ("k_scale", "v_scale") and leaf.dim() == 2:
        return (None, axis)
    return ()


def kv_cache_specs(cache, axis: str = AXIS):
    """Specs of a decode cache or page-pool tuple of per-layer dicts."""
    return tuple({k: kv_spec_for(k, v, axis) for k, v in layer.items()}
                 for layer in cache)

