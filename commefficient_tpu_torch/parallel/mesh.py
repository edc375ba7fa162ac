"""The ``clients`` and ``clients x model`` meshes and their layout (port
of ``commefficient_tpu/parallel/mesh.py``).

The reference shards the round over a ``jax.sharding.Mesh`` with one
``clients`` axis: each chip simulates W/N of the sampled clients, the
per-client state rows are split into blocks along the axis, the server
state is replicated, and XLA inserts the reduce of the transmits. Here
each rank is one process of a ``torch.distributed`` group and the mesh a
``DeviceMesh`` with a ``clients`` dimension; the layout is the
reference's, written out:

* rank ``r`` runs workers ``worker_block(W, mesh)`` = ``[r W/N, (r+1)
  W/N)``, the block split of ``batch_shardings``;
* it owns client rows ``row_block(n, mesh)`` = ``[r n/N, (r+1) n/N)``, as
  jax's leading-dim sharding and ``HostArenaStore``'s block partition give
  them, and the buffered server's slots ``slot_block(M, mesh)`` alike;
* weights and server state are replicated, and every rank's copy stays
  bitwise the others' (the reduce is an ``all_reduce``, whose result is
  the same on every rank, and the rest is deterministic).

``padded_num_clients`` rounds the client rows up to a multiple of the
axis, as the reference's entry points do.

A ``model`` axis (``make_mesh(n, model=M)``, 2-D clients x model
federation) lays the ranks out as the reference's ``reshape(n // M, M)``:
rank ``c * M + m`` is client shard ``c`` and model shard ``m``, the model
axis fastest. ``clients_group`` is then the ranks that share ``m`` and
``model_group`` the ranks that share ``c``. The flat vector is padded to
a multiple of M and each model rank stores ``coord_block(d_pad, mesh)``
of it, the layout of the reference's ``fed_state_shardings``; the model
computes in the Megatron layout of ``parallel/tp.py``.

A ``seq`` axis (``make_mesh(n, seq=S)``, sequence parallelism: ring
attention, ``parallel/seq.py``) lays the ranks out alike: rank ``c * S +
s`` is client shard ``c`` and sequence shard ``s``, the seq axis fastest.
``clients_group`` is then the ranks that share ``s`` and ``seq_group`` the
ranks that share ``c``. Every state (weights, server state, client rows)
is replicated over ``seq``; rank (c, s) runs the workers of client shard
c on its columns ``[s T/S, (s+1) T/S)`` of the sequence.

A ``stage`` axis (``make_mesh(n, stage=S)``, GPipe pipeline parallelism
for GPT2, ``parallel/pp.py``) lays the ranks out alike again: rank ``c *
S + s`` is client shard ``c`` and pipeline stage ``s``. Every state is
replicated over ``stage``; the S ranks of a client shard run its workers
together, stage s applying layers ``[s L/S, (s+1) L/S)``.

An ``expert`` axis (``make_mesh(n, expert=E)``, MoE expert parallelism
for GPT2, ``parallel/ep.py``) lays the ranks out alike: rank ``c * E +
e`` is client shard ``c`` and expert shard ``e``. Every state is
replicated over ``expert``; the E ranks of a client shard run its workers
together, rank e computing the experts ``[e X/E, (e+1) X/E)`` of each MoE
block (X the model's experts) and everything else whole.

The collectives here take bool tensors as uint8 (gloo reduces no bool).
Those of the ``clients`` axis return at once on an axis of one rank: a
sum, a join or a broadcast over one rank is the tensor itself, and gloo
would stage it through the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from commefficient_tpu_torch.utils.params import round_up

AXIS = "clients"


@dataclass(frozen=True)
class MeshSpec:
    """A parsed ``--mesh``: the axis sizes, before any process joins. It
    answers ``shape`` and ``axis_names`` as the reference's ``Mesh`` does,
    so ``round_up_workers_for_mesh`` and the entry points' checks read
    either."""
    clients: int
    inner: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {AXIS: self.clients, **{k: v for k, v in self.inner.items()
                                       if v > 1}}

    @property
    def axis_names(self):
        return tuple(self.shape)


class _Dim:
    def __init__(self, size: int):
        self._size = size

    def size(self) -> int:
        return self._size


class GroupMesh:
    """A 2-D ``(clients, inner)`` mesh over the process group, the inner
    axis ``model``, ``seq``, ``stage`` or ``expert``: the ``DeviceMesh``
    calls the port reads (``mesh[axis].size()``, ``get_local_rank``,
    ``get_group``, ``device_type``, ``mesh_dim_names``), over groups made
    with ``new_group``, so it runs on any backend. Rank ``c * M + m`` sits at
    (c, m), the inner axis fastest."""

    def __init__(self, shape: tuple, names: tuple, device_type: str):
        C, M = shape
        self.shape = dict(zip(names, shape))
        self.mesh_dim_names = tuple(names)
        self.device_type = device_type
        r = dist.get_rank()
        self._coord = {names[0]: r // M, names[1]: r % M}
        self._groups = {}
        # every rank makes every group, in one order
        for m in range(M):
            g = dist.new_group([c * M + m for c in range(C)])
            if r % M == m:
                self._groups[names[0]] = g
        for c in range(C):
            g = dist.new_group([c * M + m for m in range(M)])
            if r // M == c:
                self._groups[names[1]] = g

    def __getitem__(self, axis: str) -> _Dim:
        return _Dim(self.shape[axis])

    def get_local_rank(self, axis: str) -> int:
        return self._coord[axis]

    def get_group(self, axis: str):
        return self._groups[axis]


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS,
              seq: int = 1, model: int = 1, stage: int = 1,
              expert: int = 1, device_type: str = "cpu"):
    """The mesh over the process group (joined first:
    ``distributed.initialize``/``launch``): a ``DeviceMesh`` with one
    ``clients`` dimension, or with ``model`` = M > 1 (or ``seq``,
    ``stage`` or ``expert``) a ``GroupMesh`` of dims ``("clients",
    "model")`` (``("clients", "seq")``, ``("clients", "stage")``,
    ``("clients", "expert")``) of shape (n / M, M). Inner axes of size 1
    are accepted."""
    if sum(s > 1 for s in (seq, model, stage, expert)) > 1:
        raise ValueError("choose ONE inner axis: seq (ring attention), "
                         "model (tensor parallelism), stage (GPipe "
                         "pipeline), or expert (MoE expert parallelism)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(f"asked for a {n}-rank mesh, the process group "
                         f"has {world} ranks")
    for name, size in (("model", model), ("seq", seq), ("stage", stage),
                       ("expert", expert)):
        if size > 1:
            if n % size:
                raise ValueError(f"n_devices must be divisible by {name}")
            return GroupMesh((n // size, size), (axis, name), device_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def clients_size(mesh, axis: str = AXIS) -> int:
    """The ``clients`` axis size of a mesh or a ``MeshSpec`` (1 for none)."""
    if mesh is None:
        return 1
    if isinstance(mesh, MeshSpec):
        return mesh.clients
    return mesh[axis].size()


def clients_rank(mesh, axis: str = AXIS) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def clients_group(mesh, axis: str = AXIS):
    """The ranks of this rank's ``clients`` axis: every rank of a 1-D
    mesh, the ranks that share this rank's model shard on a 2-D one."""
    return mesh.get_group(axis)


def inner_size(mesh, name: str) -> int:
    """The size of the inner axis ``name`` of a mesh or a ``MeshSpec`` (1
    for none)."""
    if mesh is None:
        return 1
    if isinstance(mesh, MeshSpec):
        return max(1, int(mesh.inner.get(name, 1)))
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh[name].size() if name in names else 1


def model_size(mesh) -> int:
    """The ``model`` axis size of a mesh or a ``MeshSpec`` (1 for none)."""
    return inner_size(mesh, "model")


def model_rank(mesh) -> int:
    return 0 if model_size(mesh) == 1 else mesh.get_local_rank("model")


def seq_size(mesh) -> int:
    """The ``seq`` axis size of a mesh or a ``MeshSpec`` (1 for none)."""
    return inner_size(mesh, "seq")


def seq_rank(mesh) -> int:
    return 0 if seq_size(mesh) == 1 else mesh.get_local_rank("seq")


def seq_group(mesh):
    """The ranks that share this rank's client shard (its seq axis)."""
    return mesh.get_group("seq")


def stage_size(mesh) -> int:
    """The ``stage`` axis size of a mesh or a ``MeshSpec`` (1 for none)."""
    return inner_size(mesh, "stage")


def stage_rank(mesh) -> int:
    return 0 if stage_size(mesh) == 1 else mesh.get_local_rank("stage")


def stage_group(mesh):
    """The ranks that share this rank's client shard (its pipeline)."""
    return mesh.get_group("stage")


def expert_size(mesh) -> int:
    """The ``expert`` axis size of a mesh or a ``MeshSpec`` (1 for
    none)."""
    return inner_size(mesh, "expert")


def expert_rank(mesh) -> int:
    return 0 if expert_size(mesh) == 1 else mesh.get_local_rank("expert")


def expert_group(mesh):
    """The ranks that share this rank's client shard (its expert axis)."""
    return mesh.get_group("expert")


def model_group(mesh):
    """The ranks that share this rank's client shard (its model axis)."""
    return mesh.get_group("model")


def coord_block(d_pad: int, mesh, align: int = 1) -> tuple:
    """``(lo, hi)``: the contiguous block of the padded flat vector this
    rank stores on a model axis (the whole vector without one). With
    ``align`` the inner cuts move down to a multiple of it (the tiled
    sketch's 128-lane blocks: a rank sketches such a block)."""
    M = model_size(mesh)
    if d_pad % M:
        raise ValueError(f"flat length {d_pad} is not a multiple of the "
                         f"model axis {M}")
    per = d_pad // M
    m = model_rank(mesh)

    def cut(i):
        return d_pad if i == M else (i * per) // align * align
    return cut(m), cut(m + 1)


def padded_num_clients(num_clients: int, mesh, axis: str = AXIS) -> int:
    """Client rows must divide the mesh axis; pad with inert rows
    (samplers only emit real client ids, so a padded row is never
    gathered or written)."""
    if mesh is None:
        return num_clients
    return round_up(num_clients, clients_size(mesh, axis))


def _block(n: int, mesh) -> tuple:
    N, r = clients_size(mesh), clients_rank(mesh)
    per = n // N
    return r * per, (r + 1) * per


def worker_block(num_workers: int, mesh) -> slice:
    """This rank's workers: ``batch_shardings``' leading-dim block."""
    lo, hi = _block(num_workers, mesh)
    return slice(lo, hi)


def row_block(num_rows: int, mesh) -> tuple:
    """``(lo, hi)``: the client rows this rank owns."""
    return _block(num_rows, mesh)


def slot_block(m: int, mesh) -> tuple:
    """``(lo, hi)``: the buffered server's slots this rank owns
    (``buffer_state_shardings``)."""
    return _block(m, mesh)


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks of this rank's ``clients`` axis,
    the same bits on every one (a copy of ``t`` on an axis of one)."""
    if clients_size(mesh) == 1:
        return t.clone()
    out = t.clone()
    dist.all_reduce(out, group=clients_group(mesh))
    return out


def world_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank of the group (both axes of a 2-D
    mesh: a seq or stage mesh's gradient)."""
    out = t.clone()
    dist.all_reduce(out)
    return out


def model_all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over this rank's model axis."""
    out = t.clone()
    dist.all_reduce(out, group=model_group(mesh))
    return out


def model_all_gather(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The model axis's blocks of ``t`` joined along ``dim`` in model-rank
    order (a coordinate-split vector or row block back into the whole);
    ``t`` itself off a model axis."""
    if t is None or model_size(mesh) == 1:
        return t
    w = t.contiguous()
    parts = [torch.empty_like(w) for _ in range(model_size(mesh))]
    dist.all_gather(parts, w, group=model_group(mesh))
    return torch.cat(parts, dim=dim)


def all_gather_cat(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` joined along dim 0 in rank order (a rank's
    worker or slot block back into the whole)."""
    if t is None:
        return None
    if clients_size(mesh) == 1:
        return t.clone()
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(clients_size(mesh))]
    dist.all_gather(parts, w, group=clients_group(mesh))
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def all_gather_tree(tree, mesh):
    return tree_map(lambda t: all_gather_cat(t, mesh), tree)


def broadcast_from(t: torch.Tensor, src: int, mesh) -> torch.Tensor:
    """``t`` of rank ``src`` (in the mesh's group) on every rank; ``t``
    gives the shape and dtype elsewhere."""
    if clients_size(mesh) == 1:
        return t
    group = clients_group(mesh)
    w = _wire(t)
    dist.broadcast(w, src=dist.get_global_rank(group, src), group=group)
    return w.to(torch.bool) if t.dtype == torch.bool else w


def barrier(mesh) -> None:
    """Every rank of the group (both axes of a 2-D mesh)."""
    dist.barrier()


@contextlib.contextmanager
def main_first(mesh):
    """Rank 0 runs the block first, the others after it (a dataset cache
    written on first use is then read, never raced); no-op off a mesh."""
    late = mesh is not None and dist.get_rank() != 0
    if late:
        barrier(mesh)
    yield
    if mesh is not None and not late:
        barrier(mesh)


def any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of the group (one host read)."""
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def route_rows(owned, ids: Sequence[int], num_rows: int, mesh,
               wslice: slice):
    """Client rows from their owners to the ranks that run them.

    ``owned`` is a ``ClientState`` of W-slot encoded rows in which this
    rank has filled the slots whose client it owns (``row_block``);
    ``ids`` the W sampled ids on the host (an out-of-range id, a padded
    slot, counts as its clamped owner's). Each owner broadcasts its slots
    in one tensor a leaf, so the rows cross exactly, with no arithmetic.
    Returns the rows of this rank's ``wslice``."""
    N = clients_size(mesh)
    per = num_rows // N
    owner = [min(max(int(c), 0), num_rows - 1) // per for c in ids]
    by_owner = [[w for w, o in enumerate(owner) if o == src]
                for src in range(N)]
    me = clients_rank(mesh)

    def route(leaf):
        out = torch.empty_like(leaf)
        for src, slots in enumerate(by_owner):
            if not slots:
                continue
            idx = torch.tensor(slots, device=leaf.device)
            buf = (leaf[idx] if src == me else
                   torch.empty((len(slots),) + tuple(leaf.shape[1:]),
                               dtype=leaf.dtype, device=leaf.device))
            out[idx] = broadcast_from(buf, src, mesh)
        return out[wslice]
    return type(owned)(*(
        None if getattr(owned, f.name) is None
        else tree_map(route, getattr(owned, f.name))
        for f in dataclasses.fields(owned)))


def local_row_ids(ids: torch.Tensor, num_rows: int, mesh) -> torch.Tensor:
    """Global client ids -> indices into this rank's row block, whose
    sink is its last row (``per``): ids outside the block (other owners',
    the global sink ``num_rows``) go to the sink."""
    lo, hi = row_block(num_rows, mesh)
    inside = (ids >= lo) & (ids < hi)
    return torch.where(inside, ids - lo, hi - lo)
