"""Per-client state storage: the representation and placement axes (port
of ``commefficient_tpu/federated/client_store.py``).

Representation (``--client_state``, a row codec): how one client's
``(d,)`` row is stored.

* ``dense``: the row itself.
* ``sparse``: ``cap = k`` index/value pairs, the ``cap`` largest |x| in
  descending |x|, ties to the lower index (the reference's ``lax.top_k``
  on ``|x|``). Exact whenever the row has at most ``cap`` nonzeros, which
  a local_topk residual row has when ``k >= d/2``; below that it keeps the
  largest magnitudes ("sparsified memory"). The ranking is by |x|, not by
  the ``x*x`` bits the radix top-k kernels rank by: squares tie or
  underflow where magnitudes differ. No TPU kernel computes this encode,
  so it is a stable descending sort, one row at a time.
* ``sketched``: a per-client ``(r, c)`` global CountSketch of the error
  row; decode recovers its top-k (``ops/countsketch.py``).

Rows cross the round boundary through the codec: ``gather_rows``
decodes the sampled rows, ``scatter_rows`` encodes the round's rows and
writes them back, so the round's arithmetic sees dense ``(W, d)`` rows
whatever the representation.

The reference scatters with ``mode="drop"``: the slots of padded workers
and of a guarded round carry the out-of-bounds id ``num_clients`` and
write nothing. On CUDA, dropping them by a boolean filter would sync with
the host, and growing the rows by one for the scatter would copy the
whole array every round. So every codec's storage keeps one sink row,
``(num_clients + 1, ...)``: the dropped slots write there, the sink is
never gathered (sampled ids are real clients), and the scatter is an
in-place ``index_put_`` with no host sync.

Placement (``--client_state_offload``): a ``HostArenaStore`` keeps every
client's encoded row in host memory (pageable CPU tensors, block
partitioned into shards as the reference's mesh would own them), and
``federated/api.HostOffloadPipeline`` moves only the sampled rows. The
reference runs its dense and sparse codecs on the host there, only to
keep one compiled program; the port is eager, so every codec runs on the
device: the arena ships ``(W, cap)`` pairs and the round decodes them
into ``(W, d)`` zeros on the card and encodes its output there. A
host-side ``np.argsort`` of a 124M-wide row takes seconds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from commefficient_tpu_torch.config import FedConfig
from commefficient_tpu_torch.federated.state import (CLIENT_STATE_FIELDS,
                                                     ClientState)

# --------------------------------------------------------------------------
# Row codecs (the representation axis)
# --------------------------------------------------------------------------


class DenseCodec:
    """Identity codec: a row is stored as itself."""

    name = "dense"

    def __init__(self, d: int):
        self.d = int(d)

    def encode_rows(self, rows: torch.Tensor) -> torch.Tensor:
        return rows

    def decode_rows(self, enc: torch.Tensor) -> torch.Tensor:
        return enc

    def init_rows(self, n: int, fill: Optional[torch.Tensor] = None,
                  device="cpu"):
        """``n`` rows of zeros, or of ``fill`` (``--topk_down``'s initial
        weights)."""
        if fill is None:
            return torch.zeros((n, self.d), dtype=torch.float32,
                               device=device)
        return fill.to(device=device, dtype=torch.float32).expand(
            (n, self.d)).clone()

    def row_floats(self) -> int:
        return self.d


class SparseCodec:
    """``(cap,)`` index/value pairs per row, largest-|value| truncation:
    ``{"idx": int32, "val": float32}``."""

    name = "sparse"

    def __init__(self, d: int, cap: int):
        self.d = int(d)
        self.cap = int(min(cap, d))
        if self.cap < 1:
            raise ValueError(f"sparse codec needs cap >= 1, got {cap}")

    def encode_rows(self, rows: torch.Tensor) -> dict:
        # one row at a time: a stable descending sort of a (4, 124M)
        # batch would hold its int64 indices for every row at once
        idx = torch.stack([
            torch.sort(torch.abs(row), descending=True,
                       stable=True).indices[:self.cap] for row in rows])
        val = torch.gather(rows, 1, idx)
        return {"idx": idx.to(torch.int32), "val": val}

    def decode_rows(self, enc: dict) -> torch.Tensor:
        idx, val = enc["idx"], enc["val"]
        out = torch.zeros((idx.shape[0], self.d), dtype=val.dtype,
                          device=val.device)
        # a row's indices are distinct; the initial rows repeat index 0
        # with value 0.0, which any write order leaves at 0.0
        return out.scatter_(1, idx.long(), val)

    def init_rows(self, n: int, fill=None, device="cpu"):
        if fill is not None:
            raise ValueError("sparse codec cannot seed non-zero rows")
        return {"idx": torch.zeros((n, self.cap), dtype=torch.int32,
                                   device=device),
                "val": torch.zeros((n, self.cap), dtype=torch.float32,
                                   device=device)}

    def row_floats(self) -> int:
        return 2 * self.cap


class SketchedCodec:
    """Per-client ``(r, c)`` global CountSketch of the error row: encode
    is the sketch of every row (``segment_sum``), decode the top-k of the
    estimates (the per-row radix kernels, all W rows a launch)."""

    name = "sketched"

    def __init__(self, d: int, r: int, c: int, k: int, seed: int):
        from commefficient_tpu_torch.ops.countsketch import CountSketch
        self.cs = CountSketch(d=int(d), c=int(c), r=int(r),
                              seed=int(seed) ^ 0xC11E57, scheme="global")
        self.d = int(d)
        self.k = int(min(k, d))

    def encode_rows(self, rows: torch.Tensor) -> dict:
        return {"table": self.cs.sketch_rows(rows)}

    def decode_rows(self, enc: dict) -> torch.Tensor:
        from commefficient_tpu_torch.ops.topk import topk
        return topk(self.cs.estimates_rows(enc["table"]), self.k)

    def init_rows(self, n: int, fill=None, device="cpu"):
        if fill is not None:
            raise ValueError("sketched codec cannot seed non-zero rows")
        return {"table": torch.zeros((n, self.cs.r, self.cs.c_eff),
                                     dtype=torch.float32, device=device)}

    def row_floats(self) -> int:
        return self.cs.r * self.cs.c_eff


def make_codec(cfg: FedConfig):
    """The run's row codec (``--client_state``); ``cfg`` finalized."""
    d = cfg.grad_dim
    if cfg.client_state == "dense":
        return DenseCodec(d)
    if cfg.client_state == "sparse":
        return SparseCodec(d, cap=cfg.k)
    if cfg.client_state == "sketched":
        return SketchedCodec(d, r=cfg.client_sketch_rows,
                             c=cfg.client_sketch_cols, k=cfg.k,
                             seed=cfg.seed)
    raise ValueError(f"unknown client_state {cfg.client_state!r}")


# --------------------------------------------------------------------------
# The gather/scatter contract (device placement)
# --------------------------------------------------------------------------


def gather_rows(storage, ids: torch.Tensor, codec):
    """Encoded storage + sampled ids -> dense ``(W, d)`` rows (for the
    dense codec a copy of ``storage[ids]``)."""
    if storage is None:
        return None
    return codec.decode_rows(tree_map(lambda a: a[ids], storage))


def scatter_rows(storage, ids: torch.Tensor, dense_rows, codec):
    """Encode dense ``(W, d)`` rows and write them at ``ids`` in place; an
    id of ``num_clients`` (padded or guarded slot) lands in the sink row.
    Returns the storage."""
    if storage is None or dense_rows is None:
        return storage
    enc = codec.encode_rows(dense_rows)
    tree_map(lambda s, e: s.index_put_((ids,), e), storage, enc)
    return storage


def select_rows(keep: torch.Tensor, new_enc, old_enc):
    """Slot freeze on encoded rows: slot w keeps its input encoding
    bitwise where ``keep[w]`` is False (never a re-encode of its
    decode)."""
    def sel(n, o):
        return torch.where(keep.view((-1,) + (1,) * (n.dim() - 1)), n, o)
    return tree_map(sel, new_enc, old_enc)


def init_client_storage(cfg: FedConfig, codec, flat_weights: torch.Tensor,
                        num_rows: Optional[int] = None,
                        block: Optional[tuple] = None) -> ClientState:
    """Encoded rows for every field the mode keeps, plus the sink row, on
    ``flat_weights``' device: zero velocities and errors, and
    ``--topk_down``'s stale weights at the initial weights (reference
    ``client_store.py:342``). ``num_rows``: the clients held (a mesh
    rank's row block; all of them by default). ``block``: the ``(lo,
    hi)`` coordinates of the dense codec's rows a model-axis rank stores
    (the O(k) encodings stay whole)."""
    n = (cfg.num_clients if num_rows is None else num_rows) + 1
    dev = flat_weights.device
    if block is not None and isinstance(codec, DenseCodec) \
            and tuple(block) != (0, codec.d):
        lo, hi = block
        codec = DenseCodec(hi - lo)
        flat_weights = flat_weights[lo:hi]
    return ClientState(
        velocities=(codec.init_rows(n, device=dev)
                    if cfg.needs_velocity_state else None),
        errors=(codec.init_rows(n, device=dev)
                if cfg.needs_error_state else None),
        weights=(codec.init_rows(n, fill=flat_weights, device=dev)
                 if cfg.needs_client_weights else None))


# --------------------------------------------------------------------------
# Host arenas (the placement axis, --client_state_offload)
# --------------------------------------------------------------------------


class _ArenaView:
    """Per-client row view over one field's arenas: ``view[i]``,
    ``view[i] = row``, ``len`` and iteration, as the reference's."""

    def __init__(self, store: "HostArenaStore", field: str):
        self._store = store
        self._field = field

    def __len__(self):
        return self._store.num_rows

    def __getitem__(self, i):
        return self._store.row(self._field, i)

    def __setitem__(self, i, row):
        self._store.set_row(self._field, i, row)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class HostArenaStore:
    """Host arenas of encoded per-client rows.

    The row space [0, num_rows) is block-partitioned into ``num_shards``
    contiguous shards, ``owner(cid) = cid // rows_per_shard``, the block
    layout in which a mesh's ``clients`` axis would own the rows; each
    shard's arena is one contiguous pageable CPU tensor per encoded leaf.
    ``shard_reads``/``shard_writes`` count the row traffic of each shard.
    Memory: ``num_rows * codec.row_floats() * 4`` bytes.

    On a mesh each rank's store holds its own shard only (``local_shard``
    = its ``clients`` rank, ``num_shards`` = the axis size): ``owns(cid)``
    says whether a row is here, and another shard's row raises. The
    rows cross ranks in the round (``parallel/mesh.route_rows``).

    ``coord_block``: on a ``model`` mesh axis, the ``(lo, hi)``
    coordinates of each dense row this rank's arenas hold (``codec`` is
    then a ``DenseCodec`` of that width): ``assign`` takes whole rows and
    keeps the block, ``stacked`` gives the block."""

    def __init__(self, cfg: FedConfig, codec, flat_weights=None,
                 num_shards: int = 1, local_shard: Optional[int] = None,
                 coord_block: Optional[tuple] = None):
        n = int(cfg.num_clients)
        if num_shards < 1 or n % num_shards:
            raise ValueError(
                f"num_clients ({n}) must be divisible by num_shards "
                f"({num_shards})")
        self.codec = codec
        self.num_rows = n
        self.num_shards = int(num_shards)
        self.rows_per_shard = n // self.num_shards
        self.shard_reads = np.zeros(self.num_shards, np.int64)
        self.shard_writes = np.zeros(self.num_shards, np.int64)
        fill = (None if flat_weights is None
                else torch.as_tensor(flat_weights, dtype=torch.float32,
                                     device="cpu"))

        self.local_shard = local_shard
        self.coord_block = None if coord_block is None else tuple(coord_block)

        def alloc(fill=None):
            return [codec.init_rows(self.rows_per_shard, fill=fill)
                    if self._holds(s) else None
                    for s in range(self.num_shards)]

        self._arenas = {
            "velocities": alloc() if cfg.needs_velocity_state else None,
            "errors": alloc() if cfg.needs_error_state else None,
            "weights": alloc(fill=fill)
            if cfg.needs_client_weights else None,
        }
        assert set(self._arenas) == set(CLIENT_STATE_FIELDS)

    def _holds(self, shard: int) -> bool:
        return self.local_shard is None or shard == self.local_shard

    def owner(self, cid: int) -> int:
        """The shard owning client ``cid``'s row."""
        return int(cid) // self.rows_per_shard

    def owns(self, cid: int) -> bool:
        """Whether client ``cid``'s row is in this store."""
        return 0 <= int(cid) < self.num_rows and self._holds(self.owner(cid))

    def _locate(self, cid: int):
        cid = int(cid)
        if not 0 <= cid < self.num_rows:
            raise IndexError(f"client id {cid} out of range "
                             f"[0, {self.num_rows})")
        s = cid // self.rows_per_shard
        if not self._holds(s):
            raise IndexError(f"client {cid}'s row lives on shard {s}, "
                             f"this store holds shard {self.local_shard}")
        return s, cid - s * self.rows_per_shard

    def view(self, field: str) -> Optional[_ArenaView]:
        return None if self._arenas[field] is None \
            else _ArenaView(self, field)

    def row(self, field: str, cid: int):
        """Client ``cid``'s encoded row (views of the arena)."""
        s, local = self._locate(cid)
        self.shard_reads[s] += 1
        return tree_map(lambda a: a[local], self._arenas[field][s])

    def set_row(self, field: str, cid: int, row) -> None:
        s, local = self._locate(cid)
        self.shard_writes[s] += 1

        def assign(a, r):
            a[local] = r if torch.is_tensor(r) else torch.from_numpy(
                np.asarray(r))
            return a
        tree_map(assign, self._arenas[field][s], row)

    def arena(self, field: str):
        """The first held shard's arena of ``field``: its leaves give the
        encoded rows' shapes and dtypes."""
        return next(a for a in self._arenas[field] if a is not None)

    def stacked(self, field: str):
        """The held clients' encoded rows of ``field``, (rows, ...) leaves
        (the held shards joined in row order; a copy)."""
        shards = [a for a in self._arenas[field] if a is not None]
        return tree_map(lambda *leaves: torch.cat(leaves), *shards)

    def assign(self, field: str, rows) -> None:
        """Overwrite the held rows of ``field`` from (num_rows, ...) leaves
        of the arena's dtypes (every client's rows, whole: a
        ``coord_block`` keeps its coordinates)."""
        cols = (slice(None) if self.coord_block is None
                else slice(*self.coord_block))
        for s, shard in enumerate(self._arenas[field]):
            if shard is None:
                continue
            lo = s * self.rows_per_shard

            def put(a, r):
                a.copy_(torch.as_tensor(np.asarray(
                    r[lo:lo + self.rows_per_shard][:, cols])).to(a.dtype))
                return a
            tree_map(put, shard, rows)

    def nbytes(self) -> int:
        total = 0
        for arenas in self._arenas.values():
            if arenas is None:
                continue
            for shard in arenas:
                if shard is not None:
                    total += sum(a.nbytes for a in tree_leaves(shard))
        return total
