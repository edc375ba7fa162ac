"""Dense CountSketch scatter and estimates: CUDA kernels for Hopper +
their plain versions.

``sketch_vec`` replaces ``commefficient_tpu/ops/sketch_kernels.py::
_sketch_kernel`` in its 1-D grid (via ``sketch_vec_pallas``; the
sketch-after-aggregate round reaches it at batch 1), ``sketch_vec_batched``
the same kernel's batched 2-D grid (``batched_call``; the per-worker
sketch of clipping and DP reaches it with the round's W clients). The TPU
kernel keeps the whole (r, c_eff) table in VMEM and relies on its
sequential grid: each window adds its blocks in ascending block order,
with no atomics.

Hopper has no sequential grid, and float atomics would change the sum
order from run to run and break the bit-identity with the reference. A
block's window is a pure function of (seed, row, block), so
``CountSketch.kernel_tables`` builds once per row the block ids grouped by
window in ascending order, each packed with its lane mask. The kernel
(``csrc/sketch.cu``) gives each (row, window) a warp, lane j accumulating
cells j + 32 q as ``x[b*128 + (l ^ m_b)] * sign(b*128 + (l ^ m_b))`` over
the window's blocks in that order from 0.0, four blocks' loads in flight
at a time, and writes each table cell once. The signs are ±1, so FMA
contraction cannot change a sum. A batch runs as one launch per row from
the C entry, one call counted once: each row's table is bitwise the
unbatched kernel's. Bound: bytes at
d=6,568,640 (the vector read once, the table written once: 26.3 MB + 10.0
MB, 5 x 500,096), operations at d=124,051,201 (about 16 integer and float
operations per (row, coordinate) of hashing).

``estimates`` replaces ``_estimates_kernel`` in its unbatched grid (via
``estimates_pallas``), ``estimates_batched`` the same kernel's batched 2-D
grid (``batched_call``), which the reference's ``--server_fused off``
reaches at batch 1 through ``CountSketch.estimates_batched``. One C entry
serves both (``csrc/estimates.cu``): one 256-thread CTA per
(8,192-coordinate tile, tile of up to 8 tables) hashes its 64 blocks once
into shared memory, then takes each thread's coordinates four at a time:
their r window columns and signs once and, per table, the 4 r window reads
issued together, the signs and the median network on order-preserving
integer keys (``cs::median``, which the fused top-k kernels' estimate
shares). There are no sums, so each table's estimates are bitwise its
plain version, ``CountSketch.estimates``, whatever B. Bound: each table
read once and each (d,) vector written once (10.0 MB + 26.3 MB a table at
d=6,568,640), against ~100 operations per coordinate at r=5, paid once
for all tables.

``segment_sum`` is no port of a TPU kernel: it is the deterministic sum
behind ``CountSketch.sketch_sparse`` (``csrc/segment_sum.cu``), where the
reference has XLA's ``segment_sum``. Given stably sorted keys, it adds
each run of equal keys in position order, so on the card it is bitwise
its plain version, ``index_add_`` on the CPU, in every run.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops.countsketch import LANES, CountSketch

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"sketch_launch": [_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _I,
                                 _P, _P]}
_EST_SIGNATURES = {"estimates_launch": [_P, _I, _LL, _I, _I, _P, _P, _P]}
_SEGMENT_SIGNATURES = {"segment_sum_launch": [_P, _P, _LL, _P, _P]}


def sketch_vec_plain(cs: CountSketch, vec: torch.Tensor,
                     block_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same per-window sums in the
    same ascending block order, one block per window per step."""
    dev = vec.device
    table = cs.zero_table(dev)
    n = vec.shape[0]
    if n == 0:
        return table
    nb = -(-n // LANES)
    vp = torch.zeros(nb * LANES, dtype=torch.float32, device=dev)
    vp[:n] = vec
    vp = vp.view(nb, LANES)
    lanes = torch.arange(LANES, dtype=torch.int64, device=dev)
    blk = block_offset + torch.arange(nb, dtype=torch.int64, device=dev)
    for row in range(cs.r):
        base, lanemask = cs._block_hashes(row, blk)
        signed = vp * cs.block_signs(row, block_offset, nb, dev)
        win = signed.gather(1, lanes[None, :] ^ lanemask[:, None])
        # rank of each block within its window, in ascending block order
        order = torch.argsort(base, stable=True)
        counts = torch.bincount(base, minlength=cs.nwindows)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(order)
        rank[order] = torch.arange(nb, device=dev) - starts[base[order]]
        tab = table[row].view(cs.nwindows, LANES)
        for j in range(int(rank.max()) + 1):
            sel = torch.nonzero(rank == j).flatten()
            tab[base[sel]] += win[sel]
    return table


def _check_range(cs: CountSketch, n: int, block_offset: int) -> None:
    if block_offset < 0 or block_offset * LANES + n > cs.d:
        raise ValueError(f"blocks from {block_offset} of length {n} lie "
                         f"outside the sketch's [0, {cs.d})")


def _launch(cs: CountSketch, vecs: torch.Tensor, block_offset: int,
            key: str) -> torch.Tensor:
    """(B, r, c_eff) tables of a contiguous (B, n) float32 CUDA batch, in
    one call of the kernel's C entry (a launch per row), counted once
    under ``key``."""
    if vecs.device.type != "cuda":
        raise ValueError(f"{key}: unsupported device {vecs.device}")
    if vecs.dtype != torch.float32 or not vecs.is_contiguous():
        raise ValueError(f"{key} kernel takes a contiguous float32 input, "
                         f"got {vecs.dtype} {tuple(vecs.shape)}")
    B, n = vecs.shape
    if B == 0 or n == 0:
        return torch.zeros((B, cs.r, cs.c_eff), dtype=torch.float32,
                           device=vecs.device)
    tabs = cs.kernel_tables(vecs.device)
    out = torch.empty((B, cs.r, cs.c_eff), dtype=torch.float32,
                      device=vecs.device)
    lib = cuda_lib.load("sketch", _SIGNATURES)
    err = lib.sketch_launch(
        vecs.data_ptr(), B, n, block_offset, tabs.win_ptr.data_ptr(),
        tabs.packed.data_ptr(), tabs.coeffs.data_ptr(), cs.r, cs.nwindows,
        cs.nblocks, out.data_ptr(), cuda_lib.stream_ptr(vecs.device))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return out


def sketch_vec(cs: CountSketch, vec: torch.Tensor,
               block_offset: int = 0) -> torch.Tensor:
    """(r, c_eff) table of ``vec`` placed at block ``block_offset``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    _check_range(cs, vec.shape[-1], block_offset)
    if vec.device.type == "cpu":
        return sketch_vec_plain(cs, vec, block_offset)
    if vec.dim() != 1:
        raise ValueError(f"sketch_vec takes a 1-D vector, got "
                         f"{tuple(vec.shape)}")
    return _launch(cs, vec[None], block_offset, "sketch")[0]


def sketch_vec_batched_plain(cs: CountSketch, vecs: torch.Tensor,
                             block_offset: int = 0) -> torch.Tensor:
    """Plain version of ``sketch_vec_batched``: ``sketch_vec_plain`` per
    row, stacked."""
    if vecs.shape[0] == 0:
        return vecs.new_zeros((0, cs.r, cs.c_eff))
    return torch.stack([sketch_vec_plain(cs, v, block_offset)
                        for v in vecs])


def sketch_vec_batched(cs: CountSketch, vecs: torch.Tensor,
                       block_offset: int = 0) -> torch.Tensor:
    """(B, r, c_eff) tables of the B rows of ``vecs`` (B, n), each placed
    at block ``block_offset``: per row bitwise ``sketch_vec``, in one
    call.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    _check_range(cs, vecs.shape[-1], block_offset)
    if vecs.device.type == "cpu":
        return sketch_vec_batched_plain(cs, vecs, block_offset)
    if vecs.dim() != 2:
        raise ValueError(f"sketch_vec_batched takes a 2-D batch, got "
                         f"{tuple(vecs.shape)}")
    return _launch(cs, vecs, block_offset, "sketch_batched")


def estimates_plain(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """Plain version of ``estimates``: ``CountSketch.estimates``."""
    return cs.estimates(table)


def estimates_batched_plain(cs: CountSketch,
                            tables: torch.Tensor) -> torch.Tensor:
    """Plain version of ``estimates_batched``: ``CountSketch.estimates``
    per table, stacked."""
    if tables.shape[0] == 0:
        return tables.new_zeros((0, cs.d))
    return torch.stack([cs.estimates(t) for t in tables])


def _launch_estimates(cs: CountSketch, tables: torch.Tensor,
                      key: str) -> torch.Tensor:
    """(B, d) estimates of a (B, r, c_eff) stack of CUDA tables in one
    launch of the kernel, counted under ``key``."""
    if tables.device.type != "cuda":
        raise ValueError(f"{key}: unsupported device {tables.device}")
    if tables.dtype != torch.float32 or tuple(tables.shape[1:]) != (
            cs.r, cs.c_eff) or not tables.is_contiguous():
        raise ValueError(f"{key} kernel takes contiguous float32 ({cs.r}, "
                         f"{cs.c_eff}) tables, got {tables.dtype} "
                         f"{tuple(tables.shape)}")
    if cs.r not in (1, 3, 5):
        raise NotImplementedError("estimates kernel has median networks "
                                  f"for r in (1, 3, 5), not r={cs.r}")
    B = tables.shape[0]
    out = torch.empty((B, cs.d), dtype=torch.float32, device=tables.device)
    if B == 0:
        return out
    tabs = cs.kernel_tables(tables.device)
    lib = cuda_lib.load("estimates", _EST_SIGNATURES)
    err = lib.estimates_launch(tables.data_ptr(), B, cs.d, cs.r,
                               cs.nwindows, tabs.coeffs.data_ptr(),
                               out.data_ptr(),
                               cuda_lib.stream_ptr(tables.device))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return out


def estimates(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """(d,) median-of-rows estimates of every coordinate of ``table``.

    A CPU table takes the plain version; a CUDA table launches the kernel
    or raises."""
    if table.device.type == "cpu":
        return estimates_plain(cs, table)
    if table.dim() != 2:
        raise ValueError(f"estimates takes one (r, c_eff) table, got "
                         f"{tuple(table.shape)}")
    return _launch_estimates(cs, table[None], "estimates")[0]


def estimates_batched(cs: CountSketch, tables: torch.Tensor) -> torch.Tensor:
    """(B, d) estimates of the B tables of ``tables`` (B, r, c_eff): per
    table bitwise ``estimates``, in one launch.

    A CPU stack takes the plain version; a CUDA stack launches the kernel
    or raises."""
    if tables.device.type == "cpu":
        return estimates_batched_plain(cs, tables)
    if tables.dim() != 3:
        raise ValueError(f"estimates_batched takes a (B, r, c_eff) stack, "
                         f"got {tuple(tables.shape)}")
    return _launch_estimates(cs, tables, "estimates_batched")


def segment_sum_plain(out: torch.Tensor, keys: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """``out[keys[i]] += vals[i]`` in the order of i: ``index_add_``, which
    on the CPU adds in update order."""
    return out.index_add_(0, keys, vals)


def segment_sum(out: torch.Tensor, keys: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``out[keys[i]] += vals[i]`` for stably sorted int64 ``keys``, each
    run of equal keys added in position order, in place. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if out.device.type == "cpu":
        return segment_sum_plain(out, keys, vals)
    if out.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {out.device}")
    if (out.dtype != torch.float32 or out.dim() != 1
            or not out.is_contiguous() or keys.dtype != torch.int64
            or vals.dtype != torch.float32 or keys.shape != vals.shape
            or keys.dim() != 1 or keys.device != out.device
            or vals.device != out.device):
        raise ValueError("segment_sum takes a contiguous 1-D float32 out "
                         "and (n,) int64 keys and float32 values on its "
                         "device")
    keys, vals = keys.contiguous(), vals.contiguous()
    lib = cuda_lib.load("segment_sum", _SEGMENT_SIGNATURES)
    err = lib.segment_sum_launch(keys.data_ptr(), vals.data_ptr(),
                                 keys.shape[0], out.data_ptr(),
                                 cuda_lib.stream_ptr(out.device))
    cuda_lib.check(err, "segment_sum")
    cuda_lib.LAUNCHES["segment_sum"] += 1
    return out
