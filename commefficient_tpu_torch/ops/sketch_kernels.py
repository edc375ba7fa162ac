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
``CountSketch.kernel_tables`` builds once a per-row CSR of block ids
grouped by window in ascending order; the kernel (``csrc/sketch.cu``)
runs one 128-thread CTA per (row, window), lane l accumulating
``x[b*128 + (l ^ m_b)] * sign(b*128 + (l ^ m_b))`` over the window's
blocks in that order from 0.0, and writes each table cell once. The signs
are ±1, so FMA contraction cannot change a sum. Bound: bytes (the vector
read once, the table written once: 26.3 MB + 10.0 MB at d=6,568,640,
5 x 500,096), about 18 integer/float operations per (row, coordinate) of
hashing on top. The batched kernel is the same template with a third grid
axis over tiles of 8 batch rows: a CTA hashes each of its window's blocks
once and adds it into one register accumulator per batch row, so each
row's table is bitwise the unbatched kernel's and the hashing is paid
once for all rows (B·(4n + 4·r·c_eff) bytes against ~18·r·n + B·r·n
operations: bytes-bound at B = 4 and 8).

``estimates`` replaces ``_estimates_kernel`` (via ``estimates_pallas``,
its unbatched grid; the batched grid serves the sketched client codec,
not ported). One 256-thread CTA per 8,192-coordinate tile hashes its 64
blocks once into shared memory, then computes each coordinate's r window
reads, un-permute, sign and median in registers (``csrc/estimates.cu``,
the same ``cs::estimate`` the fused top-k kernels use). There are no
sums, so it is bitwise its plain version, ``CountSketch.estimates``.
Bound: the table read once and the (d,) vector written once (10.0 MB +
26.3 MB), against ~100 operations per coordinate at r=5.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops.countsketch import LANES, CountSketch

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"sketch_launch": [_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _I,
                                 _P, _P]}
_EST_SIGNATURES = {"estimates_launch": [_P, _LL, _I, _I, _P, _P, _P]}


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
    idx = blk[:, None] * LANES + lanes[None, :]
    for row in range(cs.r):
        base, lanemask = cs._block_hashes(row, blk)
        signed = vp * cs._row_signs(row, idx)
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
    one launch of the kernel, counted under ``key``."""
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
        tabs.win_blocks.data_ptr(), tabs.coeffs.data_ptr(), cs.r,
        cs.nwindows, cs.nblocks, out.data_ptr(),
        cuda_lib.stream_ptr(vecs.device))
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
    launch.

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


def estimates(cs: CountSketch, table: torch.Tensor) -> torch.Tensor:
    """(d,) median-of-rows estimates of every coordinate of ``table``.

    A CPU table takes the plain version; a CUDA table launches the kernel
    or raises."""
    if table.device.type == "cpu":
        return estimates_plain(cs, table)
    if table.device.type != "cuda":
        raise ValueError(f"estimates: unsupported device {table.device}")
    if table.dtype != torch.float32 or tuple(table.shape) != (
            cs.r, cs.c_eff) or not table.is_contiguous():
        raise ValueError("estimates kernel takes a contiguous float32 "
                         f"({cs.r}, {cs.c_eff}) table, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if cs.r not in (1, 3, 5):
        raise NotImplementedError("estimates kernel has median networks "
                                  f"for r in (1, 3, 5), not r={cs.r}")
    tabs = cs.kernel_tables(table.device)
    out = torch.empty(cs.d, dtype=torch.float32, device=table.device)
    lib = cuda_lib.load("estimates", _EST_SIGNATURES)
    err = lib.estimates_launch(table.data_ptr(), cs.d, cs.r, cs.nwindows,
                               tabs.coeffs.data_ptr(), out.data_ptr(),
                               cuda_lib.stream_ptr(table.device))
    cuda_lib.check(err, "estimates")
    cuda_lib.LAUNCHES["estimates"] += 1
    return out
