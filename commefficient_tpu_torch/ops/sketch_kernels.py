"""Dense CountSketch scatter: CUDA kernel for Hopper + its plain version.

Replaces ``commefficient_tpu/ops/sketch_kernels.py::_sketch_kernel`` (via
``sketch_vec_pallas``; the round reaches it at batch 1 through
``sketch_vec_batched``). The TPU kernel keeps the whole (r, c_eff) table
in VMEM and relies on its sequential grid: each window adds its blocks in
ascending block order, with no atomics.

Hopper has no sequential grid, and float atomics would change the sum
order from run to run and break the bit-identity with the reference. A
block's window is a pure function of (seed, row, block), so
``CountSketch.kernel_tables`` builds once a per-row CSR of block ids
grouped by window in ascending order; the kernel (``csrc/sketch.cu``)
runs one 128-thread CTA per (row, window), lane l accumulating
``x[b*128 + (l ^ m_b)] * sign(b*128 + (l ^ m_b))`` over the window's
blocks in that order from 0.0, and writes each table cell once. The signs
are ±1, so FMA contraction cannot change a sum.

Bound: bytes (the vector read once, the table written once: 26.3 MB +
10.0 MB at d=6,568,640, 5 x 500,096), about 18 integer/float operations
per (row, coordinate) of hashing on top.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops.countsketch import LANES, CountSketch

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"sketch_launch": [_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P,
                                 _P]}


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


def sketch_vec(cs: CountSketch, vec: torch.Tensor,
               block_offset: int = 0) -> torch.Tensor:
    """(r, c_eff) table of ``vec`` placed at block ``block_offset``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if vec.device.type == "cpu":
        return sketch_vec_plain(cs, vec, block_offset)
    if vec.device.type != "cuda":
        raise ValueError(f"sketch_vec: unsupported device {vec.device}")
    if vec.dtype != torch.float32 or vec.dim() != 1 \
            or not vec.is_contiguous():
        raise ValueError("sketch_vec kernel takes a contiguous 1-D float32 "
                         f"vector, got {vec.dtype} {tuple(vec.shape)}")
    n = vec.shape[0]
    if block_offset < 0 or block_offset * LANES + n > cs.d:
        raise ValueError(f"blocks from {block_offset} of length {n} lie "
                         f"outside the sketch's [0, {cs.d})")
    if n == 0:
        return cs.zero_table(vec.device)
    tabs = cs.kernel_tables(vec.device)
    out = torch.empty((cs.r, cs.c_eff), dtype=torch.float32,
                      device=vec.device)
    lib = cuda_lib.load("sketch", _SIGNATURES)
    err = lib.sketch_launch(
        vec.data_ptr(), n, block_offset, tabs.win_ptr.data_ptr(),
        tabs.win_blocks.data_ptr(), tabs.coeffs.data_ptr(), cs.r,
        cs.nwindows, cs.nblocks, out.data_ptr(),
        cuda_lib.stream_ptr(vec.device))
    cuda_lib.check(err, "sketch")
    cuda_lib.LAUNCHES["sketch"] += 1
    return out
