"""CountSketch, tiled scheme (port of ``commefficient_tpu/ops/countsketch.py``).

Coordinates are grouped into blocks of L=128; block ``b`` hashes to a
128-wide window of columns and each coordinate to a lane of that window
through a per-(row, block) XOR lane permutation:

    bucket(i) = base(i // L) * L + (i % L) ^ lanemask(i // L)

The hash family is the reference's, bit for bit: seeded cubic sign
polynomials and block hashes over uint32 with a murmur3 finalizer, the
coefficients drawn by ``_hash_coeffs`` (verbatim numpy). PyTorch has no
usable uint32 shifts and compares on the CPU, so here every hash value is
an int64 tensor holding a uint32, and every product is taken mod 2**32 by
``_mul32`` with intermediate products below 2**49 (no reliance on
signed overflow). The CUDA kernels use ``uint32_t``.

The dense sketch (``sketch_range``) goes through the hand-written kernel
of ``ops/sketch_kernels.py``, which also sketches a stack of vectors in
one launch (``sketch_vec_batched``); the fused unsketch + top-k through
``ops/topk_kernels.py``; ``--server_fused off`` through the batched
estimates kernel of ``ops/sketch_kernels.py`` at batch 1.
``CountSketch.estimates`` is plain PyTorch, the plain version the
estimate-reading kernels are held against; ``sketch_sparse`` is no TPU
kernel, and sums its collisions through ``sketch_kernels.segment_sum``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from commefficient_tpu_torch.utils.params import round_up

LANES = 128
_MASK32 = 0xFFFFFFFF
_NAN = float("nan")


def pad_cols(c: int) -> int:
    """Physical column count for the tiled scheme: c rounded up to a lane
    tile (500_000 -> 500_096)."""
    return round_up(c, LANES)


def _hash_coeffs(seed: int, r: int) -> tuple:
    rng = np.random.RandomState(seed)
    # 6 odd coefficients per row: h1..h4 for the sign polynomial, h5, h6 for
    # the bucket hash. Odd => multiplication is a bijection mod 2**32.
    coeffs = rng.randint(1, 1 << 31, size=(r, 6)).astype(np.uint32) * 2 + 1
    return tuple(tuple(int(x) for x in row) for row in coeffs)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for int64 tensors (or ints) holding uint32 values:
    ``b`` is split into 16-bit halves so no product reaches 2**49."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche finalizer over uint32 (held in int64)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's float min, which ``torch.minimum`` is not: NaN-propagating,
    and -0.0 below +0.0 (torch returns the second operand of two zeros)."""
    m = torch.where(a < b, a, b)
    m = torch.where((a == b) & torch.signbit(a), a, m)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, m)


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's float max: NaN-propagating, +0.0 above -0.0."""
    m = torch.where(a > b, a, b)
    m = torch.where((a == b) & torch.signbit(b), a, m)
    return torch.where(torch.isnan(a) | torch.isnan(b), _NAN, m)


def _median_small(rows: list) -> torch.Tensor:
    """Median across r equal-shape tensors: the reference's r=3/r=5
    min/max networks, in the same order (bitwise); other r take the
    linear-interpolation median."""
    r = len(rows)
    if r == 1:
        return rows[0]
    if r == 3:
        a, b, c = rows
        return _maximum(_minimum(a, b), _minimum(_maximum(a, b), c))
    if r == 5:
        a, b, c, d, e = rows
        f, g = _minimum(a, b), _maximum(a, b)
        h, i = _minimum(c, d), _maximum(c, d)
        j = _maximum(f, h)   # drop the smaller of the two mins
        k = _minimum(g, i)   # drop the larger of the two maxs
        return _maximum(_minimum(j, k), _minimum(_maximum(j, k), e))
    return torch.quantile(torch.stack(rows), 0.5, dim=0)


class KernelTables(NamedTuple):
    """Device-resident hash inputs of the CUDA kernels."""
    coeffs: torch.Tensor   # (r, 6) int32: the uint32 coefficient bits
    win_ptr: torch.Tensor  # (r, nwindows + 1) int32 offsets of the lists
    packed: torch.Tensor   # (r, nblocks) int32: (block << 7) | lane mask,
                           # grouped by window, ascending within each


class CountSketch:
    """Stateless CountSketch over vectors of length ``d`` into
    ``(r, c_eff)`` tables, ``c_eff`` = c rounded up to a multiple of 128."""

    def __init__(self, d: int, c: int, r: int, seed: int = 42,
                 scheme: str = "tiled"):
        if scheme != "tiled":
            raise NotImplementedError(
                f"sketch scheme {scheme!r} is not ported to PyTorch yet "
                "(ROADMAP.md A1)")
        self.d = int(d)
        self.c = int(c)
        self.r = int(r)
        self.seed = int(seed)
        self.scheme = scheme
        self.coeffs = _hash_coeffs(seed, r)
        self.nblocks = -(-self.d // LANES)
        self.d_pad = self.nblocks * LANES
        self.c_eff = pad_cols(self.c)
        self.nwindows = self.c_eff // LANES
        self._tables = {}
        self._coeff_columns = {}

    # --- hashing ----------------------------------------------------------
    # ``row=None`` hashes every row at once: the coefficients become (r, 1)
    # columns and the results (r, n), with the same integer arithmetic
    def _row_coeffs(self, row, device):
        """Row ``row``'s six hash coefficients as ints; for ``row=None``
        every row's, as (r, 1) int64 columns on ``device`` (copied there
        once)."""
        if row is not None:
            return self.coeffs[row]
        device = torch.device(device)
        if device not in self._coeff_columns:
            cols = torch.tensor(self.coeffs, dtype=torch.int64).to(device)
            self._coeff_columns[device] = tuple(cols[:, j:j + 1]
                                                for j in range(6))
        return self._coeff_columns[device]

    def _row_signs(self, row, idx: torch.Tensor) -> torch.Tensor:
        """±1 sign per coordinate id: mixed cubic polynomial, low bit."""
        h1, h2, h3, h4, _, _ = self._row_coeffs(row, idx.device)
        i = idx.to(torch.int64) & _MASK32
        acc = (_mul32(i, h1) + h2) & _MASK32
        acc = (_mul32(acc, i) + h3) & _MASK32
        acc = (_mul32(acc, i) + h4) & _MASK32
        return (1 - 2 * (_mix(acc) & 1)).to(torch.float32)

    def _block_hashes(self, row, blk: torch.Tensor):
        """(window base, 7-bit lane mask) per block id."""
        _, _, _, _, h5, h6 = self._row_coeffs(row, blk.device)
        b = blk.to(torch.int64) & _MASK32
        mb = _mix((_mul32(b, h6) + h5) & _MASK32)
        base = mb % self.nwindows
        lanemask = _mix(mb ^ h5) & (LANES - 1)
        return base, lanemask

    def _row_hashes(self, row, idx: torch.Tensor):
        """(signs, flat buckets in [0, c_eff)) for coordinate ids."""
        i = idx.to(torch.int64) & _MASK32
        base, lanemask = self._block_hashes(row, i >> 7)
        buckets = base * LANES + ((i & (LANES - 1)) ^ lanemask)
        return self._row_signs(row, i), buckets

    def kernel_tables(self, device) -> KernelTables:
        """The CUDA kernels' hash inputs on ``device``, built once: the
        coefficient bits, and per row the block ids grouped by window in
        ascending block order (the order in which the reference's
        sequential grid adds each window's blocks), each packed with its
        lane mask as ``(block << 7) | mask``: the coordinate of the block's
        lane 0 with the mask in its low bits, so that lane l reads
        coordinate ``entry ^ l``. Blocks stay below 2**25 - 1, so an entry
        fits in uint32 and the kernel's all-ones sentinel is no entry."""
        device = torch.device(device)
        if self.nblocks > 2 ** 25 - 1:
            raise ValueError(f"d = {self.d}: the kernels' packed entries "
                             "take at most 2**25 - 1 blocks (coordinates "
                             "in uint32)")
        if device not in self._tables:
            blk = torch.arange(self.nblocks, dtype=torch.int64)
            ptrs, packed = [], []
            for row in range(self.r):
                base, mask = self._block_hashes(row, blk)
                order = torch.argsort(base, stable=True)
                packed.append((order << 7) | mask[order])
                counts = torch.bincount(base, minlength=self.nwindows)
                ptrs.append(torch.cat([torch.zeros(1, dtype=torch.int64),
                                       torch.cumsum(counts, 0)]))
            coeffs = np.asarray(self.coeffs, np.uint32).view(np.int32)
            packed = torch.stack(packed)
            self._tables[device] = KernelTables(
                coeffs=torch.from_numpy(coeffs.copy()).to(device),
                win_ptr=torch.stack(ptrs).to(torch.int32).to(device),
                packed=torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                                   packed).to(torch.int32).to(device))
        return self._tables[device]

    # --- core ops ---------------------------------------------------------
    def zero_table(self, device="cpu") -> torch.Tensor:
        return torch.zeros((self.r, self.c_eff), dtype=torch.float32,
                           device=device)

    def sketch_vec(self, vec: torch.Tensor) -> torch.Tensor:
        """Sketch a length-d vector into an (r, c_eff) table."""
        return self.sketch_range(vec, 0)

    def sketch_range(self, chunk: torch.Tensor, offset: int = 0
                     ) -> torch.Tensor:
        """Sketch the slice ``vec[offset : offset+len(chunk)]`` of a
        conceptual length-d vector into a full table (hashes keyed by
        global coordinate and block ids). ``offset`` must be 128-aligned."""
        from commefficient_tpu_torch.ops.sketch_kernels import sketch_vec
        n = chunk.shape[0]
        if offset < 0 or offset + n > self.d:
            raise ValueError(f"slice [{offset}, {offset + n}) outside the "
                             f"sketch's coordinate space [0, {self.d})")
        if offset % LANES:
            raise ValueError(f"tiled sketch_range needs a {LANES}-aligned "
                             f"offset, got {offset}")
        return sketch_vec(self, chunk, block_offset=offset // LANES)

    def sketch_sparse(self, values: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
        """Sketch a k-sparse vector given (values, coordinate indices):
        ``sketch_vec`` of the dense vector up to float summation order in
        buckets where several nonzeros collide, at O(r*k).

        A bucket adds its updates from 0.0 in the order ``indices`` lists
        them, which is the reference's ``segment_sum`` order, on every
        device: the flat (row, bucket) keys are sorted stably and each run
        of equal keys is summed in position order (``segment_sum``: the
        CUDA kernel, or ``index_add_`` on the CPU). So the card's table is
        the same in every run and bitwise the CPU's. No host sync."""
        from commefficient_tpu_torch.ops.sketch_kernels import segment_sum
        signs, buckets = self._row_hashes(None, indices)
        rows = torch.arange(self.r, device=buckets.device)[:, None]
        keys = (buckets + rows * self.c_eff).flatten()
        signed = (signs * values).flatten()
        order = torch.argsort(keys, stable=True)
        table = self.zero_table(values.device)
        segment_sum(table.view(-1), keys[order], signed[order])
        return table

    def estimates(self, table: torch.Tensor) -> torch.Tensor:
        """Median-of-rows estimates of all d coordinates (plain PyTorch;
        the fused unsketch kernel computes each once, per tile, into a
        scratch)."""
        dev = table.device
        blk = torch.arange(self.nblocks, dtype=torch.int64, device=dev)
        lanes = torch.arange(LANES, dtype=torch.int64, device=dev)
        idx = blk[:, None] * LANES + lanes[None, :]
        per_row = []
        for row in range(self.r):
            base, lanemask = self._block_hashes(row, blk)
            cols = base[:, None] * LANES + (lanes[None, :] ^ lanemask[:, None])
            est = table[row][cols] * self._row_signs(row, idx)
            per_row.append(est.reshape(-1)[:self.d])
        return _median_small(per_row)

    def unsketch(self, table: torch.Tensor, k: int) -> torch.Tensor:
        """Recover the top-k coordinates (dense d-vector, zeros elsewhere)."""
        from commefficient_tpu_torch.ops.topk_kernels import unsketch_select
        masked, _ = unsketch_select(self, table, k)
        return masked

    def unsketch_values_indices(self, table: torch.Tensor, k: int,
                                fused: bool = True):
        """(values, indices) of the recovered top-k in the exact stable
        ``lax.top_k`` order. ``fused`` runs the fused unsketch + top-k
        kernels, whose compact select hands over the k survivors in index
        order, then sorts them by (-score, index) as
        ``values_indices_from_mask`` does; ``fused=False`` is the
        reference's ``--server_fused off`` chain: the batched estimates
        kernel at batch 1 (as the reference's ``estimates_batched``), then
        the stable-sort top-k."""
        from commefficient_tpu_torch.ops import topk_kernels
        if not fused:
            from commefficient_tpu_torch.ops.sketch_kernels import \
                estimates_batched
            from commefficient_tpu_torch.ops.topk import topk_values_indices
            return topk_values_indices(
                estimates_batched(self, table[None])[0], k, use_kernel=False)
        vals, idxs = topk_kernels.unsketch_compact(self, table, k)
        return topk_kernels.order_by_score(vals, idxs)

    def l2estimate(self, table: torch.Tensor) -> torch.Tensor:
        """Estimate ||vec||_2 as sqrt(median over rows of row sum-of-squares)
        of an (r, c_eff) table, or per table of a (..., r, c_eff) stack.
        The median of an even r interpolates, as ``jnp.median`` does."""
        return torch.sqrt(torch.quantile(torch.sum(table * table, dim=-1),
                                         0.5, dim=-1))
