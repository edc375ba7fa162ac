"""CountSketch, tiled and global schemes (port of
``commefficient_tpu/ops/countsketch.py``).

Tiled scheme (the default): coordinates are grouped into blocks of
L=128; block ``b`` hashes to a 128-wide window of columns and each
coordinate to a lane of that window through a per-(row, block) XOR lane
permutation:

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

Global scheme (``--sketch_scheme global``, and the sketched client
codec): each coordinate hashes on its own, ``bucket(i) = mix(h5 * i +
h6) mod c``, into an ``(r, c)`` table with no lane padding. No TPU kernel
serves it in the reference (its ``use_kernel`` has no effect there): the
dense sketch is XLA's ``segment_sum`` over every coordinate, the recovery
the estimates followed by the exact top-k. Here the dense sketch is
``sketch_sparse`` over every coordinate: the (row, bucket) keys of a
coordinate range are sorted stably once (the plan is kept per range and
device) and each run of equal keys is summed in coordinate order by the
``segment_sum`` kernel, the reference's order, bitwise, on both devices.
Float atomics (``index_add_`` on CUDA) would change that order from run
to run. The recovery's top-k runs the per-row radix kernels of
``ops/topk_kernels.py``. A global table has no windows, so it never
builds ``kernel_tables``.
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
    ``(r, c_eff)`` tables: ``c_eff`` = c rounded up to a multiple of 128
    for the tiled scheme, c for the global scheme."""

    def __init__(self, d: int, c: int, r: int, seed: int = 42,
                 scheme: str = "tiled"):
        if scheme not in ("tiled", "global"):
            raise ValueError(f"scheme must be 'tiled' or 'global', "
                             f"got {scheme!r}")
        self.d = int(d)
        self.c = int(c)
        self.r = int(r)
        self.seed = int(seed)
        self.scheme = scheme
        self.coeffs = _hash_coeffs(seed, r)
        if scheme == "tiled":
            self.nblocks = -(-self.d // LANES)
            self.d_pad = self.nblocks * LANES
            self.c_eff = pad_cols(self.c)
            self.nwindows = self.c_eff // LANES
        else:
            self.c_eff = self.c
        self._tables = {}
        self._coeff_columns = {}
        self._cpu_block_signs = {}
        self._plans = {}

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

    def block_signs(self, row, blk0: int, nb: int, device) -> torch.Tensor:
        """(nb, LANES) signs of the coordinates of blocks [blk0, blk0 +
        nb). On the CPU, where the plain versions run every round, they
        are computed once per row and block range (at ResNet9's d a row's
        are ~0.1 s of int64 arithmetic, and a sketch round asks for them
        several times); on the card only comparisons ask, so nothing is
        kept."""
        device = torch.device(device)
        key = (row, int(blk0), int(nb))
        if device.type == "cpu" and key in self._cpu_block_signs:
            return self._cpu_block_signs[key]
        lanes = torch.arange(LANES, dtype=torch.int64, device=device)
        blk = blk0 + torch.arange(nb, dtype=torch.int64, device=device)
        signs = self._row_signs(row, blk[:, None] * LANES + lanes[None, :])
        if device.type == "cpu":
            self._cpu_block_signs[key] = signs
        return signs

    def _block_hashes(self, row, blk: torch.Tensor):
        """(window base, 7-bit lane mask) per block id."""
        _, _, _, _, h5, h6 = self._row_coeffs(row, blk.device)
        b = blk.to(torch.int64) & _MASK32
        mb = _mix((_mul32(b, h6) + h5) & _MASK32)
        base = mb % self.nwindows
        lanemask = _mix(mb ^ h5) & (LANES - 1)
        return base, lanemask

    def _row_hashes(self, row, idx: torch.Tensor):
        """(signs, flat buckets in [0, c_eff)) for coordinate ids, under
        either scheme."""
        i = idx.to(torch.int64) & _MASK32
        if self.scheme == "global":
            _, _, _, _, h5, h6 = self._row_coeffs(row, idx.device)
            buckets = _mix((_mul32(i, h5) + h6) & _MASK32) % self.c
        else:
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
        if self.scheme != "tiled":
            raise ValueError("a global sketch has no windows: its kernels "
                             "are segment_sum and the per-row radix")
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

    def prepare(self, device):
        """Copy the hash inputs that the kernels read to a CUDA ``device``
        now (the coefficient columns and, in the tiled scheme, the window
        lists), so that the first round on it enqueues no blocking copy."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        if device.index is None:
            # the key the round's tensors look the tables up by
            device = torch.device("cuda", torch.cuda.current_device())
        self._row_coeffs(None, device)
        if self.scheme == "tiled" and self.nblocks <= 2 ** 25 - 1:
            self.kernel_tables(device)

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
        global coordinate and block ids). The tiled scheme needs a
        128-aligned ``offset``; the global scheme takes any."""
        from commefficient_tpu_torch.ops.sketch_kernels import sketch_vec
        self._check_range(chunk.shape[-1], offset)
        if self.scheme == "global":
            return self._sketch_global(chunk[None], offset)[0]
        return sketch_vec(self, chunk, block_offset=offset // LANES)

    def sketch_rows(self, vecs: torch.Tensor, offset: int = 0
                    ) -> torch.Tensor:
        """(B, r, c_eff) tables of the B rows of ``vecs`` (B, n), each the
        slice at ``offset``: the tiled scheme's batched sketch kernel in
        one call, or the global scheme's sorted plan and one
        ``segment_sum`` over every row."""
        from commefficient_tpu_torch.ops.sketch_kernels import \
            sketch_vec_batched
        self._check_range(vecs.shape[-1], offset)
        if self.scheme == "global":
            return self._sketch_global(vecs, offset)
        return sketch_vec_batched(self, vecs, block_offset=offset // LANES)

    def _check_range(self, n: int, offset: int) -> None:
        if offset < 0 or offset + n > self.d:
            raise ValueError(f"slice [{offset}, {offset + n}) outside the "
                             f"sketch's coordinate space [0, {self.d})")
        if self.scheme == "tiled" and offset % LANES:
            raise ValueError(f"tiled sketch_range needs a {LANES}-aligned "
                             f"offset, got {offset}")

    def _dense_plan(self, offset: int, n: int, device):
        """The global dense sketch of coordinates [offset, offset + n):
        the flat (row, bucket) keys sorted stably, the coordinate and the
        sign at each sorted position. Built once per (offset, n, device):
        20 bytes a (row, coordinate)."""
        key = (int(offset), int(n), torch.device(device))
        if key not in self._plans:
            idx = torch.arange(offset, offset + n, device=device)
            signs, buckets = self._row_hashes(None, idx)
            rows = torch.arange(self.r, device=device)[:, None]
            keys, order = torch.sort((buckets + rows * self.c).flatten(),
                                     stable=True)
            self._plans[key] = (keys, order % n, signs.flatten()[order])
        return self._plans[key]

    def _sketch_global(self, vecs: torch.Tensor, offset: int
                       ) -> torch.Tensor:
        from commefficient_tpu_torch.ops.sketch_kernels import segment_sum
        B, n = vecs.shape
        keys, coord, signs = self._dense_plan(offset, n, vecs.device)
        vals = (vecs[:, coord] * signs).flatten()
        if B > 1:
            # each row's table takes its own r * c keys, in row order
            keys = (keys + torch.arange(B, device=vecs.device)[:, None]
                    * (self.r * self.c)).flatten()
        out = torch.zeros(B * self.r * self.c, dtype=torch.float32,
                          device=vecs.device)
        segment_sum(out, keys, vals)
        return out.view(B, self.r, self.c)

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
        if self.scheme == "global":
            return self.estimates_rows(table[None])[0]
        dev = table.device
        blk = torch.arange(self.nblocks, dtype=torch.int64, device=dev)
        lanes = torch.arange(LANES, dtype=torch.int64, device=dev)
        per_row = []
        for row in range(self.r):
            base, lanemask = self._block_hashes(row, blk)
            cols = base[:, None] * LANES + (lanes[None, :] ^ lanemask[:, None])
            est = table[row][cols] * self.block_signs(row, 0, self.nblocks,
                                                      dev)
            per_row.append(est.reshape(-1)[:self.d])
        return _median_small(per_row)

    def estimates_rows(self, tables: torch.Tensor) -> torch.Tensor:
        """(B, d) estimates of a (B, r, c) stack of global tables, the
        hashes computed once for all B (the reference's ``table[row,
        buckets] * signs`` and median, per table)."""
        if self.scheme != "global":
            raise ValueError("estimates_rows reads global tables")
        idx = torch.arange(self.d, device=tables.device)
        signs, buckets = self._row_hashes(None, idx)
        return _median_small([tables[:, row][:, buckets[row]] * signs[row]
                              for row in range(self.r)])

    def unsketch(self, table: torch.Tensor, k: int) -> torch.Tensor:
        """Recover the top-k coordinates (dense d-vector, zeros elsewhere)."""
        if self.scheme == "global":
            from commefficient_tpu_torch.ops.topk import topk
            return topk(self.estimates(table), k)
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
        if self.scheme == "global":
            # no fused kernel: the estimates, then the exact top-k (the
            # per-row radix at B = 1, or the stable sort when not fused)
            from commefficient_tpu_torch.ops.topk import topk_values_indices
            return topk_values_indices(self.estimates(table), k,
                                       use_kernel=None if fused else False)
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
