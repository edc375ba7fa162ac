"""Fused unsketch + exact top-k: CUDA kernels for Hopper + plain versions.

Replaces two kernels of ``commefficient_tpu/ops/topk_kernels.py`` in
their ``est`` source, the one the sketch-mode server runs
(``unsketch_select_pallas``):

* ``_count_kernel`` — counts of score bits ``>=`` each of 16 int32
  candidates, where a coordinate's score is ``e*e`` of its CountSketch
  estimate ``e`` (median over rows of the signed, un-permuted window
  reads), bitcast to int32: non-negative floats order like their bits.
  Eight 4-bit radix rounds plus one ``[t, t+1]`` count find the exact
  k-th largest score ``t`` and ``n_take``, the ties at ``t`` to keep.
* ``_select_kernel`` — keeps ``bits > t`` plus the first ``n_take`` ties
  in flat-index order, and writes the masked estimates and the int32
  mask. That set and its order are stable ``lax.top_k``'s.

The estimates are computed per tile in registers from the table (10 MB at
5 x 500,096, L2-resident on an H100) and never stored as a (d,) vector.
On Hopper the TPU kernel's sequential grid is gone: the count reduces
per CTA and adds into the 16 counters with integer atomics, exact in any
order; the select's cross-tile tie carry becomes per-tile tie counts, a
one-block exclusive scan, and a within-tile rank by warp ballots
(``csrc/unsketch_topk.cu``). Coordinates at or past d neither count nor
select.

Bounds: each count launch reads the table once (10.0 MB, 3.0 us at 3.35
TB/s) but recomputes r sign hashes, r gathers and the median for every
coordinate (~133 operations each at r=5), so it is bound by operations;
the select reads the table and writes 26.3 MB of values and 26.3 MB of
mask.

The radix driver is PyTorch glue on the device (``_radix_threshold``):
no value comes to the host between the rounds.
"""

from __future__ import annotations

import ctypes

import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops.countsketch import CountSketch

NIBBLES = 16                 # candidates per radix round
TILE_N = 8192                # coordinates per CTA (the TPU tiling)
_I32_MAX = 2 ** 31 - 1

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "count_launch": [_P, _LL, _I, _I, _P, _P, _P, _P],
    "select_launch": [_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _score_bits(est: torch.Tensor) -> torch.Tensor:
    return (est * est).view(torch.int32)


def _count_bits(bits: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    return torch.stack([(bits >= c).sum() for c in cands]).to(torch.int32)


def _select_est(est: torch.Tensor, t: torch.Tensor, n_take: torch.Tensor):
    bits = _score_bits(est)
    eq = bits == t
    rank = torch.cumsum(eq, 0) - eq.to(torch.int64)
    sel = (bits > t) | (eq & (rank < n_take))
    return torch.where(sel, est, 0.0), sel.to(torch.int32)


def count_plain(cs: CountSketch, table: torch.Tensor,
                cands: torch.Tensor) -> torch.Tensor:
    """(16,) int32 counts of estimate score bits >= each candidate."""
    return _count_bits(_score_bits(cs.estimates(table)), cands)


def select_plain(cs: CountSketch, table: torch.Tensor, t: torch.Tensor,
                 n_take: torch.Tensor):
    """(masked estimates, int32 mask): bits > t plus the first ``n_take``
    ties at t in flat-index order."""
    return _select_est(cs.estimates(table), t, n_take)


def _check_table(cs: CountSketch, table: torch.Tensor, what: str):
    if table.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {table.device}")
    if table.dtype != torch.float32 or tuple(table.shape) != (
            cs.r, cs.c_eff) or not table.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous float32 "
                         f"({cs.r}, {cs.c_eff}) table, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if cs.r not in (1, 3, 5):
        raise NotImplementedError(f"{what} kernel has median networks for "
                                  f"r in (1, 3, 5), not r={cs.r}")


def count(cs: CountSketch, table: torch.Tensor,
          cands: torch.Tensor) -> torch.Tensor:
    """Counting pass of the radix select. A CPU table takes the plain
    version; a CUDA table launches the kernel or raises."""
    if table.device.type == "cpu":
        return count_plain(cs, table, cands)
    _check_table(cs, table, "count")
    if cands.dtype != torch.int32 or cands.shape != (NIBBLES,) \
            or cands.device != table.device:
        raise ValueError("count takes (16,) int32 candidates on the "
                         "table's device")
    tabs = cs.kernel_tables(table.device)
    counts = torch.zeros(NIBBLES, dtype=torch.int32, device=table.device)
    lib = cuda_lib.load("unsketch_topk", _SIGNATURES)
    err = lib.count_launch(table.data_ptr(), cs.d, cs.r, cs.nwindows,
                           tabs.coeffs.data_ptr(), cands.data_ptr(),
                           counts.data_ptr(),
                           cuda_lib.stream_ptr(table.device))
    cuda_lib.check(err, "count")
    cuda_lib.LAUNCHES["count"] += 1
    return counts


def select(cs: CountSketch, table: torch.Tensor, t: torch.Tensor,
           n_take: torch.Tensor):
    """Selection pass: (masked estimates (d,), int32 mask (d,)). A CPU
    table takes the plain version; a CUDA table launches the kernel or
    raises."""
    if table.device.type == "cpu":
        return select_plain(cs, table, t, n_take)
    _check_table(cs, table, "select")
    t = t.to(device=table.device, dtype=torch.int32).reshape(1)
    n_take = n_take.to(device=table.device, dtype=torch.int64).reshape(1)
    tabs = cs.kernel_tables(table.device)
    n_tiles = -(-cs.d // TILE_N)
    ties = torch.empty(2 * n_tiles, dtype=torch.int32, device=table.device)
    masked = torch.empty(cs.d, dtype=torch.float32, device=table.device)
    mask = torch.empty(cs.d, dtype=torch.int32, device=table.device)
    lib = cuda_lib.load("unsketch_topk", _SIGNATURES)
    err = lib.select_launch(table.data_ptr(), cs.d, cs.r, cs.nwindows,
                            tabs.coeffs.data_ptr(), t.data_ptr(),
                            n_take.data_ptr(), ties.data_ptr(),
                            ties[n_tiles:].data_ptr(), masked.data_ptr(),
                            mask.data_ptr(),
                            cuda_lib.stream_ptr(table.device))
    cuda_lib.check(err, "select")
    cuda_lib.LAUNCHES["select"] += 1
    return masked, mask


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the reference's
    int32 arithmetic; round 0's ``8 << 28`` is INT32_MIN)."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _radix_threshold(count_fn, kk: int, device):
    """Exact k-th largest score bits by 8 rounds of 4-bit refinement
    (reference ``_radix_threshold``). ``count_fn(cands)`` maps 16 int32
    candidates to counts of ``bits >= cand``. Each round extends the
    prefix by the largest nibble whose candidate still has >= kk
    survivors; ``cands >= prefix`` excludes the wrapped candidates.
    Returns device tensors ``(t, n_take)``."""
    js = torch.arange(NIBBLES, dtype=torch.int64, device=device)
    prefix = torch.zeros((), dtype=torch.int64, device=device)
    for rnd in range(8):
        shift = 28 - 4 * rnd
        cands = _wrap_i32(prefix + (js << shift))
        counts = count_fn(cands)
        ok = (counts >= kk) & (cands >= prefix)
        nib = torch.where(ok, js, 0).max()
        prefix = prefix + (nib << shift)
    t_plus = prefix + (prefix < _I32_MAX).to(torch.int64)
    fin = count_fn(_wrap_i32(torch.where(js == 1, t_plus, prefix)))
    return prefix.to(torch.int32), kk - fin[1].to(torch.int64)


def unsketch_select(cs: CountSketch, table: torch.Tensor, k: int):
    """Fused unsketch + exact top-k of a tiled CountSketch table:
    ``(masked estimates (d,), int32 selection mask (d,))``, bitwise the
    reference's ``unsketch_select_pallas``. A CPU table takes the plain
    version; a CUDA table runs the count and select kernels."""
    if table.device.type == "cpu":
        return unsketch_select_plain(cs, table, k)
    t, n_take = _radix_threshold(lambda c: count(cs, table, c), k,
                                 table.device)
    return select(cs, table, t, n_take)


def unsketch_select_plain(cs: CountSketch, table: torch.Tensor, k: int):
    """Plain version of ``unsketch_select`` on any device: the same radix
    rounds over the plain counts, with the estimates computed once."""
    est = cs.estimates(table)
    bits = _score_bits(est)
    t, n_take = _radix_threshold(lambda c: _count_bits(bits, c), k,
                                 table.device)
    return _select_est(est, t, n_take)


def values_indices_from_mask(masked: torch.Tensor, mask: torch.Tensor,
                             k: int):
    """(values, indices) in the exact ``lax.top_k`` order from a masked
    vector and its selection mask: compact the <= k selected positions by
    cumsum rank (unfilled slots index 0, as the reference's scatter
    default), then sort by (-score, index). No host sync."""
    d = masked.shape[0]
    sel = mask != 0
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(sel & (pos < k), pos, k)
    idxs = torch.zeros(k + 1, dtype=torch.int64, device=masked.device)
    idxs.scatter_(0, slot, torch.arange(d, device=masked.device))
    idxs = idxs[:k]
    vals = masked[idxs]
    by_index = torch.argsort(idxs, stable=True)
    by_score = torch.argsort(-(vals * vals)[by_index], stable=True)
    order = by_index[by_score]
    return vals[order], idxs[order]
