"""Streaming exact top-k: CUDA kernels for Hopper + plain versions.

Replaces the two kernels of ``commefficient_tpu/ops/topk_kernels.py`` in
all three of their sources:

* ``_count_kernel`` — counts of score bits ``>=`` each of 16 int32
  candidates, where a coordinate's score is ``x*x`` of its value bitcast
  to int32 (non-negative floats order like their bits). Eight 4-bit radix
  rounds plus one ``[t, t+1]`` count find the exact k-th largest score
  ``t`` and ``n_take``, the ties at ``t`` to keep.
* ``_select_kernel`` — keeps ``bits > t`` plus the first ``n_take`` ties
  in flat-index order. That set and its order are stable ``lax.top_k``'s.

The sources, as in the reference:

* ``est`` (``count``/``select``, launch keys ``count``/``select``): the
  value is the CountSketch estimate, computed per tile in registers from
  the table (10 MB at 5 x 500,096, L2-resident on an H100) and never
  stored as a (d,) vector; the select writes the masked estimates and the
  int32 mask. The sketch-mode server runs it (``unsketch_select``).
* ``plain`` (``count_rows``/``select_rows``, keys ``count_plain``/
  ``select_plain``): B rows of a dense (B, n) stream, each with its own
  candidates, ``t`` and ``n_take`` (the reference's batched per-row-k
  grid); the select writes ``where(sel, x, 0)`` and, on request, the mask.
  ``topk_select`` runs it; true_topk counts over its error vector with it.
* ``resid`` (``select_resid``, key ``select_resid``): the true_topk server
  epilogue. It streams ``(err, v)`` and writes the update and both
  residuals, masked on ``supp = sel & (update != 0)``: a selected 0.0 or
  -0.0 keeps its residual. ``fused_true_topk`` runs it. The momentum read
  ``v = g + rho*vv; err = ve + v`` stays in PyTorch before the kernel, as
  the reference keeps it outside its kernel.

On Hopper the TPU kernels' sequential grid is gone: the count reduces per
CTA and adds into the 16 counters with integer atomics, exact in any
order; the select's cross-tile tie carry becomes per-tile tie counts, an
exclusive scan per row, and a within-tile rank by warp ballots — one
design for every source (``csrc/topk_stream.cuh``; the est source in
``csrc/unsketch_topk.cu``, plain and resid in ``csrc/topk_stream.cu``).
Coordinates at or past n neither count nor select.

Bounds (d = 6,568,640): an ``est`` count reads the table once (10.0 MB)
but recomputes r sign hashes, r gathers and the median for every
coordinate (~133 operations each at r=5), so it is bound by operations; a
plain count reads 4 bytes per element for 16 compares, and the plain and
resid selects read their streams and write their outputs once: bound by
bytes.

The radix search is PyTorch glue on the device (``_radix_threshold_batched``):
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
_EST_SIGNATURES = {
    "count_launch": [_P, _LL, _I, _I, _P, _P, _P, _P],
    "select_launch": [_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
}
_STREAM_SIGNATURES = {
    "count_plain_launch": [_P, _LL, _I, _P, _P, _P],
    "select_plain_launch": [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P],
    "select_resid_launch": [_P, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _score_bits(x: torch.Tensor) -> torch.Tensor:
    return (x * x).view(torch.int32)


def _count_bits(bits: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Counts of ``bits >= cand`` along the last axis, per candidate:
    (n,) bits and (16,) candidates, or (B, n) and (B, 16)."""
    return torch.stack([(bits >= cands[..., j, None]).sum(-1)
                        for j in range(NIBBLES)], -1).to(torch.int32)


def _select_mask(bits: torch.Tensor, t: torch.Tensor, n_take: torch.Tensor):
    """bits > t plus the first ``n_take`` ties at t in flat-index order,
    along the last axis (t and n_take: 0-d, or one per row)."""
    t, n_take = t[..., None], n_take[..., None]
    eq = bits == t
    rank = torch.cumsum(eq, -1) - eq.to(torch.int64)
    return (bits > t) | (eq & (rank < n_take))


def _select_est(est: torch.Tensor, t: torch.Tensor, n_take: torch.Tensor):
    sel = _select_mask(_score_bits(est), t, n_take)
    return torch.where(sel, est, 0.0), sel.to(torch.int32)


def _tie_scratch(rows: int, n: int, device) -> torch.Tensor:
    """(2, rows, n_tiles) int32: per-tile tie counts, then their offsets."""
    return torch.empty((2, rows, -(-n // TILE_N)), dtype=torch.int32,
                       device=device)


# --------------------------------------------------------------------------
# est source: the CountSketch estimate, computed in-tile from the table
# --------------------------------------------------------------------------

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
    lib = cuda_lib.load("unsketch_topk", _EST_SIGNATURES)
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
    ties = _tie_scratch(1, cs.d, table.device)
    masked = torch.empty(cs.d, dtype=torch.float32, device=table.device)
    mask = torch.empty(cs.d, dtype=torch.int32, device=table.device)
    lib = cuda_lib.load("unsketch_topk", _EST_SIGNATURES)
    err = lib.select_launch(table.data_ptr(), cs.d, cs.r, cs.nwindows,
                            tabs.coeffs.data_ptr(), t.data_ptr(),
                            n_take.data_ptr(), ties[0].data_ptr(),
                            ties[1].data_ptr(), masked.data_ptr(),
                            mask.data_ptr(),
                            cuda_lib.stream_ptr(table.device))
    cuda_lib.check(err, "select")
    cuda_lib.LAUNCHES["select"] += 1
    return masked, mask


# --------------------------------------------------------------------------
# plain and resid sources: dense streams
# --------------------------------------------------------------------------

def count_rows_plain(x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(B, 16) int32 counts of score bits >= each row's candidates."""
    return _count_bits(_score_bits(x), cands)


def select_rows_plain(x: torch.Tensor, t: torch.Tensor, n_take: torch.Tensor,
                      with_mask: bool = False):
    """Per row, ``where(sel, x, 0)`` (and the int32 mask, or None)."""
    sel = _select_mask(_score_bits(x), t, n_take)
    return (torch.where(sel, x, 0.0),
            sel.to(torch.int32) if with_mask else None)


def select_resid_plain(err: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                       n_take: torch.Tensor):
    """(update, new velocity, new error) of the true_topk epilogue."""
    sel = _select_mask(_score_bits(err), t, n_take)
    upd = torch.where(sel, err, 0.0)
    supp = sel & (upd != 0)
    return upd, torch.where(supp, 0.0, v), torch.where(supp, 0.0, err)


def _check_stream(x: torch.Tensor, what: str, ndim: int):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous {ndim}-D float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")


def _row_scalars(t, n_take, rows: int, device):
    t = t.to(device=device, dtype=torch.int32).reshape(rows).contiguous()
    n_take = n_take.to(device=device, dtype=torch.int64).reshape(
        rows).contiguous()
    return t, n_take


def count_rows(x: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Counting pass over B rows: ``x`` (B, n) f32, ``cands`` (B, 16)
    int32 -> (B, 16) int32. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return count_rows_plain(x, cands)
    _check_stream(x, "count_plain", 2)
    rows, n = x.shape
    if cands.dtype != torch.int32 or tuple(cands.shape) != (rows, NIBBLES) \
            or cands.device != x.device or not cands.is_contiguous():
        raise ValueError(f"count_plain takes contiguous ({rows}, 16) int32 "
                         "candidates on the stream's device")
    counts = torch.zeros((rows, NIBBLES), dtype=torch.int32, device=x.device)
    if n == 0:
        return counts
    lib = cuda_lib.load("topk_stream", _STREAM_SIGNATURES)
    err = lib.count_plain_launch(x.data_ptr(), n, rows, cands.data_ptr(),
                                 counts.data_ptr(),
                                 cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "count_plain")
    cuda_lib.LAUNCHES["count_plain"] += 1
    return counts


def select_rows(x: torch.Tensor, t: torch.Tensor, n_take: torch.Tensor,
                with_mask: bool = False):
    """Selection pass over B rows with per-row ``t`` and ``n_take``:
    (masked (B, n), int32 mask (B, n) or None). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return select_rows_plain(x, t, n_take, with_mask)
    _check_stream(x, "select_plain", 2)
    rows, n = x.shape
    t, n_take = _row_scalars(t, n_take, rows, x.device)
    masked = torch.empty_like(x)
    mask = (torch.empty(x.shape, dtype=torch.int32, device=x.device)
            if with_mask else None)
    if n == 0:
        return masked, mask
    ties = _tie_scratch(rows, n, x.device)
    lib = cuda_lib.load("topk_stream", _STREAM_SIGNATURES)
    err = lib.select_plain_launch(
        x.data_ptr(), n, rows, t.data_ptr(), n_take.data_ptr(),
        ties[0].data_ptr(), ties[1].data_ptr(), masked.data_ptr(),
        mask.data_ptr() if with_mask else None,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "select_plain")
    cuda_lib.LAUNCHES["select_plain"] += 1
    return masked, mask


def select_resid(err: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
                 n_take: torch.Tensor):
    """The true_topk epilogue: (update, new velocity, new error), each
    (n,). A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if err.device.type == "cpu":
        return select_resid_plain(err, v, t, n_take)
    _check_stream(err, "select_resid", 1)
    _check_stream(v, "select_resid", 1)
    if v.shape != err.shape or v.device != err.device:
        raise ValueError("select_resid takes err and v of one shape and "
                         "device")
    n = err.shape[0]
    t, n_take = _row_scalars(t, n_take, 1, err.device)
    upd, new_v, new_err = (torch.empty_like(err) for _ in range(3))
    if n == 0:
        return upd, new_v, new_err
    ties = _tie_scratch(1, n, err.device)
    lib = cuda_lib.load("topk_stream", _STREAM_SIGNATURES)
    code = lib.select_resid_launch(
        err.data_ptr(), v.data_ptr(), n, t.data_ptr(), n_take.data_ptr(),
        ties[0].data_ptr(), ties[1].data_ptr(), upd.data_ptr(),
        new_v.data_ptr(), new_err.data_ptr(), cuda_lib.stream_ptr(err.device))
    cuda_lib.check(code, "select_resid")
    cuda_lib.LAUNCHES["select_resid"] += 1
    return upd, new_v, new_err


# --------------------------------------------------------------------------
# the radix search (PyTorch glue on the device)
# --------------------------------------------------------------------------

def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the reference's
    int32 arithmetic; round 0's ``8 << 28`` is INT32_MIN)."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def _radix_threshold_batched(count_fn, kk: torch.Tensor, device):
    """Exact k-th largest score bits of each of B rows by 8 rounds of 4-bit
    refinement (reference ``_radix_threshold_batched``). ``count_fn(cands)``
    maps (B, 16) int32 candidates to (B, 16) counts of ``bits >= cand``;
    ``kk`` is the (B,) per-row k. Each round extends a row's prefix by the
    largest nibble whose candidate still has >= kk survivors;
    ``cands >= prefix`` excludes the wrapped candidates. Returns device
    tensors ``(t (B,) int32, n_take (B,) int64)``."""
    kk = kk.to(device=device, dtype=torch.int64)
    js = torch.arange(NIBBLES, dtype=torch.int64, device=device)
    prefix = torch.zeros(kk.shape, dtype=torch.int64, device=device)
    for rnd in range(8):
        shift = 28 - 4 * rnd
        cands = _wrap_i32(prefix[:, None] + (js[None, :] << shift))
        counts = count_fn(cands)
        ok = (counts >= kk[:, None]) & (cands >= prefix[:, None])
        nib = torch.where(ok, js[None, :], 0).amax(dim=1)
        prefix = prefix + (nib << shift)
    t_plus = prefix + (prefix < _I32_MAX).to(torch.int64)
    fin = count_fn(_wrap_i32(torch.where(js[None, :] == 1, t_plus[:, None],
                                         prefix[:, None])))
    return prefix.to(torch.int32), kk - fin[:, 1].to(torch.int64)


def _radix_threshold(count_fn, kk: int, device):
    """One-row form of ``_radix_threshold_batched`` (reference
    ``_radix_threshold``): ``count_fn`` maps (16,) candidates to (16,)
    counts; returns 0-d ``(t, n_take)``."""
    t, n_take = _radix_threshold_batched(
        lambda cands: count_fn(cands[0])[None],
        torch.full((1,), kk, dtype=torch.int64, device=device), device)
    return t[0], n_take[0]


# --------------------------------------------------------------------------
# public entries
# --------------------------------------------------------------------------

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


def topk_select(vec: torch.Tensor, kk, k: int, with_mask: bool = False):
    """Dense masked top-``kk`` of a 1-D ``vec``, or of each row of a 2-D
    one, bitwise the reference's ``topk_select_pallas``: ``kk`` is an int
    or a per-row (B,) tensor of valid counts <= the budget ``k``; each row
    keeps the first ``kk`` slots of the stable selection order. Returns
    the masked tensor, and with ``with_mask`` also the int32 mask. A CPU
    tensor takes the plain versions; a CUDA tensor the count and select
    kernels (one launch per radix round covers every row)."""
    if vec.dim() not in (1, 2):
        raise ValueError(f"topk_select takes 1-D/2-D input, got "
                         f"{vec.dim()}-D")
    rows = vec.reshape(1, -1) if vec.dim() == 1 else vec.contiguous()
    if torch.is_tensor(kk):
        kk = kk.to(device=vec.device, dtype=torch.int64).expand(
            rows.shape[0])
    elif not 0 <= kk <= k:
        raise ValueError(f"kk={kk} outside the budget [0, {k}]")
    else:
        kk = torch.full((rows.shape[0],), int(kk), dtype=torch.int64,
                        device=vec.device)
    t, n_take = _radix_threshold_batched(lambda c: count_rows(rows, c), kk,
                                         vec.device)
    masked, mask = select_rows(rows, t, n_take, with_mask)
    if vec.dim() == 1:
        masked = masked[0]
        mask = None if mask is None else mask[0]
    return (masked, mask) if with_mask else masked


def fused_true_topk(g: torch.Tensor, vvel: torch.Tensor, verr: torch.Tensor,
                    k: int, rho: float):
    """The true_topk server update (reference ``fused_true_topk_pallas``):
    momentum ``v = g + rho*vvel``, error ``err = verr + v``, the exact
    top-k of err, and both error-feedback residuals, as ``(update,
    new_Vvelocity, new_Verror)``. The momentum read runs here in PyTorch;
    the count kernels stream err and the resid select kernel writes all
    three outputs. A CPU tensor takes the plain versions."""
    v = g + rho * vvel
    err = verr + v
    rows = err.reshape(1, -1)
    t, n_take = _radix_threshold_batched(
        lambda c: count_rows(rows, c),
        torch.full((1,), k, dtype=torch.int64, device=err.device),
        err.device)
    return select_resid(err, v, t[0], n_take[0])


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
