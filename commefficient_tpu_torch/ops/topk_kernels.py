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

* ``est``: the value is the CountSketch estimate. The sketch-mode server
  runs it through ``unsketch_compact`` (``unsketch_values_indices``), and
  ``unsketch_select`` gives the reference's dense (masked estimates, int32
  mask). On Hopper it is a histogram radix over estimates computed once
  (``csrc/unsketch_radix.cu``, launch keys ``est_hist``, ``digit_hist``
  (twice), then ``radix_compact`` or ``radix_select``): ``est_hist``
  computes every estimate from the table (10 MB at 5 x 500,096,
  L2-resident), stores it to a (d,) scratch and counts the first 11-bit
  digit of its key; two ``digit_hist`` passes over the scratch count the
  next digits (11 and 9 bits) of the keys that share the prefix; the last
  CTA of each pass picks the digit on the device, so ``t`` and ``n_take``
  never come to the host; the select counts ``bits > t`` and ties per
  tile, scans them and writes bits > t plus the first ``n_take`` ties in
  index order, dense or compacted. The key is the score bits clamped at 0,
  because the reference's radix never goes below 0 (``radix_threshold_plain``).
  The first port's kernels, which recompute the estimate in each of the 8
  radix rounds, a ninth count and the select (``count``/``select``, keys
  ``count``/``select``, ``csrc/unsketch_topk.cu``), stay beside it on no
  path, held against ``count_plain``/``select_plain``.
* ``plain``: B rows of a dense (B, n) stream, each with its own k (the
  reference's batched per-row-k grid); the select writes ``where(sel, x,
  0)`` and, on request, the mask. ``topk_select`` runs it.
* ``resid``: the true_topk server epilogue over ``err`` (one row). It
  streams ``(err, v)`` and writes the update and both residuals, masked
  on ``supp = sel & (update != 0)``: a selected 0.0 or -0.0 keeps its
  residual. ``fused_true_topk`` runs it. The momentum read ``v = g +
  rho*vv; err = ve + v`` stays in PyTorch before the kernels, as the
  reference keeps it outside its kernel.

  On Hopper both are a per-row histogram radix over the stream itself
  (``csrc/topk_radix.cu``, launch keys ``rows_hist`` (three digit passes,
  each launch covering every row), then ``rows_select`` or
  ``rows_resid``): the digits, pick and workspace of the est source
  (``csrc/radix.cuh``), one workspace block per row, each row's k read
  from a device tensor, so nothing comes to the host. The plain version is
  ``radix_threshold_rows_plain`` and ``select_rows_plain`` /
  ``select_resid_plain``. The first port's kernels (``count_rows``/
  ``select_rows``/``select_resid``, keys ``count_plain``/``select_plain``/
  ``select_resid``, ``csrc/topk_stream.cu``: a 16-candidate count per
  4-bit round of ``_radix_threshold_batched``, nine launches, then a tie
  count and the select) stay beside it on no path, held against
  ``count_rows_plain``/``select_rows_plain``/``select_resid_plain``.

On Hopper the TPU kernels' sequential grid is gone: counts reduce per CTA
and add into global counters with integer atomics, exact in any order;
the select's cross-tile tie carry becomes per-tile tie counts, an
exclusive scan per row, and a within-tile rank by a block scan in index
order. Coordinates at or past n neither count nor select.

Bounds (d = 6,568,640): an ``est`` count, and ``est_hist``, read the
table once (10.0 MB) but compute r sign hashes, r gathers and the median
for every coordinate (~133 operations each at r=5), so they are bound by
operations; ``digit_hist``, ``rows_hist``, a first-port plain count (4
bytes per element for 16 compares) and the selects read their streams and
write their outputs once: bound by bytes.
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
_RADIX_SIGNATURES = {
    "est_hist_launch": [_P, _LL, _I, _I, _P, _LL, _P, _P, _P],
    "digit_hist_launch": [_P, _LL, _I, _LL, _P, _P],
    "radix_select_launch": [_P, _LL, _LL, _P, _P, _P, _P, _P, _P],
}
_ROWS_SIGNATURES = {
    "rows_hist_launch": [_P, _LL, _I, _I, _P, _P, _I, _P],
    "rows_select_launch": [_P, _LL, _I, _P, _P, _P, _P, _I, _P],
    "rows_resid_launch": [_P, _P, _LL, _P, _P, _P, _P, _P, _I, _P],
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
# est source, estimated once: the histogram radix (csrc/unsketch_radix.cu)
# --------------------------------------------------------------------------

#: (shift, width) of the radix digits of the 31-bit key: bits 30..20,
#: 19..9, 8..0
DIGITS = ((20, 11), (9, 11), (0, 9))
# the radix's int32 workspace of one selection (csrc/radix.cuh): three
# histograms and the control words (t at +6, n_take as int64 at +8); the
# est source follows it with the select's (2, n_tiles) per-tile counts and
# their (2, n_tiles) offsets; the dense streams keep one block per row
_WS_HIST = (0, 2048, 4096)
_WS_CTRL = 4608
_WS_COUNTS = _WS_CTRL + 16


def _radix_key(bits: torch.Tensor) -> torch.Tensor:
    """The radix key: score bits clamped at 0. The reference's radix
    never goes below 0, so a negative score (a NaN with its sign bit set)
    counts as 0 in the search, and is never selected (bits > t and
    bits == t read the bits themselves)."""
    return torch.clamp(bits, min=0).to(torch.int64)


def digit_histogram_plain(bits: torch.Tensor, prefix, shift: int,
                          width: int) -> torch.Tensor:
    """Plain version of a histogram pass, per row: ``(..., 2**width)``
    int32 counts of the key digit ``(key >> shift) & (2**width - 1)`` over
    the keys of ``bits`` (..., n) whose higher bits ``key >> (shift +
    width)`` equal the row's ``prefix`` (...)."""
    key = _radix_key(bits)
    nbins = 1 << width
    prefix = torch.as_tensor(prefix, device=bits.device)
    digit = torch.where((key >> (shift + width)) == prefix[..., None],
                        (key >> shift) & (nbins - 1), nbins)
    hist = torch.zeros(bits.shape[:-1] + (nbins + 1,), dtype=torch.int64,
                       device=bits.device)
    hist.scatter_add_(-1, digit, torch.ones_like(digit))
    return hist[..., :nbins].to(torch.int32)


def digit_pick_plain(hist: torch.Tensor, k_rem):
    """Plain version of the device-side digit pick, per row: ``(b,
    above)``, the largest bin b whose count of keys in bins >= b reaches
    ``k_rem`` (bin 0 if none does) and the count of keys in bins above it;
    int64 of the rows' shape."""
    h = hist.to(torch.int64)
    at_or_above = torch.flip(torch.cumsum(torch.flip(h, (-1,)), -1), (-1,))
    bins = torch.arange(h.shape[-1], device=h.device)
    k_rem = torch.as_tensor(k_rem, device=h.device)
    b = torch.where(at_or_above >= k_rem[..., None], bins, 0).amax(-1)
    at = lambda a: a.gather(-1, b[..., None])[..., 0]
    return b, at(at_or_above) - at(h)


def radix_threshold_rows_plain(bits: torch.Tensor, kk: torch.Tensor):
    """``(t, n_take)`` (int32, int64, of the rows' shape) of the
    reference's radix by the digit passes, per row of ``bits`` (..., n)
    with the row's k in ``kk`` (...): t = max{v in [0, 2**31 - 1] :
    #(bits >= v) >= k}, or 0 if there is none, and n_take = k - #(bits >=
    t + 1), with t + 1 saturating at INT32_MAX as the reference's (so at
    k = 0, t = INT32_MAX and n_take <= 0). Equal to
    ``_radix_threshold_batched`` over ``_count_bits``; no host sync."""
    kk = kk.to(device=bits.device, dtype=torch.int64)
    prefix = torch.zeros_like(kk)
    k_rem, above = kk, prefix
    for shift, width in DIGITS:
        hist = digit_histogram_plain(bits, prefix, shift, width)
        b, a = digit_pick_plain(hist, k_rem)
        prefix = (prefix << width) | b
        k_rem, above = k_rem - a, above + a
    at_t = hist.to(torch.int64).gather(-1, b[..., None])[..., 0]
    at_t = torch.where(prefix == _I32_MAX, at_t, 0)
    return prefix.to(torch.int32), kk - above - at_t


def radix_threshold_plain(bits: torch.Tensor, k: int):
    """One-row form of ``radix_threshold_rows_plain``: ``(t, n_take)``
    (0-d int32, int64) of the (n,) ``bits`` at k."""
    kk = torch.zeros((), dtype=torch.int64, device=bits.device) + k
    return radix_threshold_rows_plain(bits, kk)


def select_compact_plain(est: torch.Tensor, t: torch.Tensor,
                         n_take: torch.Tensor, k: int):
    """Plain version of the compact select: the survivors of
    ``_select_est`` as ``(values (k,), indices (k,) int64)`` in index
    order; slots past the last survivor hold index 0 and the masked value
    at 0."""
    sel = _select_mask(_score_bits(est), t, n_take)
    idx = torch.nonzero(sel).flatten()[:k]
    indices = torch.zeros(k, dtype=torch.int64, device=est.device)
    indices[:idx.shape[0]] = idx
    return torch.where(sel, est, 0.0)[indices], indices


def radix_workspace(d: int, device):
    """``(est, ws)`` for the histogram radix at length ``d``: the (n_tiles
    * 8192,) f32 scratch for the estimates (padded to whole tiles) and the
    zeroed int32 workspace, both from PyTorch's caching allocator."""
    n_tiles = -(-d // TILE_N)
    return (torch.empty(n_tiles * TILE_N, dtype=torch.float32,
                        device=device),
            torch.zeros(_WS_COUNTS + 4 * n_tiles, dtype=torch.int32,
                        device=device))


def est_hist(cs: CountSketch, table: torch.Tensor, k: int,
             est: torch.Tensor, ws: torch.Tensor) -> None:
    """Pass 0 on a CUDA table: every estimate into ``est``, the first
    digit's histogram and its pick into ``ws`` (zeroed)."""
    _check_table(cs, table, "est_hist")
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"k={k} outside [0, 2**31)")
    tabs = cs.kernel_tables(table.device)
    lib = cuda_lib.load("unsketch_radix", _RADIX_SIGNATURES)
    err = lib.est_hist_launch(table.data_ptr(), cs.d, cs.r, cs.nwindows,
                              tabs.coeffs.data_ptr(), k, est.data_ptr(),
                              ws.data_ptr(), cuda_lib.stream_ptr(table.device))
    cuda_lib.check(err, "est_hist")
    cuda_lib.LAUNCHES["est_hist"] += 1


def digit_hist(est: torch.Tensor, d: int, k: int, ws: torch.Tensor,
               pass_: int) -> None:
    """Pass 1 or 2 over the stored estimates: the next digit's histogram
    of the keys that share the prefix, and its pick (the last pass leaves
    t and n_take in ``ws``)."""
    lib = cuda_lib.load("unsketch_radix", _RADIX_SIGNATURES)
    err = lib.digit_hist_launch(est.data_ptr(), d, pass_, k, ws.data_ptr(),
                                cuda_lib.stream_ptr(est.device))
    cuda_lib.check(err, "digit_hist")
    cuda_lib.LAUNCHES["digit_hist"] += 1


def unsketch_radix(cs: CountSketch, table: torch.Tensor, k: int):
    """The three histogram passes on a CUDA table: ``est_hist``, then
    ``digit_hist`` twice. Returns ``(est, ws)``: the scratch whose first d
    values are the estimates, and the workspace holding the histograms, t
    and n_take (``radix_views``). Raises for a table off the card; nothing
    comes to the host."""
    est, ws = radix_workspace(cs.d, table.device)
    est_hist(cs, table, k, est, ws)
    for p in (1, 2):
        digit_hist(est, cs.d, k, ws, p)
    return est, ws


def radix_views(ws: torch.Tensor) -> dict:
    """Views of an ``unsketch_radix`` workspace: the three digit
    histograms (``hists``), ``t`` (0-d int32) and ``n_take`` (0-d
    int64)."""
    hists = tuple(ws[o:o + (1 << w)] for o, (_, w) in zip(_WS_HIST, DIGITS))
    return {"hists": hists, "t": ws[_WS_CTRL + 6],
            "n_take": ws[_WS_CTRL + 8:_WS_CTRL + 10].view(torch.int64)[0]}


def radix_select(est: torch.Tensor, d: int, k: int, ws: torch.Tensor,
                 dense: bool):
    """The select after ``unsketch_radix``: the per-tile counts, their
    scan and the select pass. ``dense``: (masked (d,) f32, int32 mask
    (d,)), launch key ``radix_select``; else (values (k,) f32, indices (k,)
    int64) in index order, key ``radix_compact``."""
    dev = est.device
    lib = cuda_lib.load("unsketch_radix", _RADIX_SIGNATURES)
    if dense:
        out = (torch.empty(d, dtype=torch.float32, device=dev),
               torch.empty(d, dtype=torch.int32, device=dev))
        ptrs = (out[0].data_ptr(), out[1].data_ptr(), None, None)
        key = "radix_select"
    else:
        out = (torch.empty(k, dtype=torch.float32, device=dev),
               torch.empty(k, dtype=torch.int64, device=dev))
        ptrs = (None, None, out[0].data_ptr(), out[1].data_ptr())
        key = "radix_compact"
    err = lib.radix_select_launch(est.data_ptr(), d, k, ws.data_ptr(),
                                  *ptrs, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, key)
    cuda_lib.LAUNCHES[key] += 1
    return out


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
# plain and resid sources: the per-row histogram radix (csrc/topk_radix.cu)
# --------------------------------------------------------------------------

def rows_workspace(rows: int, device) -> torch.Tensor:
    """The zeroed (rows, 4624) int32 workspace of ``rows_radix``: per row
    the three digit histograms and the control words (``_WS_*``)."""
    return torch.zeros((rows, _WS_COUNTS), dtype=torch.int32, device=device)


def _aligned(rows: int, n: int, *tensors) -> bool:
    """Whether every row of every (rows, n) f32 tensor starts on 16 bytes,
    so the kernels may move four coordinates as one float4."""
    return (rows == 1 or n % 4 == 0) and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _check_workspace(ws: torch.Tensor, x: torch.Tensor, what: str):
    rows = x.shape[0] if x.dim() == 2 else 1
    if ws.dtype != torch.int32 or tuple(ws.shape) != (rows, _WS_COUNTS) \
            or ws.device != x.device or not ws.is_contiguous():
        raise ValueError(f"{what} takes a ({rows}, {_WS_COUNTS}) int32 "
                         "workspace on the stream's device")


def rows_hist(x: torch.Tensor, kk: torch.Tensor, ws: torch.Tensor,
              pass_: int) -> None:
    """Digit pass ``pass_`` (0, 1, 2) over the (B, n) CUDA stream ``x``:
    each row's histogram of its next digit and the pick into ``ws`` (the
    last pass leaves t and n_take). ``kk``: (B,) int64 on the card."""
    _check_stream(x, "rows_hist", 2)
    rows, n = x.shape
    if kk.dtype != torch.int64 or tuple(kk.shape) != (rows,) \
            or kk.device != x.device or not kk.is_contiguous():
        raise ValueError(f"rows_hist takes a contiguous ({rows},) int64 k "
                         "on the stream's device")
    _check_workspace(ws, x, "rows_hist")
    if rows == 0 or n == 0:
        return
    lib = cuda_lib.load("topk_radix", _ROWS_SIGNATURES)
    err = lib.rows_hist_launch(x.data_ptr(), n, rows, pass_, kk.data_ptr(),
                               ws.data_ptr(), _aligned(rows, n, x),
                               cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "rows_hist")
    cuda_lib.LAUNCHES["rows_hist"] += 1


def rows_radix(x: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """The three digit passes over the (B, n) CUDA stream ``x`` with the
    per-row k ``kk`` ((B,) int64 on the card): returns the workspace
    holding each row's histograms, t and n_take (``rows_views``). Raises
    for a stream off the card; nothing comes to the host."""
    ws = rows_workspace(x.shape[0], x.device)
    for p in range(len(DIGITS)):
        rows_hist(x, kk, ws, p)
    return ws


def rows_views(ws: torch.Tensor) -> dict:
    """Views of a ``rows_radix`` workspace: the three digit histograms
    ((B, 2**width) each, ``hists``), ``t`` ((B,) int32) and ``n_take``
    ((B,) int64)."""
    hists = tuple(ws[:, o:o + (1 << w)] for o, (_, w) in zip(_WS_HIST,
                                                             DIGITS))
    return {"hists": hists, "t": ws[:, _WS_CTRL + 6],
            "n_take": ws[:, _WS_CTRL + 8:_WS_CTRL + 10].view(
                torch.int64)[:, 0]}


def rows_select(x: torch.Tensor, ws: torch.Tensor, with_mask: bool = False):
    """The plain select after ``rows_radix``: per row, bits > t plus the
    first n_take ties in index order, as (masked (B, n), int32 mask (B, n)
    or None); launch key ``rows_select``."""
    _check_stream(x, "rows_select", 2)
    _check_workspace(ws, x, "rows_select")
    rows, n = x.shape
    masked = torch.empty_like(x)
    mask = (torch.empty(x.shape, dtype=torch.int32, device=x.device)
            if with_mask else None)
    if rows == 0 or n == 0:
        return masked, mask
    ties = _tie_scratch(rows, n, x.device)
    outs = (masked,) if mask is None else (masked, mask)
    lib = cuda_lib.load("topk_radix", _ROWS_SIGNATURES)
    err = lib.rows_select_launch(
        x.data_ptr(), n, rows, ws.data_ptr(), ties.data_ptr(),
        masked.data_ptr(), None if mask is None else mask.data_ptr(),
        _aligned(rows, n, x, *outs), cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "rows_select")
    cuda_lib.LAUNCHES["rows_select"] += 1
    return masked, mask


def rows_resid(err: torch.Tensor, v: torch.Tensor, ws: torch.Tensor):
    """The true_topk epilogue after ``rows_radix`` over ``err[None]``:
    (update, new velocity, new error), each (n,); launch key
    ``rows_resid``."""
    _check_stream(err, "rows_resid", 1)
    _check_stream(v, "rows_resid", 1)
    if v.shape != err.shape or v.device != err.device:
        raise ValueError("rows_resid takes err and v of one shape and "
                         "device")
    _check_workspace(ws, err, "rows_resid")
    n = err.shape[0]
    outs = tuple(torch.empty_like(err) for _ in range(3))
    if n == 0:
        return outs
    ties = _tie_scratch(1, n, err.device)
    lib = cuda_lib.load("topk_radix", _ROWS_SIGNATURES)
    code = lib.rows_resid_launch(
        err.data_ptr(), v.data_ptr(), n, ws.data_ptr(), ties.data_ptr(),
        *(o.data_ptr() for o in outs), _aligned(1, n, err, v, *outs),
        cuda_lib.stream_ptr(err.device))
    cuda_lib.check(code, "rows_resid")
    cuda_lib.LAUNCHES["rows_resid"] += 1
    return outs


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
    version; a CUDA table runs the histogram radix kernels (``est_hist``,
    ``digit_hist`` twice, ``radix_select``) or raises."""
    if table.device.type == "cpu":
        return unsketch_select_plain(cs, table, k)
    est, ws = unsketch_radix(cs, table, k)
    return radix_select(est, cs.d, k, ws, dense=True)


def unsketch_compact(cs: CountSketch, table: torch.Tensor, k: int):
    """The survivors of ``unsketch_select`` compacted: ``(values (k,) f32,
    indices (k,) int64)`` in ascending index order, unfilled slots (fewer
    than k survivors) holding index 0 and the masked value at 0, as the
    reference's compaction in ``values_indices_from_mask``. A CPU table
    takes the plain version; a CUDA table runs the histogram radix kernels
    (``est_hist``, ``digit_hist`` twice, ``radix_compact``) or raises."""
    if table.device.type == "cpu":
        return unsketch_compact_plain(cs, table, k)
    est, ws = unsketch_radix(cs, table, k)
    return radix_select(est, cs.d, k, ws, dense=False)


def unsketch_select_plain(cs: CountSketch, table: torch.Tensor, k: int):
    """Plain version of ``unsketch_select`` on any device: the estimates
    computed once, the digit radix, the dense select."""
    est = cs.estimates(table)
    t, n_take = radix_threshold_plain(_score_bits(est), k)
    return _select_est(est, t, n_take)


def unsketch_compact_plain(cs: CountSketch, table: torch.Tensor, k: int):
    """Plain version of ``unsketch_compact`` on any device."""
    est = cs.estimates(table)
    t, n_take = radix_threshold_plain(_score_bits(est), k)
    return select_compact_plain(est, t, n_take, k)


def topk_select(vec: torch.Tensor, kk, k: int, with_mask: bool = False):
    """Dense masked top-``kk`` of a 1-D ``vec``, or of each row of a 2-D
    one, bitwise the reference's ``topk_select_pallas``: ``kk`` is an int
    or a per-row (B,) tensor of valid counts <= the budget ``k``; each row
    keeps the first ``kk`` slots of the stable selection order. Returns
    the masked tensor, and with ``with_mask`` also the int32 mask. A CPU
    tensor takes the plain versions (the digit radix, then the select); a
    CUDA tensor the per-row histogram radix kernels (``rows_hist`` three
    times, then ``rows_select``, each launch covering every row)."""
    if vec.dim() not in (1, 2):
        raise ValueError(f"topk_select takes 1-D/2-D input, got "
                         f"{vec.dim()}-D")
    rows = vec.reshape(1, -1) if vec.dim() == 1 else vec.contiguous()
    if torch.is_tensor(kk):
        kk = kk.to(device=vec.device, dtype=torch.int64).expand(
            rows.shape[0]).contiguous()
    elif not 0 <= kk <= k:
        raise ValueError(f"kk={kk} outside the budget [0, {k}]")
    else:
        kk = torch.full((rows.shape[0],), int(kk), dtype=torch.int64,
                        device=vec.device)
    if vec.device.type == "cpu":
        t, n_take = radix_threshold_rows_plain(_score_bits(rows), kk)
        masked, mask = select_rows_plain(rows, t, n_take, with_mask)
    else:
        masked, mask = rows_select(rows, rows_radix(rows, kk), with_mask)
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
    on a CUDA tensor the three ``rows_hist`` passes stream err and
    ``rows_resid`` writes all three outputs. A CPU tensor takes the plain
    versions."""
    v = g + rho * vvel
    err = verr + v
    kk = torch.full((1,), k, dtype=torch.int64, device=err.device)
    if err.device.type == "cpu":
        t, n_take = radix_threshold_rows_plain(_score_bits(err[None]), kk)
        return select_resid_plain(err, v, t[0], n_take[0])
    return rows_resid(err, v, rows_radix(err[None], kk))


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
    return order_by_score(masked[idxs], idxs)


def order_by_score(vals: torch.Tensor, idxs: torch.Tensor):
    """Compacted (values, indices) sorted by (-score, index), the stable
    ``lax.top_k`` order, as the reference's two-key ``lax.sort``."""
    by_index = torch.argsort(idxs, stable=True)
    by_score = torch.argsort(-(vals * vals)[by_index], stable=True)
    order = by_index[by_score]
    return vals[order], idxs[order]
