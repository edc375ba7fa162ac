"""The estimate-once histogram radix of the port's fused unsketch + exact
top-k, and its deterministic sparse re-sketch, against the JAX reference
and the first port's radix, on the CPU (plain versions; the card's kernels
are held against these in ``tests/test_torch_cuda_kernels.py``):

* the digit radix (``radix_threshold_plain``) gives the ``(t, n_take)`` of
  the eight-round radix over ``_count_bits`` on random, planted-tie,
  all-zero, +-0.0 and NaN-bearing score vectors, at k = 1, a middle k and
  k = n;
* ``unsketch_select`` (dense) is BITWISE the reference's
  ``unsketch_select_pallas`` in interpret mode;
* the compacted route (``unsketch_values_indices``, fused) is BITWISE the
  reference's ``values_indices_from_mask`` chain;
* ``sketch_sparse`` is BITWISE the reference's with planted collisions
  whose float sum depends on the order (1e8, 1, -1e8 in one bucket).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import topk_kernels as jtk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch

N = 5_000


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _score_vector(case: str) -> torch.Tensor:
    """int32 score bits of N coordinates."""
    rng = np.random.RandomState(len(case))
    if case == "random":
        x = rng.randn(N).astype(np.float32)
    elif case == "ties":
        x = rng.randn(N).astype(np.float32)
        x[rng.choice(N, N // 3, replace=False)] = 1.5
        x[rng.choice(N, N // 4, replace=False)] = -0.25
    elif case == "zeros":
        x = np.zeros(N, np.float32)
    else:
        x = None
    if x is not None:
        return tk._score_bits(torch.from_numpy(x))
    raw = rng.randn(N).astype(np.float32).view(np.int32)
    if case == "signed_zeros":
        # scores of +-0.0 and raw +-0.0 bits (0 and INT32_MIN)
        raw[rng.choice(N, N // 2, replace=False)] = 0
        raw[rng.choice(N, N // 4, replace=False)] = np.int32(-2 ** 31)
    else:  # nan: x86's quiet NaN, the card's canonical NaN score, a NaN
        # with its sign bit set, +inf
        for v, frac in ((0x7FC00000, 7), (0x7FFFFFFF, 9),
                        (np.int32(-0x00400000), 5), (0x7F800000, 11)):
            raw[rng.choice(N, N // frac, replace=False)] = v
    return torch.from_numpy(raw)


@pytest.mark.parametrize("k", [1, N // 2 + 17, N])
@pytest.mark.parametrize("case", ["random", "ties", "zeros", "signed_zeros",
                                  "nan"])
def test_digit_radix_equals_count_radix(case, k):
    bits = _score_vector(case)
    t, n_take = tk.radix_threshold_plain(bits, k)
    rt, rn = tk._radix_threshold(lambda c: tk._count_bits(bits, c), k,
                                 bits.device)
    assert (int(t), int(n_take)) == (int(rt), int(rn))
    assert t.dtype == torch.int32 and n_take.dtype == torch.int64
    # the selection the pair makes keeps k coordinates where the k-th
    # largest score is not negative
    sel = tk._select_mask(bits, t, n_take)
    if int((bits >= 0).sum()) >= k and int(t) != 2 ** 31 - 1:
        assert int(sel.sum()) == k


def test_digit_pick_and_histogram_plain():
    """The pick takes the largest bin whose count at or above it reaches
    k; bin 0 when fewer keys than k; the top bin at k = 0."""
    hist = torch.tensor([5, 0, 3, 2], dtype=torch.int32)
    for k_rem, want in ((1, (3, 0)), (2, (3, 0)), (3, (2, 2)), (5, (2, 2)),
                        (6, (0, 5)), (10, (0, 5)), (11, (0, 5)),
                        (0, (3, 0))):
        b, above = tk.digit_pick_plain(hist, k_rem)
        assert (int(b), int(above)) == want, k_rem
    bits = torch.tensor([0, 1 << 20, (3 << 20) + 5, (3 << 20) + 9, -7],
                        dtype=torch.int32)
    assert tk.digit_histogram_plain(bits, 0, 20, 11)[:4].tolist() == [
        2, 1, 0, 2]
    assert tk.digit_histogram_plain(bits, 3, 9, 11)[0].item() == 2


def _tables(case, c_eff, r):
    rng = np.random.RandomState(r)
    if case == "ties":
        return rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.float32),
                          size=(r, c_eff))
    t = rng.randn(r, c_eff).astype(np.float32)
    if case == "nan_zeros":
        t[rng.rand(r, c_eff) < 0.3] = 0.0
        t[rng.rand(r, c_eff) < 0.2] = -0.0
        t[rng.rand(r, c_eff) < 0.002] = np.nan
    return t


@pytest.mark.parametrize("case,d,c,r,k", [
    ("random", 20_000, 1_000, 5, 300),
    ("ties", 20_000, 640, 3, 2_500),
    ("nan_zeros", 12_000, 700, 5, 400),
])
def test_unsketch_select_dense_bitwise_vs_reference(case, d, c, r, k):
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    table = _tables(case, t.c_eff, r)
    with jtk.force_dispatch("kernel"):
        ref_masked, ref_mask = jtk.unsketch_select_pallas(
            j, jnp.asarray(table), k=k, interpret=True)
    masked, mask = tk.unsketch_select(t, torch.from_numpy(table), k)
    np.testing.assert_array_equal(_bits(masked), _bits(ref_masked))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    # the compacted survivors are the dense selection's, in index order
    vals, idxs = tk.unsketch_compact(t, torch.from_numpy(table), k)
    sel = torch.nonzero(mask).flatten()
    assert torch.equal(idxs[:sel.shape[0]], sel)
    np.testing.assert_array_equal(_bits(vals[:sel.shape[0]]),
                                  _bits(masked[sel]))


@pytest.mark.parametrize("d,c,r,k", [(20_000, 1_000, 5, 400),
                                     (9_000, 512, 3, 1)])
def test_compact_route_bitwise_vs_reference_chain(d, c, r, k):
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    rng = np.random.RandomState(d)
    x = (rng.randn(d) * 0.01).astype(np.float32)
    x[rng.choice(d, 200, replace=False)] = rng.randn(200).astype(
        np.float32) * 5
    table = np.array(j.sketch_vec(jnp.asarray(x)))
    rv, ri = jtk.values_indices_from_mask(
        *jtk.unsketch_select_pallas(j, jnp.asarray(table), k=k,
                                    interpret=True), k)
    gv, gi = t.unsketch_values_indices(torch.from_numpy(table), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(gv), _bits(rv))


def test_compact_select_fills_unfilled_slots_as_the_mask_chain():
    """Fewer survivors than k (n_take below the ties there are): the
    unfilled slots hold index 0 and the masked value at 0, exactly as the
    cumsum compaction leaves them, and the sort then agrees bitwise."""
    rng = np.random.RandomState(5)
    est = torch.from_numpy(rng.choice(np.array([-2, -1, 1, 2, 0.5],
                                               np.float32), size=3_000))
    bits = tk._score_bits(est)
    for t_val, n_take, k in ((int(bits.max()), -3, 50),
                             (int(tk._score_bits(torch.tensor(1.0))), 0,
                              3_000),
                             (int(tk._score_bits(torch.tensor(1.0))), 7,
                              3_000)):
        t = torch.tensor(t_val, dtype=torch.int32)
        nt = torch.tensor(n_take, dtype=torch.int64)
        vals, idxs = tk.select_compact_plain(est, t, nt, k)
        masked, mask = tk._select_est(est, t, nt)
        ref = tk.values_indices_from_mask(masked, mask, k)
        got = tk.order_by_score(vals, idxs)
        assert torch.equal(got[1], ref[1])
        np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))


def _colliding(cs, n_extra, seed):
    """Indices whose first three share row 0's bucket, then ``n_extra``
    others; values whose signed row-0 updates there are 1e8, 1, -1e8."""
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.permutation(cs.d)[:4_000].astype(np.int64))
    _, buckets = cs._row_hashes(0, ids)
    b, counts = torch.unique(buckets, return_counts=True)
    hot = b[counts >= 3][0]
    three = ids[buckets == hot][:3]
    rest = ids[~torch.isin(ids, three)][:n_extra]
    idx = torch.cat([three, rest])
    signs, _ = cs._row_hashes(0, three)
    vals = np.concatenate([
        (np.array([1e8, 1.0, -1e8], np.float32) * signs.numpy()),
        rng.randn(n_extra).astype(np.float32)]).astype(np.float32)
    return idx, torch.from_numpy(vals), int(hot)


def test_sketch_sparse_order_sensitive_collisions_bitwise():
    d, c, r = 50_000, 1_000, 5
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    idx, vals, hot = _colliding(t, 600, seed=1)
    for order in (np.arange(len(idx)), np.array([2, 1, 0] + list(
            range(3, len(idx))))):
        i, v = idx[order], vals[order]
        ref = np.asarray(j.sketch_sparse(jnp.asarray(v.numpy()),
                                         jnp.asarray(i.numpy().astype(
                                             np.int32))))
        got = t.sketch_sparse(v, i)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the order decides the bucket: (1e8 + 1) - 1e8 = 0 in float32, while
    # (1e8 - 1e8) + 1 = 1
    swapped = idx[[0, 2, 1] + list(range(3, len(idx)))]
    sv = vals[[0, 2, 1] + list(range(3, len(idx)))]
    a = t.sketch_sparse(vals, idx)[0, hot]
    b = t.sketch_sparse(sv, swapped)[0, hot]
    assert float(a) != float(b)


def test_radix_wrappers_refuse_other_devices():
    """Off the CPU, the new entries launch their kernels or raise: no
    fallback to the plain versions."""
    from commefficient_tpu_torch.ops.sketch_kernels import segment_sum
    t = CountSketch(d=1_000, c=300, r=3, seed=42)
    table = torch.zeros((3, t.c_eff), device="meta")
    for fn in (tk.unsketch_select, tk.unsketch_compact):
        with pytest.raises(ValueError, match="device"):
            fn(t, table, 10)
    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        segment_sum(torch.zeros(8, device="meta"), keys,
                    torch.zeros(4, device="meta"))
