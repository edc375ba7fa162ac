"""The port's fused unsketch + exact top-k against the JAX reference on the
CPU: ``unsketch_select`` (masked estimates and mask) is BITWISE equal to
the reference's Pallas ``unsketch_select_pallas`` run in interpret mode,
including planted duplicate magnitudes whose ties cross tile boundaries;
the plain count equals the reference's count kernel; the compaction to
(values, indices) and the dense top-k keep ``lax.top_k``'s order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import topk_kernels as jtk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu.ops.topk import topk as jax_topk
from commefficient_tpu.ops.topk import topk_values_indices as jax_tvi
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.topk import topk, topk_values_indices


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _sketched_table(d, c, r, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(d) * 0.01).astype(np.float32)
    hot = rng.choice(d, 200, replace=False)
    x[hot] = rng.randn(200).astype(np.float32) * 5
    return np.array(JaxCS(d=d, c=c, r=r, seed=42).sketch_vec(
        jnp.asarray(x)))


def _tied_table(c_eff, r, seed):
    """Few distinct magnitudes: the medians tie massively, and the ties at
    the threshold spread over every tile."""
    rng = np.random.RandomState(seed)
    return rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.float32),
                      size=(r, c_eff))


def _reference(j, table, k):
    with jtk.force_dispatch("kernel"):
        masked, mask = jtk.unsketch_select_pallas(j, jnp.asarray(table),
                                                  k=k, interpret=True)
    return np.asarray(masked), np.asarray(mask)


@pytest.mark.parametrize("case,d,c,r,k", [
    ("sketched", 20_000, 1_000, 5, 300),
    ("ties", 20_000, 640, 1, 4_000),
    ("ties", 20_000, 640, 3, 2_500),
    ("ties", 20_000, 640, 5, 700),
    ("sketched", 9_000, 512, 3, 1),
])
def test_unsketch_select_bitwise_vs_reference_kernel(case, d, c, r, k):
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    table = (_sketched_table(d, c, r, seed=d + r) if case == "sketched"
             else _tied_table(t.c_eff, r, seed=r))
    ref_masked, ref_mask = _reference(j, table, k)
    masked, mask = tk.unsketch_select(t, torch.from_numpy(table), k)
    np.testing.assert_array_equal(_bits(masked), _bits(ref_masked))
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    assert int(mask.sum()) == k
    if case == "ties":
        # the threshold is contested: more equal scores than slots left,
        # spread over several 8,192-coordinate tiles
        est = t.estimates(torch.from_numpy(table))
        kept = est[mask.bool()]
        t_sq = float((kept * kept).min())
        tied = torch.nonzero(est * est == t_sq).flatten()
        assert len(tied) > int(((kept * kept) == t_sq).sum())
        assert len(set((tied // tk.TILE_N).tolist())) > 1


def test_plain_count_equals_reference_count_kernel():
    d, c, r = 20_000, 1_000, 5
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    table = _sketched_table(d, c, r, seed=7)
    est = t.estimates(torch.from_numpy(table))
    bits = (est * est).view(torch.int32)
    mid = int(torch.sort(bits).values[d // 2])
    cands = np.arange(16, dtype=np.int32) * 4096 + mid - 8 * 4096
    n_tiles = -(-t.nblocks // 64)
    with jtk.force_dispatch("kernel"):
        ref = jtk._count_call((jnp.asarray(table),), jnp.asarray(cands),
                              n=d, n_tiles=n_tiles, interp=True, src="est",
                              cs=j)
    got = tk.count_plain(t, torch.from_numpy(table), torch.from_numpy(cands))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plain_select_and_count_compose_to_unsketch_select():
    d, c, r, k = 12_000, 700, 3, 150
    t = CountSketch(d=d, c=c, r=r, seed=42)
    table = torch.from_numpy(_tied_table(t.c_eff, r, seed=11))
    tt, n_take = tk._radix_threshold(lambda cands: tk.count(t, table, cands),
                                     k, table.device)
    masked, mask = tk.select(t, table, tt, n_take)
    ref_masked, ref_mask = tk.unsketch_select_plain(t, table, k)
    np.testing.assert_array_equal(_bits(masked), _bits(ref_masked))
    np.testing.assert_array_equal(mask.numpy(), ref_mask.numpy())


def test_values_indices_from_mask_bitwise_order():
    """(-score, index) order, incl. k above the selected count (unfilled
    slots index 0 as in the reference)."""
    rng = np.random.RandomState(9)
    d = 5_000
    v = rng.choice(np.array([-2, -1, 1, 2, 0.5], np.float32), size=d)
    for k, n_sel in ((300, 300), (300, 250)):
        sel = np.zeros(d, np.int32)
        sel[rng.choice(d, n_sel, replace=False)] = 1
        masked = np.where(sel == 1, v, 0).astype(np.float32)
        rv, ri = jtk.values_indices_from_mask(jnp.asarray(masked),
                                              jnp.asarray(sel), k)
        gv, gi = tk.values_indices_from_mask(torch.from_numpy(masked),
                                             torch.from_numpy(sel), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(_bits(gv), _bits(rv))


def test_unsketch_values_indices_matches_reference_chain():
    d, c, r, k = 20_000, 1_000, 5, 400
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = CountSketch(d=d, c=c, r=r, seed=42)
    table = _sketched_table(d, c, r, seed=3)
    rv, ri = j.unsketch_values_indices(jnp.asarray(table), k)
    gv, gi = t.unsketch_values_indices(torch.from_numpy(table), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(gv), _bits(rv))
    dense = t.unsketch(torch.from_numpy(table), k)
    np.testing.assert_array_equal(
        _bits(dense), _bits(j.unsketch(jnp.asarray(table), k)))


@pytest.mark.parametrize("shape,k", [((20_000,), 200), ((20_000,), 1),
                                     ((3, 4_000), 50)])
def test_topk_stable_ties_match_lax_top_k(shape, k):
    rng = np.random.RandomState(k)
    x = rng.randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    ties = rng.choice(flat.size, flat.size // 10, replace=False)
    flat[ties] = np.where(rng.rand(len(ties)) < 0.5, 1.5, -1.5)
    rv, ri = jax_tvi(jnp.asarray(x), k, use_kernel=False)
    gv, gi = topk_values_indices(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(gv), _bits(rv))
    np.testing.assert_array_equal(
        _bits(topk(torch.from_numpy(x), k)),
        _bits(jax_topk(jnp.asarray(x), k, use_kernel=False)))


def test_wrap_i32_is_twos_complement():
    x = torch.tensor([0, 8 << 28, 15 << 28, 2**31 - 1, -1, 2**32 + 5])
    assert tk._wrap_i32(x).tolist() == [0, -2**31, -(1 << 28), 2**31 - 1,
                                        -1, 5]


def test_kernel_wrappers_refuse_other_devices():
    t = CountSketch(d=1_000, c=300, r=3, seed=42)
    table = torch.zeros((3, t.c_eff), device="meta")
    with pytest.raises(ValueError, match="device"):
        tk.count(t, table, torch.zeros(16, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="device"):
        tk.select(t, table, torch.zeros((), dtype=torch.int32),
                  torch.zeros((), dtype=torch.int64))
