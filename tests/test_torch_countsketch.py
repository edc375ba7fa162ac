"""The PyTorch port's tiled CountSketch against the JAX reference, on the
CPU: hash coefficients, signs and block hashes (also at ids near the 2**32
wraparound), the dense sketch (with and without a block offset), the
estimates and the sparse sketch are all BITWISE equal. The port's sketch
here is its kernel's plain version (a CPU tensor); the reference runs its
XLA formulation and, for one case, its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import sketch_kernels as jsk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu.ops.countsketch import _hash_coeffs as jax_coeffs
from commefficient_tpu.ops.countsketch import _median_small as jax_median
from commefficient_tpu_torch.ops import countsketch as tcs
from commefficient_tpu_torch.ops.sketch_kernels import sketch_vec


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _assert_bitwise(got, ref):
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("seed,r", [(42, 5), (0, 1), (7, 3), (42, 8)])
def test_hash_coeffs_identical(seed, r):
    assert tcs._hash_coeffs(seed, r) == jax_coeffs(seed, r)


_WRAP_IDS = np.array([0, 1, 127, 128, 2**31 - 1, 2**31, 2**31 + 1,
                      2**32 - 129, 2**32 - 128, 2**32 - 2, 2**32 - 1],
                     np.uint32)


@pytest.mark.parametrize("r", [1, 3, 5])
def test_signs_and_hashes_bitwise_incl_wraparound(r):
    rng = np.random.RandomState(r)
    ids = np.concatenate([_WRAP_IDS, rng.randint(0, 2**32, 2000,
                                                 dtype=np.uint64)
                          .astype(np.uint32)])
    j = JaxCS(d=10_000, c=3_000, r=r, seed=42)
    t = tcs.CountSketch(d=10_000, c=3_000, r=r, seed=42)
    tid = torch.from_numpy(ids.astype(np.int64))
    for row in range(r):
        _assert_bitwise(t._row_signs(row, tid),
                        j._row_signs(row, jnp.asarray(ids)))
        jb, jm = j._block_hashes(row, jnp.asarray(ids))
        tb, tm = t._block_hashes(row, tid)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # flat buckets for in-range coordinate ids
    idx = rng.randint(0, 10_000, 500).astype(np.int32)
    for row in range(r):
        js, jbk = j._row_hashes(row, jnp.asarray(idx))
        ts, tbk = t._row_hashes(row, torch.from_numpy(idx))
        _assert_bitwise(ts, js)
        np.testing.assert_array_equal(tbk.numpy(), np.asarray(jbk))


@pytest.mark.parametrize("d,c,r,offset_blocks", [
    (20_000, 1_000, 5, 0), (20_000, 1_000, 5, 37), (777, 300, 3, 0),
    (9_000, 512, 1, 2)])
def test_sketch_range_bitwise(d, c, r, offset_blocks):
    rng = np.random.RandomState(d + r)
    n = d - offset_blocks * 128 - (d // 5 if offset_blocks else 0)
    x = rng.randn(n).astype(np.float32)
    x[::97] = 0.0
    x[1::89] = -0.0
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = tcs.CountSketch(d=d, c=c, r=r, seed=42)
    ref = j.sketch_range(jnp.asarray(x), offset_blocks * 128)
    got = t.sketch_range(torch.from_numpy(x), offset_blocks * 128)
    assert got.shape == (r, t.c_eff) == ref.shape
    _assert_bitwise(got, ref)


def test_sketch_matches_reference_pallas_kernel_with_offset():
    """The reference's own Pallas kernel (interpret mode) at a nonzero
    block offset, not only its XLA formulation."""
    d, c, r, off = 20_000, 1_000, 5, 11
    x = np.random.RandomState(5).randn(d - off * 128 - 300).astype(
        np.float32)
    j = JaxCS(d=d, c=c, r=r, seed=42)
    with jsk.force_dispatch("kernel"):
        ref = jsk.sketch_vec_pallas(j, jnp.asarray(x), interpret=True,
                                    block_offset=off)
    got = sketch_vec(tcs.CountSketch(d=d, c=c, r=r, seed=42),
                     torch.from_numpy(x), block_offset=off)
    _assert_bitwise(got, ref)


@pytest.mark.parametrize("d,c,r", [(20_000, 1_000, 5), (5_000, 4_000, 3),
                                   (3_000, 2_000, 1)])
def test_estimates_bitwise(d, c, r):
    """Includes empty table cells (c large against d), so +-0.0 estimates
    and their medians are compared bit for bit."""
    rng = np.random.RandomState(c)
    x = np.zeros(d, np.float32)
    hot = rng.choice(d, d // 10, replace=False)
    x[hot] = rng.randn(len(hot)).astype(np.float32)
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = tcs.CountSketch(d=d, c=c, r=r, seed=42)
    table = np.array(j.sketch_vec(jnp.asarray(x)))
    ref = j.estimates(jnp.asarray(table))
    got = t.estimates(torch.from_numpy(table))
    _assert_bitwise(got, ref)
    assert (np.asarray(ref) == 0).any()


@pytest.mark.parametrize("r", [3, 5])
def test_median_network_signed_zeros_and_nan(r):
    """XLA's min/max order -0.0 below +0.0 and propagate NaN, which
    torch.minimum/maximum do not: the port's network must match."""
    vals = np.array([-0.0, 0.0, np.nan, 1.0, -1.0], np.float32)
    grid = np.stack(np.meshgrid(*([vals] * r), indexing="ij")).reshape(r, -1)
    ref = jax.jit(lambda rows: jax_median(list(rows)))(jnp.asarray(grid))
    got = tcs._median_small(list(torch.from_numpy(grid)))
    ref, got = np.asarray(ref), got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(ref[ok]))


def test_sketch_sparse_bitwise_on_cpu():
    """Colliding buckets sum in update order in both packages on the CPU."""
    d, c, r, k = 20_000, 600, 5, 3_000
    rng = np.random.RandomState(3)
    vals = rng.randn(k).astype(np.float32)
    idx = rng.choice(d, k, replace=False).astype(np.int32)
    j = JaxCS(d=d, c=c, r=r, seed=42)
    t = tcs.CountSketch(d=d, c=c, r=r, seed=42)
    ref = j.sketch_sparse(jnp.asarray(vals), jnp.asarray(idx))
    got = t.sketch_sparse(torch.from_numpy(vals), torch.from_numpy(idx))
    _assert_bitwise(got, ref)


def test_l2estimate_matches():
    rng = np.random.RandomState(4)
    table = rng.randn(5, 1_024).astype(np.float32)
    j = JaxCS(d=50_000, c=1_000, r=5, seed=42)
    t = tcs.CountSketch(d=50_000, c=1_000, r=5, seed=42)
    np.testing.assert_allclose(float(t.l2estimate(torch.from_numpy(table))),
                               float(j.l2estimate(jnp.asarray(table))),
                               rtol=1e-6)


def test_geometry_and_refusals():
    t = tcs.CountSketch(d=6_568_640, c=500_000, r=5, seed=42)
    assert (t.c_eff, t.nblocks, t.nwindows) == (500_096, 51_318, 3_907)
    assert tcs.pad_cols(500_000) == 500_096
    g = tcs.CountSketch(d=100, c=10, r=1, scheme="global")
    assert g.c_eff == 10 and g.zero_table().shape == (1, 10)
    with pytest.raises(ValueError, match="'tiled' or 'global'"):
        tcs.CountSketch(d=100, c=10, r=1, scheme="blocked")
    with pytest.raises(ValueError, match="aligned"):
        t.sketch_range(torch.zeros(256), 5)


def test_kernel_tables_group_blocks_by_window_in_block_order():
    t = tcs.CountSketch(d=50_000, c=2_000, r=3, seed=42)
    tabs = t.kernel_tables("cpu")
    blk = torch.arange(t.nblocks)
    for row in range(t.r):
        base, _ = t._block_hashes(row, blk)
        ptr = tabs.win_ptr[row].long()
        blocks = (tabs.packed[row].long() & 0xFFFFFFFF) >> 7
        assert int(ptr[-1]) == t.nblocks
        for w in range(t.nwindows):
            members = blocks[ptr[w]:ptr[w + 1]]
            assert torch.all(base[members] == w)
            assert torch.all(members[1:] > members[:-1])


def test_wrappers_take_plain_on_cpu_and_refuse_other_devices():
    t = tcs.CountSketch(d=1_000, c=300, r=3, seed=42)
    with pytest.raises(ValueError, match="device"):
        sketch_vec(t, torch.zeros(1_000, device="meta"))
