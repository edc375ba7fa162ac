"""The arithmetic of the redesigned sketch and estimates kernels
(``csrc/sketch.cu``, ``csrc/estimates.cu``, ``csrc/countsketch.cuh``),
emulated on the CPU against the plain versions and the JAX reference.

* ``CountSketch.kernel_tables``: each packed entry ``(block << 7) | mask``
  decodes to ``_block_hashes``' block ids and lane masks, ascending within
  each window, and ``entry ^ lane`` is the coordinate the lane reads;
* the kernel's walk (each window's entries added in list order, U at a
  time, the lanes whose coordinate lies outside x adding 0.0, the list
  padded with the all-ones sentinel) is BITWISE ``sketch_vec_plain`` and
  the reference's ``sketch_vec_pallas`` in interpret mode, at a block
  offset and a partial last block;
* the median on order-preserving int32 keys with one NaN test is BITWISE
  the port's ``_median_small`` for r = 1, 3, 5, over +-0.0, +-inf,
  denormals and NaNs with payloads, and the reference's wherever XLA's CPU
  backend keeps the inputs (NaN results: NaN on both). XLA's CPU min/max
  flush denormals to zero, which the card's integer min/max and the
  port's plain version do not, so columns with a denormal input are held
  to the port's plain version alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import sketch_kernels as jsk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu.ops.countsketch import _median_small as jax_median
from commefficient_tpu_torch.ops import countsketch as tcs
from commefficient_tpu_torch.ops.sketch_kernels import sketch_vec_plain


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _decode(tabs, row):
    """(block ids, lane masks) of row's packed list."""
    p = tabs.packed[row].long() & 0xFFFFFFFF
    return p >> 7, p & 127


@pytest.mark.parametrize("d,c,r", [(50_000, 2_000, 3),
                                   (20_000, 1_000, 5), (9_000, 512, 1)])
def test_packed_lists(d, c, r):
    cs = tcs.CountSketch(d=d, c=c, r=r, seed=42)
    tabs = cs.kernel_tables("cpu")
    assert tabs.packed.shape == (r, cs.nblocks)
    assert tabs.win_ptr.shape == (r, cs.nwindows + 1)
    lanes = torch.arange(128)
    for row in range(r):
        blocks, masks = _decode(tabs, row)
        base, lanemask = cs._block_hashes(row, torch.arange(cs.nblocks))
        assert torch.equal(masks, lanemask[blocks])
        assert torch.equal(torch.sort(blocks).values,
                           torch.arange(cs.nblocks))
        # entry ^ lane: the coordinate lane l of the block reads
        p = tabs.packed[row].long() & 0xFFFFFFFF
        assert torch.equal(p[:, None] ^ lanes,
                           blocks[:, None] * 128 + (lanes ^ masks[:, None]))
        ptr = tabs.win_ptr[row].long()
        assert int(ptr[0]) == 0 and int(ptr[-1]) == cs.nblocks
        for w in range(cs.nwindows):
            members = blocks[ptr[w]:ptr[w + 1]]
            assert torch.all(base[members] == w)
            assert torch.all(members[1:] > members[:-1])


def test_packed_lists_refuse_more_blocks_than_the_entry_holds():
    cs = tcs.CountSketch(d=1_000, c=300, r=1, seed=42)
    cs.nblocks = 2 ** 25
    with pytest.raises(ValueError, match="2\\*\\*25"):
        cs.kernel_tables("cpu")


NO_ENTRY = 0xFFFFFFFF


def walked_sketch(cs, x: torch.Tensor, block_offset: int,
                  unroll: int = 4) -> torch.Tensor:
    """The kernel's walk, in torch and uint32 arithmetic: per (row,
    window), the list in steps of 32 entries padded with the sentinel,
    ``unroll`` at a time; lane l of entry p reads coordinate ``p ^ l``,
    whose offset in x, ``(p ^ l) - origin`` mod 2**32, must be below n,
    else it adds 0.0; the signed values are added in list order."""
    tabs = cs.kernel_tables("cpu")
    n = x.shape[0]
    origin = block_offset * 128
    lanes = torch.arange(128)
    out = torch.zeros((cs.r, cs.nwindows, 128), dtype=torch.float32)
    for row in range(cs.r):
        p_all = tabs.packed[row].long() & 0xFFFFFFFF
        ptr = tabs.win_ptr[row].long()
        for w in range(cs.nwindows):
            entries = p_all[ptr[w]:ptr[w + 1]]
            pad = -len(entries) % unroll
            entries = torch.cat([entries, torch.full((pad,), NO_ENTRY)])
            acc = torch.zeros(128)
            for p in entries:
                idx = p ^ lanes
                i = (idx - origin) & 0xFFFFFFFF
                inside = i < n
                xv = torch.where(inside, x[i.clamp(0, n - 1)],
                                 torch.zeros(()))
                acc = acc + xv * cs._row_signs(row, idx)
            out[row, w] = acc
    return out.reshape(cs.r, cs.c_eff)


@pytest.mark.parametrize("d,c,r,off,cut", [
    (20_000, 1_000, 5, 0, 0),
    (20_000, 1_000, 5, 11, 300),    # offset slice, partial last block
    (9_000, 300, 3, 2, 77),
    (5_000, 512, 1, 0, 0)])
def test_walk_equals_plain_and_reference_kernel(d, c, r, off, cut):
    x = np.random.RandomState(d + off).randn(d - off * 128 - cut).astype(
        np.float32)
    cs = tcs.CountSketch(d=d, c=c, r=r, seed=42)
    got = walked_sketch(cs, torch.from_numpy(x), off)
    plain = sketch_vec_plain(cs, torch.from_numpy(x), off)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    j = JaxCS(d=d, c=c, r=r, seed=42)
    with jsk.force_dispatch("kernel"):
        ref = jsk.sketch_vec_pallas(j, jnp.asarray(x), interpret=True,
                                    block_offset=off)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _key(bits: np.ndarray) -> np.ndarray:
    """int32 key of float bits, ``bits ^ ((bits >> 31) & 0x7FFFFFFF)``
    (arithmetic shift); its own inverse."""
    return bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))


def key_median(rows: np.ndarray) -> np.ndarray:
    """``cs::median<R>`` of (R, n) float32 rows, in numpy int32: r = 1
    returns row 0 as it is; r = 3, 5 run XLA's networks as integer
    min/max on keys and give the canonical NaN where any input is NaN."""
    r = rows.shape[0]
    if r == 1:
        return rows[0].copy()
    k = [_key(v.view(np.int32)) for v in rows]
    mn, mx = np.minimum, np.maximum
    if r == 3:
        m = mx(mn(k[0], k[1]), mn(mx(k[0], k[1]), k[2]))
    else:
        jj = mx(mn(k[0], k[1]), mn(k[2], k[3]))
        kk = mn(mx(k[0], k[1]), mx(k[2], k[3]))
        m = mx(mn(jj, kk), mn(mx(jj, kk), k[4]))
    out = _key(m.astype(np.int32)).view(np.float32)
    return np.where(np.isnan(rows).any(axis=0),
                    np.int32(0x7FC00000).view(np.float32), out)


_SPECIAL = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x3F800000, 0xBF800000, 0x7FC00000, 0xFFC00000,
                     0x7FA00001, 0xFF812345, 0x7F7FFFFF, 0xFF7FFFFF],
                    np.uint32).view(np.float32)


@pytest.mark.parametrize("r", [1, 3, 5])
def test_key_median_equals_median_small(r):
    """Every r-tuple of a small special set (all of them for r = 1, 3; a
    seeded sample for r = 5), plus seeded normals with planted specials:
    bitwise the port's ``_median_small`` (whose NaN is canonical), and
    the reference's where it is not NaN (NaN where it is) on the columns
    without a denormal input."""
    rng = np.random.RandomState(r)
    if r < 5:
        grid = np.stack(np.meshgrid(*([_SPECIAL] * r), indexing="ij"))
        grid = grid.reshape(r, -1)
    else:
        grid = _SPECIAL[rng.randint(0, len(_SPECIAL), (r, 20_000))]
    normals = rng.randn(r, 20_000).astype(np.float32)
    planted = rng.rand(r, 20_000) < 0.1
    normals[planted] = _SPECIAL[rng.randint(0, len(_SPECIAL),
                                            planted.sum())]
    rows = np.concatenate([grid, normals], axis=1)
    got = key_median(rows)
    port = tcs._median_small(list(torch.from_numpy(rows))).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(port))
    ref = np.asarray(jax.jit(lambda v: jax_median(list(v)))(
        jnp.asarray(rows)))
    mag = rows.view(np.int32) & 0x7FFFFFFF
    kept = ~((mag > 0) & (mag < 0x00800000)).any(axis=0)
    assert kept.sum() > 10_000 and (~kept).sum() > 100
    np.testing.assert_array_equal(np.isnan(got[kept]), np.isnan(ref[kept]))
    ok = kept & ~np.isnan(ref)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(ref[ok]))
    if r == 1:   # payloads and all
        np.testing.assert_array_equal(_bits(got), _bits(rows[0]))
