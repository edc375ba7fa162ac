"""The port's batched CountSketch (``sketch_vec_batched``, the batched 2-D
grid of the reference's ``_sketch_kernel``) and the stacked
``l2estimate`` against the JAX reference on the CPU.

* ``sketch_vec_batched`` (its plain version, a CPU tensor) against the
  reference's ``jax.vmap`` of ``sketch_range``: BITWISE for r in {1, 3,
  5}, block offsets 0 and 7, a tail tile with a partial last block, an
  all-zero row, and a zero-length slice; and row by row bitwise equal to
  the unbatched ``sketch_vec``;
* ``CountSketch.l2estimate`` over a ``(B, r, c_eff)`` stack against the
  reference's per-table estimate, r in {2, 5}: rtol 1e-6 (the row sums
  of squares reassociate), bitwise on integer tables whose sums are exact;
* both wrappers' range and device checks, and the kernel A/B timing tool's
  reading of a checkout's launch interface.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.sketch_kernels import (
    sketch_vec, sketch_vec_batched, sketch_vec_batched_plain)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("offset_blocks", [0, 7])
def test_sketch_batched_matches_jax_vmap_bitwise(r, offset_blocks):
    """d is chosen so the chunk ends on a tail tile and a partial last
    block (mirrors the reference's batched-kernel sweep)."""
    d, c = 9_999, 1_111
    jcs, cs = (cls(d=d, c=c, r=r, seed=5) for cls in (JaxCS, CountSketch))
    rng = np.random.RandomState(40 + r)
    off = offset_blocks * 128
    n = min(4_000, d - off)
    chunks = rng.randn(4, n).astype(np.float32)
    chunks[2] = 0.0                                    # an all-zero row
    ref = jax.vmap(lambda v: jcs.sketch_range(v, off))(jnp.asarray(chunks))
    got = sketch_vec_batched(cs, torch.from_numpy(chunks), offset_blocks)
    assert got.shape == (4, r, cs.c_eff)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert not got[2].any()
    for b in range(4):
        np.testing.assert_array_equal(
            _bits(got[b]),
            _bits(sketch_vec(cs, torch.from_numpy(chunks[b]),
                             offset_blocks)))


def test_sketch_batched_full_vector_and_empty_slices():
    d = 1_500
    jcs, cs = (cls(d=d, c=256, r=3, seed=2) for cls in (JaxCS, CountSketch))
    vecs = np.random.RandomState(6).randn(3, d).astype(np.float32)
    ref = jax.vmap(jcs.sketch_vec)(jnp.asarray(vecs))
    got = sketch_vec_batched(cs, torch.from_numpy(vecs))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # n = 0 and B = 0 give zero tables of the batch's shape
    empty = torch.zeros((3, 0))
    np.testing.assert_array_equal(
        sketch_vec_batched(cs, empty).numpy(),
        np.zeros((3, cs.r, cs.c_eff), np.float32))
    assert sketch_vec_batched_plain(cs, torch.zeros((0, d))).shape == (
        0, cs.r, cs.c_eff)
    with pytest.raises(ValueError, match="outside"):
        sketch_vec_batched(cs, torch.ones((2, 256)), 11)


@pytest.mark.parametrize("r", [2, 5])
def test_l2estimate_stack_matches_jax(r):
    d = 20_000
    jcs, cs = (cls(d=d, c=1_000, r=r, seed=3) for cls in (JaxCS,
                                                          CountSketch))
    rng = np.random.RandomState(r)
    tables = (rng.randn(4, r, cs.c_eff) * rng.rand(4, 1, 1) * 3).astype(
        np.float32)
    ref = np.asarray(jax.vmap(jcs.l2estimate)(jnp.asarray(tables)))
    got = cs.l2estimate(torch.from_numpy(tables))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    # one table alone is the stack's row
    assert float(cs.l2estimate(torch.from_numpy(tables[1]))) == float(got[1])
    # integer entries: every row sum of squares is exact in any order
    ints = rng.randint(-4, 5, (4, r, cs.c_eff)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(cs.l2estimate(torch.from_numpy(ints))),
        _bits(jax.vmap(jcs.l2estimate)(jnp.asarray(ints))))
    # the estimate of a sketched vector tracks its norm
    vec = rng.randn(2, d).astype(np.float32)
    est = cs.l2estimate(sketch_vec_batched(cs, torch.from_numpy(vec)))
    np.testing.assert_allclose(est.numpy(), np.linalg.norm(vec, axis=1),
                               rtol=0.1)


def test_wrappers_check_the_range_and_refuse_other_devices():
    """Both wrappers refuse a slice past d on any device, and a tensor on
    a device that is neither the CPU nor CUDA."""
    cs = CountSketch(d=1_000, c=300, r=3, seed=42)
    with pytest.raises(ValueError, match="outside"):
        sketch_vec(cs, torch.zeros(200), block_offset=7)
    with pytest.raises(ValueError, match="outside"):
        sketch_vec_batched(cs, torch.zeros(2, 1_001))
    with pytest.raises(ValueError, match="device"):
        sketch_vec_batched(cs, torch.zeros(2, 1_000, device="meta"))


def test_ab_tool_reads_the_launch_interface_and_needs_a_card(tmp_path,
                                                             monkeypatch):
    """The A/B timing tool reads which ``sketch_launch`` interface a
    checkout's source has, and exits 1 without a card."""
    from pathlib import Path

    from commefficient_tpu_torch.tools import sketch_ab
    src = Path(sketch_ab.__file__).resolve().parents[1] / "csrc" / \
        "sketch.cu"
    assert sketch_ab._BATCHED.search(src.read_text())
    assert not sketch_ab._BATCHED.search(
        'extern "C" int sketch_launch(const void* x, long long n,')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sketch_ab.main(["--parent", str(tmp_path)]) == 1
