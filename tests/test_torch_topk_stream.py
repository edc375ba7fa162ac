"""The port's streaming top-k (plain and resid sources, per-row k) and
estimates against the JAX reference on the CPU, all BITWISE:

* ``topk(vec, k, row_k)`` for 1-D and 2-D input against the reference's
  ``topk`` in both dispatch modes (the Pallas kernels in interpret mode,
  and the ``lax.top_k`` chain), with ties planted across 8,192-element
  tiles, an all-zero row and per-row ``kk`` of k, k/2 and 1; the port's
  stable-sort route (``use_kernel=False``) too;
* the plain count and select against the reference's batched count and
  select kernels, row by row, at a length that is not a multiple of a
  tile;
* ``fused_true_topk`` against ``fused_true_topk_pallas`` at rho = 0.5,
  where every product is exact, including selected 0.0 and -0.0 that keep
  their residuals; at rho = 0.9 within the FMA tolerance of ROADMAP C2;
* ``estimates`` against ``estimates_pallas``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import sketch_kernels as jsk
from commefficient_tpu.ops import topk_kernels as jtk
from commefficient_tpu.ops.countsketch import CountSketch as JaxCS
from commefficient_tpu.ops.topk import topk as jax_topk
from commefficient_tpu.ops.topk import topk_values_indices as jax_tvi
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.sketch_kernels import estimates
from commefficient_tpu_torch.ops.topk import topk, topk_values_indices

N = 20_000   # three 8,192-element tiles, the last one partial


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _rows(seed, B=4, n=N):
    """Row 0: ties at 1.5 spread over every tile; row 1: all zeros (every
    score ties at bits 0); row 2: ties at -2.5; row 3: plain normals."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n).astype(np.float32)
    x[0, rng.choice(n, 3_000, replace=False)] = 1.5
    x[1] = 0.0
    if B > 2:
        x[2, rng.choice(n, 2_000, replace=False)] = -2.5
    return x


@pytest.mark.parametrize("dispatch", ["kernel", "fallback"])
@pytest.mark.parametrize("case", ["1d", "1d_kk1", "2d_row_k"])
def test_topk_matches_reference_bitwise(case, dispatch):
    k = 300
    if case == "2d_row_k":
        x = _rows(1)
        row_k = np.array([k, k // 2, 1, k], np.int32)
    else:
        x = _rows(2)[0]
        row_k = None if case == "1d" else np.int32(1)
    j_row_k = None if row_k is None else jnp.asarray(row_k)
    with jtk.force_dispatch(dispatch):
        ref = np.asarray(jax_topk(jnp.asarray(x), k, row_k=j_row_k))
    t_row_k = None if row_k is None else torch.as_tensor(row_k)
    got = topk(torch.from_numpy(x), k, row_k=t_row_k)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    by_sort = topk(torch.from_numpy(x), k, row_k=t_row_k, use_kernel=False)
    np.testing.assert_array_equal(_bits(by_sort), _bits(ref))
    if case == "2d_row_k":
        np.testing.assert_array_equal((got != 0).sum(1).numpy(),
                                      [k, 0, 1, k])


def test_topk_values_indices_kernel_route_matches_reference():
    x = _rows(3)[0]
    rv, ri = jax_tvi(jnp.asarray(x), 300, use_kernel=False)
    gv, gi = topk_values_indices(torch.from_numpy(x), 300)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(gv), _bits(rv))


def _padded(x):
    B, n = x.shape
    n_tiles = -(-n // tk.TILE_N)
    vp = np.zeros((B, n_tiles * tk.TILE_N), np.float32)
    vp[:, :n] = x
    return jnp.asarray(vp.reshape(B, -1, 128)), n_tiles


def test_plain_count_and_select_match_reference_batched_kernels():
    x = _rows(4)
    B, n = x.shape
    vp, n_tiles = _padded(x)
    kk = torch.tensor([300, 150, 1, 300])
    t, n_take = tk._radix_threshold_batched(
        lambda c: tk.count_rows(torch.from_numpy(x), c), kk, "cpu")
    cands = tk._wrap_i32(t.long()[:, None] + torch.arange(16) - 8)
    with jtk.force_dispatch("kernel"):
        ref_counts = jtk._count_call((vp,), jnp.asarray(cands.numpy()), n=n,
                                     n_tiles=n_tiles, interp=True,
                                     src="plain", batched=True)
        ref_masked, ref_mask = jtk._select_call(
            (vp,), jnp.asarray(t.numpy()),
            jnp.asarray(n_take.numpy().astype(np.int32)), n=n,
            n_tiles=n_tiles, interp=True, src="plain", batched=True,
            with_mask=True)
    np.testing.assert_array_equal(
        tk.count_rows(torch.from_numpy(x), cands).numpy(),
        np.asarray(ref_counts))
    masked, mask = tk.select_rows(torch.from_numpy(x), t, n_take,
                                  with_mask=True)
    np.testing.assert_array_equal(_bits(masked), _bits(ref_masked))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(mask.sum(1).numpy(), kk.numpy())


def _residual_inputs(seed, n=N):
    """Half the coordinates exactly zero (a quarter -0.0), so a k above
    the nonzero count selects zeros, which must keep their residuals."""
    rng = np.random.RandomState(seed)
    g, vv, ve = (rng.randn(n).astype(np.float32) for _ in range(3))
    z = rng.permutation(n)[: n // 2]
    g[z], vv[z], ve[z] = 0.0, 0.0, 0.0
    neg = z[: n // 4]
    g[neg], vv[neg], ve[neg] = -0.0, -0.0, -0.0   # err = -0.0 there
    tie = rng.choice(n, 500, replace=False)
    g[tie], vv[tie], ve[tie] = 1.0, 0.0, 0.5   # err = 1.5 on every tile
    return g, vv, ve


@pytest.mark.parametrize("k", [300, 12_000])
def test_fused_true_topk_bitwise_at_exact_momentum(k):
    g, vv, ve = _residual_inputs(k)
    with jtk.force_dispatch("kernel"):
        ref = jtk.fused_true_topk_pallas(jnp.asarray(g), jnp.asarray(vv),
                                         jnp.asarray(ve), k=k, rho=0.5,
                                         interpret=True)
    got = tk.fused_true_topk(torch.from_numpy(g), torch.from_numpy(vv),
                             torch.from_numpy(ve), k, 0.5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    upd, new_v, new_err = (a.numpy() for a in got)
    if k > N // 2:
        # a selected -0.0 is written to the update as -0.0, but it is no
        # support: its residuals stay
        sel_neg0 = (upd == 0) & np.signbit(upd)
        assert sel_neg0.any()
        assert np.signbit(new_err[sel_neg0]).all()
        assert np.signbit(new_v[sel_neg0]).all()
    assert (_bits(new_err)[upd != 0] == 0).all()


def test_fused_true_topk_fma_tolerance():
    """rho = 0.9: the reference's jitted ``g + rho*vv`` is one FMA, the
    port's rounds the product first (ROADMAP C2); the selected support
    agrees and every output is within an ulp of rho*vv plus one of each
    sum."""
    g, vv, ve = _residual_inputs(5)
    ref = [np.asarray(a) for a in jtk.fused_true_topk_pallas(
        jnp.asarray(g), jnp.asarray(vv), jnp.asarray(ve), k=300, rho=0.9,
        interpret=True)]
    got = [a.numpy() for a in tk.fused_true_topk(
        torch.from_numpy(g), torch.from_numpy(vv), torch.from_numpy(ve),
        300, 0.9)]
    np.testing.assert_array_equal(got[0] != 0, ref[0] != 0)
    v = np.abs(g) + np.abs(np.float32(0.9) * vv)
    tol = (np.spacing(np.abs(np.float32(0.9) * vv)) + np.spacing(v)
           + np.spacing(v + np.abs(ve)))
    for a, b in zip(got, ref):
        assert np.all(np.abs(a - b) <= tol)


@pytest.mark.parametrize("d,c,r", [(20_000, 1_000, 5), (9_000, 512, 3),
                                   (5_000, 300, 1)])
def test_estimates_bitwise_vs_reference_kernel(d, c, r):
    rng = np.random.RandomState(d)
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    table = rng.randn(r, cs.c_eff).astype(np.float32)
    table[:, ::7] = -0.0
    with jsk.force_dispatch("kernel"):
        ref = jsk.estimates_pallas(JaxCS(d=d, c=c, r=r, seed=42),
                                   jnp.asarray(table), interpret=True)
    np.testing.assert_array_equal(
        _bits(estimates(cs, torch.from_numpy(table))), _bits(ref))


def test_server_fused_off_route_matches_fused_route():
    d, c, r, k = 20_000, 1_000, 5, 400
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    table = torch.from_numpy(
        np.random.RandomState(6).randn(r, cs.c_eff).astype(np.float32))
    fused = cs.unsketch_values_indices(table, k)
    off = cs.unsketch_values_indices(table, k, fused=False)
    for a, b in zip(fused, off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_stream_wrappers_refuse_other_devices():
    x = torch.zeros((2, 100), device="meta")
    with pytest.raises(ValueError, match="device"):
        tk.count_rows(x, torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        tk.select_rows(x, torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="device"):
        tk.select_resid(x[0], x[0], torch.zeros(()), torch.zeros(()))
    cs = CountSketch(d=1_000, c=300, r=3, seed=42)
    with pytest.raises(ValueError, match="device"):
        estimates(cs, torch.zeros((3, cs.c_eff), device="meta"))
