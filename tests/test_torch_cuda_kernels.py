"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test here skips. On a
machine with one (and without JAX, so without the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each sketch and top-k kernel must equal its plain version bitwise at
small shapes, odd lengths (tails that are no multiple of a tile), a
nonzero block offset, per-row k and planted ties included (the sketch
also at B = 1, 3, 4, 8, 9, the estimates also on
tables with NaNs, +-0.0, +-inf and denormals at r = 1, 3, 5); the flash
attention kernels (the tensor-core forward, dq and dk/dv, and the first
port's scalar ones) match theirs within float32 rounding (O and lse atol
1e-5, gradients 1e-4 of their largest magnitude; bf16 2e-2), with and
without dropout, ragged T and D from 8 to 128, and are deterministic; the hardware-RNG dropout kernel
equals its plain version bitwise (float32 and bfloat16, a partial
logical block) and meets the reference's contract; the estimate-once
radix of the fused unsketch + top-k equals its plain versions pass by pass
(NaN, +-0.0 and all-zero tables included), and the sparse re-sketch's
segmented sum equals the CPU's bitwise; the per-row histogram radix of the
dense streams (plain and resid) equals its plain versions pass by pass, on
unaligned rows, a k = 0 row and NaN rows included. ``chip_smoke.py``
repeats this at the main paths' full width.
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops import flash_attention as fa
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.dropout import (fold_in, hw_dropout,
                                                 hw_dropout_plain, seed_words)
from commefficient_tpu_torch.ops.sketch_kernels import (
    estimates, estimates_batched, estimates_batched_plain, estimates_plain,
    sketch_vec, sketch_vec_batched, sketch_vec_batched_plain,
    sketch_vec_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d,c,r,off", [(20_000, 1_000, 5, 0),
                                       (20_000, 1_000, 5, 37),
                                       (777, 300, 3, 0), (9_000, 512, 1, 2)])
def test_sketch_kernel_equals_plain(dev, d, c, r, off):
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    n = d - off * 128 - (d // 7 if off else 0)
    x = torch.from_numpy(np.random.RandomState(d).randn(n).astype(
        np.float32)).to(dev)
    before = cuda_lib.LAUNCHES["sketch"]
    got = sketch_vec(cs, x, off)
    assert cuda_lib.LAUNCHES["sketch"] == before + 1
    assert _same_bits(got, sketch_vec_plain(cs, x, off))
    assert _same_bits(got, sketch_vec(cs, x, off))


@pytest.mark.parametrize("B,d,c,r,off", [(4, 20_000, 1_000, 5, 0),
                                         (9, 20_000, 1_000, 5, 37),
                                         (8, 777, 300, 3, 0),
                                         (1, 9_000, 512, 1, 2)])
def test_sketch_batched_kernel_equals_plain(dev, B, d, c, r, off):
    """B = 9 spans two tiles of the batch axis; row 0 is all zero."""
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    n = d - off * 128 - (d // 7 if off else 0)
    x = np.random.RandomState(d + B).randn(B, n).astype(np.float32)
    x[0] = 0.0
    x = torch.from_numpy(x).to(dev)
    before = cuda_lib.LAUNCHES["sketch_batched"]
    got = sketch_vec_batched(cs, x, off)
    assert cuda_lib.LAUNCHES["sketch_batched"] == before + 1
    assert got.shape == (B, r, cs.c_eff)
    assert _same_bits(got, sketch_vec_batched_plain(cs, x, off))
    assert _same_bits(got, sketch_vec_batched(cs, x, off))
    for b in range(B):
        assert _same_bits(got[b], sketch_vec(cs, x[b].contiguous(), off))
    assert not got[0].any()


@pytest.mark.parametrize("B", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("d,c,r,off", [(20_001, 1_000, 5, 0),
                                       (20_001, 1_000, 5, 37),
                                       (9_000, 300, 3, 2),
                                       (5_003, 512, 1, 0)])
def test_sketch_kernel_batches_equal_plain(dev, B, d, c, r, off):
    """The packed window lists at d no multiple of 128, a block offset and
    B = 1 (``sketch``) or a batch on the grid's slow axis
    (``sketch_batched``): bitwise the plain version, the same over two
    runs; row 0 all zero."""
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    n = d - off * 128 - (d // 7 if off else 0)
    x = np.random.RandomState(d + B).randn(B, n).astype(np.float32)
    x[0] = 0.0
    x = torch.from_numpy(x).to(dev)
    key = "sketch" if B == 1 else "sketch_batched"
    before = cuda_lib.LAUNCHES[key]
    if B == 1:
        got = sketch_vec(cs, x[0], off)[None]
        again = sketch_vec(cs, x[0], off)[None]
    else:
        got = sketch_vec_batched(cs, x, off)
        again = sketch_vec_batched(cs, x, off)
    assert cuda_lib.LAUNCHES[key] == before + 2
    assert _same_bits(got, sketch_vec_batched_plain(cs, x, off))
    assert _same_bits(got, again)
    assert not got[0].any()


@pytest.mark.parametrize("r,k,tied", [(5, 300, False), (3, 2_500, True),
                                      (1, 4_000, True), (5, 1, False)])
def test_count_and_select_kernels_equal_plain(dev, r, k, tied):
    d = 20_000
    cs = CountSketch(d=d, c=640, r=r, seed=42)
    rng = np.random.RandomState(r)
    if tied:
        table = rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.float32),
                           size=(r, cs.c_eff))
    else:
        table = rng.randn(r, cs.c_eff).astype(np.float32)
    table = torch.from_numpy(table).to(dev)
    t, n_take = tk._radix_threshold(
        lambda c: tk.count_plain(cs, table, c), k, dev)
    cands = tk._wrap_i32(t.long() + torch.arange(16, device=dev) - 8)
    assert torch.equal(tk.count(cs, table, cands),
                       tk.count_plain(cs, table, cands))
    got, ref = tk.select(cs, table, t, n_take), tk.select_plain(
        cs, table, t, n_take)
    assert _same_bits(got[0], ref[0]) and torch.equal(got[1], ref[1])
    masked, mask = tk.unsketch_select(cs, table, k)
    p_masked, p_mask = tk.unsketch_select_plain(cs, table, k)
    assert _same_bits(masked, p_masked) and torch.equal(mask, p_mask)
    assert int(mask.sum()) == k


def _tied_rows(B, n, seed):
    """Ties spread over every tile in rows 0 and 2, an all-zero row 1."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n).astype(np.float32)
    x[0, rng.choice(n, n // 7, replace=False)] = 1.5
    if B > 1:
        x[1] = 0.0
    if B > 2:
        x[2, rng.choice(n, n // 9, replace=False)] = -2.5
    return torch.from_numpy(x)


@pytest.mark.parametrize("B,n,kk", [(1, 20_001, [300]),
                                    (4, 30_000, [500, 250, 1, 500]),
                                    (8, 8_192 * 3 + 5,
                                     [100, 100, 50, 1, 100, 100, 100, 7])])
def test_plain_count_and_select_kernels_equal_plain(dev, B, n, kk):
    x = _tied_rows(B, n, seed=n).to(dev)
    kk = torch.tensor(kk, device=dev)
    t, n_take = tk._radix_threshold_batched(
        lambda c: tk.count_rows_plain(x, c), kk, dev)
    for cands in (tk._wrap_i32(torch.arange(16, device=dev) << 28).expand(
            B, 16).contiguous(),
            tk._wrap_i32(t.long()[:, None] + torch.arange(16, device=dev)
                         - 8)):
        assert torch.equal(tk.count_rows(x, cands),
                           tk.count_rows_plain(x, cands))
    for with_mask in (True, False):
        got = tk.select_rows(x, t, n_take, with_mask)
        ref = tk.select_rows_plain(x, t, n_take, with_mask)
        assert _same_bits(got[0], ref[0])
        if with_mask:
            assert torch.equal(got[1], ref[1])
            assert torch.equal(got[1].sum(1), kk)
    before = dict(cuda_lib.LAUNCHES)
    dense = tk.topk_select(x, kk, int(kk.max()))
    grew = {key: cuda_lib.LAUNCHES[key] - before.get(key, 0)
            for key in ("rows_hist", "rows_select", "count_plain",
                        "select_plain")}
    assert grew == {"rows_hist": 3, "rows_select": 1, "count_plain": 0,
                    "select_plain": 0}
    assert _same_bits(dense, tk.select_rows_plain(x, t, n_take)[0])


@pytest.mark.parametrize("n,k", [(20_001, 300), (40_000, 25_000)])
def test_resid_select_kernel_equals_plain(dev, n, k):
    rng = np.random.RandomState(k)
    g, vv, ve = (torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
                 for _ in range(3))
    zero = torch.from_numpy(rng.permutation(n)[: n // 2]).to(dev)
    for t_ in (g, vv, ve):   # selected -0.0 must keep their residuals
        t_[zero] = -0.0
    err = ve + (g + 0.9 * vv)
    v = g + 0.9 * vv
    t, n_take = tk._radix_threshold(
        lambda c: tk.count_rows_plain(err[None], c[None])[0], k, dev)
    got = tk.select_resid(err, v, t, n_take)
    ref = tk.select_resid_plain(err, v, t, n_take)
    assert all(_same_bits(a, b) for a, b in zip(got, ref))
    before = dict(cuda_lib.LAUNCHES)
    fused = tk.fused_true_topk(g, vv, ve, k, 0.9)
    assert all(_same_bits(a, b) for a, b in zip(fused, ref))
    grew = {key: cuda_lib.LAUNCHES[key] - before.get(key, 0)
            for key in ("rows_hist", "rows_resid", "count_plain",
                        "select_resid")}
    assert grew == {"rows_hist": 3, "rows_resid": 1, "count_plain": 0,
                    "select_resid": 0}


def _radix_rows(case, B, n, seed):
    """(B, n) streams of the per-row radix: seeded normals, planted ties
    spread over every tile (an all-zero row 1), or +-0.0 and NaN."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, n).astype(np.float32)
    if case == "ties":
        return _tied_rows(B, n, seed)
    if case == "nan_zeros":
        u = rng.rand(B, n)
        x[u < 0.3] = 0.0
        x[(u >= 0.3) & (u < 0.5)] = -0.0
        x[u > 0.99] = np.nan
    return torch.from_numpy(x)


@pytest.mark.parametrize("case,B,n,kk,offset", [
    ("random", 8, 8_192 * 3 + 5, [100, 100, 50, 1, 0, 100, 100, 7], 0),
    ("ties", 4, 30_000, [500, 250, 1, 0], 0),
    ("ties", 4, 20_001, [500, 250, 20_001, 3], 1),
    ("nan_zeros", 3, 20_001, [400, 100, 0], 0),
    ("random", 1, 20_001, [300], 3),
    ("random", 1, 777, [777], 0)])
def test_rows_radix_kernels_equal_plain(dev, case, B, n, kk, offset):
    """The per-row radix against its plain versions, pass by pass: each
    row's digit histograms, t and n_take (also the nibble radix over the
    first port's count kernel), the dense select with and without the
    mask; ``offset`` floats into a buffer makes every row unaligned. The
    entry point twice, with its launches. NaN rows (1%) at k = 100: their
    card squares are INT32_MAX, where the reference's n_take goes negative
    and nothing is kept."""
    x = _radix_rows(case, B, n, seed=n + B).to(dev)
    buf = torch.empty(B * n + offset, device=dev)
    x = buf[offset:].view(B, n).copy_(x)
    kk = torch.tensor(kk, device=dev)
    ws = tk.rows_radix(x, kk)
    views = tk.rows_views(ws)
    bits = tk._score_bits(x)
    prefix, k_rem = torch.zeros_like(kk), kk
    for (shift, width), hist in zip(tk.DIGITS, views["hists"]):
        want = tk.digit_histogram_plain(bits, prefix, shift, width)
        assert torch.equal(hist, want)
        b, above = tk.digit_pick_plain(want, k_rem)
        prefix, k_rem = (prefix << width) | b, k_rem - above
    t, n_take = tk.radix_threshold_rows_plain(bits, kk)
    ct, cn = tk._radix_threshold_batched(lambda c: tk.count_rows(x, c), kk,
                                         dev)
    assert torch.equal(views["t"], t) and torch.equal(views["t"], ct)
    assert torch.equal(views["n_take"], n_take)
    assert torch.equal(views["n_take"], cn)
    for with_mask in (True, False):
        got = tk.rows_select(x, ws, with_mask)
        ref = tk.select_rows_plain(x, t, n_take, with_mask)
        assert _same_bits(got[0], ref[0])
        if with_mask:
            assert torch.equal(got[1], ref[1])
    before = dict(cuda_lib.LAUNCHES)
    first = tk.topk_select(x, kk, n, with_mask=True)
    again = tk.topk_select(x, kk, n, with_mask=True)
    assert _same_bits(first[0], again[0]) and torch.equal(first[1], again[1])
    assert _same_bits(first[0], ref[0])
    grew = {key: cuda_lib.LAUNCHES[key] - before.get(key, 0)
            for key in ("rows_hist", "rows_select", "count_plain",
                        "select_plain")}
    assert grew == {"rows_hist": 6, "rows_select": 2, "count_plain": 0,
                    "select_plain": 0}


@pytest.mark.parametrize("n,k,offset", [(20_001, 300, 0), (40_000, 25_000, 0),
                                        (40_000, 0, 0), (20_001, 5_000, 1)])
def test_rows_resid_kernel_equals_plain(dev, n, k, offset):
    """The resid select after the per-row radix (one row), against
    ``select_resid_plain`` at the plain radix's t and n_take: selected
    -0.0 keep their residuals; ``offset`` leaves err and v unaligned."""
    rng = np.random.RandomState(n + k)
    g, vv, ve = (torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
                 for _ in range(3))
    zero = torch.from_numpy(rng.permutation(n)[: n // 2]).to(dev)
    for t_ in (g, vv, ve):
        t_[zero] = -0.0
    g[zero[: n // 20]] = 2.0     # ties at |err| = 2
    vv[zero[: n // 20]] = ve[zero[: n // 20]] = 0.0
    v, err = (torch.empty(n + offset, device=dev)[offset:] for _ in range(2))
    v.copy_(g + 0.9 * vv)
    err.copy_(ve + v)
    kk = torch.full((1,), k, dtype=torch.int64, device=dev)
    ws = tk.rows_radix(err[None], kk)
    t, n_take = tk.radix_threshold_rows_plain(tk._score_bits(err[None]), kk)
    views = tk.rows_views(ws)
    assert torch.equal(views["t"], t)
    assert torch.equal(views["n_take"], n_take)
    got = tk.rows_resid(err, v, ws)
    ref = tk.select_resid_plain(err, v, t[0], n_take[0])
    assert all(_same_bits(a, b) for a, b in zip(got, ref))
    again = tk.rows_resid(err, v, tk.rows_radix(err[None], kk))
    assert all(_same_bits(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("d,c,r", [(20_000, 1_000, 5), (777, 300, 3),
                                   (9_000, 512, 1)])
def test_estimates_kernel_equals_plain(dev, d, c, r):
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    table = torch.from_numpy(np.random.RandomState(d).randn(
        r, cs.c_eff).astype(np.float32)).to(dev)
    before = cuda_lib.LAUNCHES["estimates"]
    got = estimates(cs, table)
    assert cuda_lib.LAUNCHES["estimates"] == before + 1
    assert _same_bits(got, estimates_plain(cs, table))


FLASH_CASES = [
    (torch.float32, 64, 256, 0.0), (torch.float32, 64, 256, 0.1),
    (torch.float32, 32, 100, 0.1), (torch.float32, 128, 200, 0.1),
    (torch.float32, 40, 130, 0.1), (torch.bfloat16, 64, 256, 0.1),
    (torch.float32, 8, 130, 0.0), (torch.float32, 128, 1100, 0.1),
    (torch.bfloat16, 128, 130, 0.0),
    # D in (64, 96]: the three-fragment width, where dq_kernel<float, 3>
    # spills registers
    (torch.float32, 96, 200, 0.1), (torch.bfloat16, 80, 130, 0.1)]


@pytest.mark.parametrize("dtype,D,T,rate", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, D, T, rate):
    BH = 6
    gen = torch.Generator().manual_seed(T + D)
    q, k, v, g = (torch.randn(BH, T, D, generator=gen).to(dev, dtype)
                  for _ in range(4))
    args = ((123, -456), D ** -0.5, 64, 96, rate)   # 3 x 2 dropout tiles
    before = dict(cuda_lib.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, *args)
    p_o, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), p_o.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, p_lse, rtol=0, atol=1e-5)
    delta = (g.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    ref = fa.flash_bwd_plain(q, k, v, g, *args)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip((dq, dk, dv), ref):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=rel * scale)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1
    again = fa.flash_fwd(q, k, v, *args)
    assert torch.equal(again[0], o) and torch.equal(again[1], lse)
    assert torch.equal(fa.flash_bwd_dq(q, k, v, g, lse, delta, *args), dq)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.parametrize("dtype,D,T,rate", FLASH_CASES)
def test_flash_v1_kernels_match_plain_and_the_new(dev, dtype, D, T, rate):
    """The first port's scalar forward, dq and dk/dv (on no path) against
    the plain versions and the tensor-core kernels, with the same limits,
    and bitwise over two runs."""
    BH = 6
    gen = torch.Generator().manual_seed(T + D)
    q, k, v, g = (torch.randn(BH, T, D, generator=gen).to(dev, dtype)
                  for _ in range(4))
    args = ((123, -456), D ** -0.5, 64, 96, rate)
    before = dict(cuda_lib.LAUNCHES)
    o1, lse1 = fa.flash_fwd_v1(q, k, v, *args)
    o, lse = fa.flash_fwd(q, k, v, *args)
    p_o, p_lse = fa.flash_fwd_plain(q, k, v, *args)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for want in (p_o, o):
        torch.testing.assert_close(o1.float(), want.float(), rtol=0, atol=tol)
    for want in (p_lse, lse):
        torch.testing.assert_close(lse1, want, rtol=0, atol=1e-5)
    delta = (g.float() * o.float()).sum(-1)
    bwd = (q, k, v, g, lse, delta, *args)
    got = (fa.flash_bwd_dq_v1(*bwd),) + fa.flash_bwd_dkv_v1(*bwd)
    new = (fa.flash_bwd_dq(*bwd),) + fa.flash_bwd_dkv(*bwd)
    ref = fa.flash_bwd_plain(q, k, v, g, *args)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, want in zip(got, new, ref):
        scale = float(want.float().abs().max())
        for other in (want, b):
            torch.testing.assert_close(a.float(), other.float(), rtol=0,
                                       atol=rel * scale)
    for name in ("flash_fwd_v1", "flash_bwd_dq_v1", "flash_bwd_dkv_v1"):
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1
    again = fa.flash_fwd_v1(q, k, v, *args)
    assert torch.equal(again[0], o1) and torch.equal(again[1], lse1)
    assert torch.equal(fa.flash_bwd_dq_v1(*bwd), got[0])
    again = fa.flash_bwd_dkv_v1(*bwd)
    assert all(torch.equal(a, b) for a, b in zip(again, got[1:]))


def test_flash_tc_kernels_refuse_unaligned_rows(dev):
    """The tensor-core kernels copy rows 16 bytes at a time: an input
    that starts off a 16-byte boundary raises; the first port's kernels
    take it."""
    base = torch.randn(2 * 64 * 8 + 1, device=dev)
    q = base[1:].view(2, 64, 8)
    args = ((0, 0), 8 ** -0.5, 64, 64, 0.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(q, q, q, *args)
    o, lse = fa.flash_fwd_v1(q, q, q, *args)
    torch.testing.assert_close(o, fa.flash_fwd_plain(q, q, q, *args)[0],
                               rtol=0, atol=1e-5)
    delta = (q * o).sum(-1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dq(q, q, q, q, lse, delta, *args)
    dq = fa.flash_bwd_dq_v1(q, q, q, q, lse, delta, *args)
    want = fa.flash_bwd_plain(q, q, q, q, *args)[0]
    torch.testing.assert_close(dq, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_flash_attention_autograd_on_the_card(dev):
    """The autograd Function on the card against the same Function on the
    CPU (the plain versions), dropout included."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 150, 3, 32, generator=gen)
                  for _ in range(4))
    outs = {}
    for device in ("cpu", dev):
        xs = [x.to(device).detach().requires_grad_(True)
              for x in (q, k, v)]
        o = fa.flash_attention(*xs, dropout_rate=0.1, dropout_seed=77,
                               block_q=64, block_k=64)
        o.backward(g.to(device))
        outs[str(device)] = [o.detach().cpu()] + [x.grad.cpu() for x in xs]
    for a, b in zip(outs["cpu"], outs[str(dev)]):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-4 * float(a.abs().max()))


@pytest.mark.parametrize("B,d,c,r", [(1, 20_000, 1_000, 5),
                                     (3, 20_000, 1_000, 5),
                                     (9, 777, 300, 3), (8, 9_000, 512, 1)])
def test_estimates_batched_kernel_equals_plain(dev, B, d, c, r):
    """B = 9 spans two tiles of 8 tables; table 0 is all zero."""
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    tables = np.random.RandomState(d + B).randn(B, r, cs.c_eff).astype(
        np.float32)
    tables[0] = 0.0
    tables = torch.from_numpy(tables).to(dev)
    before = cuda_lib.LAUNCHES["estimates_batched"]
    got = estimates_batched(cs, tables)
    assert cuda_lib.LAUNCHES["estimates_batched"] == before + 1
    assert got.shape == (B, d)
    assert _same_bits(got, estimates_batched_plain(cs, tables))
    assert _same_bits(got, estimates_batched(cs, tables))
    for b in range(B):
        assert _same_bits(got[b], estimates(cs, tables[b]))


_SPECIAL = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                     0x00000001, 0x807FFFFF, 0x7FC00000, 0xFFC00000,
                     0x7FA00001, 0xFF812345], np.uint32).view(np.float32)


@pytest.mark.parametrize("r", [1, 3, 5])
@pytest.mark.parametrize("B", [1, 8])
def test_estimates_special_values_equal_plain(dev, r, B):
    """Tables with NaNs (payloads too), +-0.0, +-inf and denormals planted
    in a tenth of the cells and a whole all-NaN window: the median on
    integer keys with one NaN test is bitwise the plain version (through
    both entries at B = 1), the same over two runs."""
    cs = CountSketch(d=20_000, c=1_000, r=r, seed=42)
    rng = np.random.RandomState(10 * r + B)
    tables = rng.randn(B, r, cs.c_eff).astype(np.float32)
    planted = rng.rand(*tables.shape) < 0.1
    tables[planted] = _SPECIAL[rng.randint(0, len(_SPECIAL),
                                           planted.sum())]
    tables[:, 0, :128] = np.nan
    tables = torch.from_numpy(tables).to(dev)
    before = cuda_lib.LAUNCHES["estimates_batched"]
    got = estimates_batched(cs, tables)
    again = estimates_batched(cs, tables)
    assert cuda_lib.LAUNCHES["estimates_batched"] == before + 2
    assert _same_bits(got, estimates_batched_plain(cs, tables))
    assert _same_bits(got, again)
    if B == 1:
        assert _same_bits(got[0], estimates(cs, tables[0]))
    assert bool(torch.isnan(got).any()) and bool((got == 0).any())


@pytest.mark.parametrize("shape,dtype,rate", [
    ((4, 256, 768), torch.float32, 0.1), ((300, 1024), torch.float32, 0.5),
    ((64, 768), torch.float32, 0.1), ((3, 512, 1024), torch.bfloat16, 0.1)])
def test_hw_dropout_kernel_equals_plain(dev, shape, dtype, rate):
    """(300, 1024): a full logical block and a partial one."""
    gen = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=gen).to(dev, dtype)
    seeds = seed_words(fold_in(5, len(shape)))
    before = cuda_lib.LAUNCHES["hw_dropout"]
    got = hw_dropout(x, seeds, rate)
    assert cuda_lib.LAUNCHES["hw_dropout"] == before + 1
    want = hw_dropout_plain(x, seeds, rate)
    assert got.dtype == dtype and torch.equal(
        got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
        want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(hw_dropout(x, seeds, rate), got)
    # the plain version on the CPU: the same bits
    assert torch.equal(hw_dropout_plain(x.cpu(), seeds, rate), got.cpu())


def test_hw_dropout_contract_on_the_card(dev):
    """The reference's on-device contract: keep fraction, exact scaling,
    backward mask = forward mask (one more launch), seed sensitivity."""
    x = torch.ones((512, 1024), device=dev, requires_grad=True)
    seeds = seed_words(7)
    before = cuda_lib.LAUNCHES["hw_dropout"]
    y = hw_dropout(x, seeds, 0.1)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert cuda_lib.LAUNCHES["hw_dropout"] == before + 2
    y = y.detach()
    assert abs(float((y != 0).double().mean()) - 0.9) < 5e-3
    kept = y[y != 0]
    assert torch.equal(kept, torch.full_like(kept, float(np.float32(1 / 0.9))))
    assert torch.equal(g, y)
    y2 = hw_dropout(x.detach(), seed_words(8), 0.1)
    assert float((y2 != y).double().mean()) > 0.1


@pytest.mark.parametrize("sliced", [False, True])
def test_hw_dropout_thin_call_equals_plain(dev, sliced):
    """The call's host path (constants cached by rate, the entry point
    resolved once, no copy of an aligned contiguous x) keeps the kernel
    bitwise equal to its plain version, one launch a call, forward and
    backward; a freshly sliced x (contiguous, 4 bytes off a 16-byte
    boundary) is copied first and gives the same bits."""
    gen = torch.Generator().manual_seed(11)
    base = torch.randn(8 * 1024 + 1, generator=gen).to(dev)
    x = base[1:] if sliced else base[:-1].clone()
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == sliced
    x = x.view(8, 1024).requires_grad_(True)
    seeds = seed_words(fold_in(3, int(sliced)))
    want = hw_dropout_plain(x.detach(), seeds, 0.1)
    before = cuda_lib.LAUNCHES["hw_dropout"]
    y = hw_dropout(x, seeds, 0.1)
    assert cuda_lib.LAUNCHES["hw_dropout"] == before + 1
    assert _same_bits(y.detach(), want)
    g = torch.randn(8, 1024, generator=gen).to(dev)
    (dx,) = torch.autograd.grad(y, x, g)
    assert cuda_lib.LAUNCHES["hw_dropout"] == before + 2
    assert _same_bits(dx, hw_dropout_plain(g, seeds, 0.1))
    with torch.no_grad():
        assert _same_bits(hw_dropout(x, seeds, 0.1), want)
    assert cuda_lib.LAUNCHES["hw_dropout"] == before + 3


def _radix_table(case, r, c_eff, seed):
    rng = np.random.RandomState(seed)
    if case == "ties":
        return rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.float32),
                          size=(r, c_eff))
    if case == "zero":
        return np.zeros((r, c_eff), np.float32)
    t = rng.randn(r, c_eff).astype(np.float32)
    if case == "nan_zeros":
        t[rng.rand(r, c_eff) < 0.3] = 0.0
        t[rng.rand(r, c_eff) < 0.2] = -0.0
        t[rng.rand(r, c_eff) < 0.002] = np.nan
    return t


@pytest.mark.parametrize("case,d,c,r,k", [
    ("random", 20_000, 1_000, 5, 300), ("ties", 20_000, 640, 3, 2_500),
    ("ties", 8_192 * 3 + 5, 640, 1, 4_000), ("zero", 20_001, 700, 5, 300),
    ("nan_zeros", 20_000, 700, 5, 400), ("nan_zeros", 20_000, 700, 5, 100),
    ("random", 9_000, 512, 5, 1),
    ("random", 777, 300, 3, 777)])
def test_radix_kernels_equal_plain(dev, case, d, c, r, k):
    """The estimate-once radix against its plain versions, pass by pass:
    the stored estimates, each digit histogram, t and n_take (also the
    first port's count radix), the dense and the compact select; the
    wrappers twice, with their launches. At k = 100 the NaN estimates
    (about 1%) outnumber k: their card squares are INT32_MAX, where the
    reference's n_take goes negative and nothing is kept."""
    cs = CountSketch(d=d, c=c, r=r, seed=42)
    table = torch.from_numpy(_radix_table(case, r, cs.c_eff, d + r)).to(dev)
    est, ws = tk.unsketch_radix(cs, table, k)
    views = tk.radix_views(ws)
    p_est = cs.estimates(table)
    assert _same_bits(est[:d], p_est)
    bits = tk._score_bits(p_est)
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    k_rem = prefix + k
    for (shift, width), hist in zip(tk.DIGITS, views["hists"]):
        want = tk.digit_histogram_plain(bits, prefix, shift, width)
        assert torch.equal(hist, want)
        b, above = tk.digit_pick_plain(want, k_rem)
        prefix, k_rem = (prefix << width) | b, k_rem - above
    t, n_take = tk.radix_threshold_plain(bits, k)
    ct, cn = tk._radix_threshold(lambda cands: tk.count_plain(cs, table,
                                                              cands), k, dev)
    assert int(views["t"]) == int(t) == int(ct)
    assert int(views["n_take"]) == int(n_take) == int(cn)
    dense = tk.radix_select(est, d, k, ws, dense=True)
    compact = tk.radix_select(est, d, k, ws, dense=False)
    p_dense = tk.unsketch_select_plain(cs, table, k)
    p_compact = tk.unsketch_compact_plain(cs, table, k)
    assert _same_bits(dense[0], p_dense[0])
    assert torch.equal(dense[1], p_dense[1])
    assert _same_bits(compact[0], p_compact[0])
    assert torch.equal(compact[1], p_compact[1])
    before = dict(cuda_lib.LAUNCHES)
    for _ in range(2):
        got = tk.unsketch_select(cs, table, k)
        assert _same_bits(got[0], dense[0]) and torch.equal(got[1], dense[1])
        got = tk.unsketch_compact(cs, table, k)
        assert _same_bits(got[0], compact[0])
        assert torch.equal(got[1], compact[1])
    grew = {key: cuda_lib.LAUNCHES[key] - before.get(key, 0)
            for key in ("est_hist", "digit_hist", "radix_select",
                        "radix_compact", "count", "select")}
    assert grew == {"est_hist": 4, "digit_hist": 8, "radix_select": 2,
                    "radix_compact": 2, "count": 0, "select": 0}
    if case != "nan_zeros":   # NaN squares differ between card and CPU
        vals, idxs = cs.unsketch_values_indices(table, k)
        c_vals, c_idxs = cs.unsketch_values_indices(table.cpu(), k)
        assert torch.equal(idxs.cpu(), c_idxs)
        assert _same_bits(vals.cpu(), c_vals)


def test_sketch_sparse_card_equals_cpu(dev):
    """Order-sensitive collisions (signed 1e8, 1, -1e8 in one bucket) and
    many ordinary ones: the card's table is bitwise the CPU's, twice."""
    cs = CountSketch(d=50_000, c=1_000, r=5, seed=42)
    rng = np.random.RandomState(3)
    idx = torch.from_numpy(rng.permutation(cs.d)[:3_000].astype(np.int64))
    _, buckets = cs._row_hashes(0, idx)
    b, counts = torch.unique(buckets, return_counts=True)
    three = idx[buckets == b[counts >= 3][0]][:3]
    idx = torch.cat([three, idx[~torch.isin(idx, three)]])
    signs, _ = cs._row_hashes(0, three)
    vals = torch.from_numpy(rng.randn(len(idx)).astype(np.float32))
    vals[:3] = torch.tensor([1e8, 1.0, -1e8]) * signs
    cpu = cs.sketch_sparse(vals, idx)
    before = cuda_lib.LAUNCHES["segment_sum"]
    got = cs.sketch_sparse(vals.to(dev), idx.to(dev))
    again = cs.sketch_sparse(vals.to(dev), idx.to(dev))
    assert cuda_lib.LAUNCHES["segment_sum"] == before + 2
    assert _same_bits(got.cpu(), cpu) and _same_bits(again, got)
