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
unaligned rows, a k = 0 row and NaN rows included; a full-width
FixupResNet9 sketch round through the kernels equals the same round
through the plain versions on the card (table, server state, top-k set,
weights). Beside the kernels: the fused LM head on the card against the
CPU's (float32, TF32 off: 1e-5), GPT2's remat gradient on the card
bitwise the one without remat (flash kernels launched twice as often),
and ``download_counts`` on the card bitwise the CPU's; the global
scheme's dense sketch and recovery, the sparse and sketched client
codecs on the card bitwise the CPU's, and offloaded local_topk rounds
(dense and sparse rows) bitwise the device-resident ones; a checkpoint
restored onto the card bitwise, the buffered server in lock-step bitwise
the sync one and a faulted schedule replayed bitwise (its event counters
the CPU's), and quarantine of a NaN client in a sketch round; the
serving stack (a narrow GPT2's prefill through the flash forward, the
paged server's replies equal to the dense engine's, ``kv_quant`` bitwise
the CPU's, decode and paged attention within 1e-5 of the CPU's); the
Switch MoE FFN's routing, output and gradients within 1e-5 of the CPU's,
with the capacity binding and not, and a narrow 4-expert GPT2's sketch
rounds on the card against the CPU's.
``chip_smoke.py`` repeats this at the main paths' full width.
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


def test_fixup_resnet9_sketch_round_kernels_equal_plain(dev, monkeypatch):
    """One full-width FixupResNet9 sketch round (5 x 500,000, k = 50,000,
    Fixup's scalars at 0.1x the LR) through the kernels, then the same
    round with the plain versions on the card: the sketched table, the
    server state, the top-k set and the weights bitwise equal."""
    import copy
    from functools import partial

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models import FixupResNet9
    from commefficient_tpu_torch.ops import sketch_kernels as sk
    from commefficient_tpu_torch.utils.params import scalar_lr_multipliers
    model = FixupResNet9().reset_parameters(torch.Generator().manual_seed(0))
    cfg = FedConfig(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                    k=50_000, num_cols=500_000, num_rows=5, num_clients=4,
                    num_workers=2)
    rng = np.random.RandomState(0)
    batch = (rng.randn(2, 4, 32, 32, 3).astype(np.float32),
             rng.randint(0, 10, (2, 4)).astype(np.int32))
    ids, mask = np.array([0, 3], np.int32), np.ones((2, 4), np.float32)
    runs = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            monkeypatch.setattr(sk, "sketch_vec", sk.sketch_vec_plain)
            monkeypatch.setattr(sk, "segment_sum", sk.segment_sum_plain)
            monkeypatch.setattr(tk, "unsketch_compact",
                                tk.unsketch_compact_plain)
        tables = []

        def recorded(*args, sketch_vec=sk.sketch_vec, **kwargs):
            tables.append(sketch_vec(*args, **kwargs))
            return tables[-1]

        monkeypatch.setattr(sk, "sketch_vec", recorded)
        m = copy.deepcopy(model)
        learner = FedLearner(m, cfg, make_cv_loss(m), device=dev,
                             lr_scale_vec=partial(scalar_lr_multipliers,
                                                  scalar_factor=0.1))
        before = dict(cuda_lib.LAUNCHES)
        learner.train_round(ids, batch, mask, epoch_frac=1.0)
        torch.cuda.synchronize()
        runs[route] = (tables[0], learner.state, {
            k: v - before.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
            if v - before.get(k, 0)})
    (t_k, s_k, n_k), (t_p, s_p, n_p) = runs["kernels"], runs["plain"]
    assert n_k == {"sketch": 1, "est_hist": 1, "digit_hist": 2,
                   "radix_compact": 1, "segment_sum": 1} and n_p == {}
    assert t_k.shape == (5, 500_096) and _same_bits(t_k, t_p)
    for a, b in ((s_k.opt.Vvelocity, s_p.opt.Vvelocity),
                 (s_k.opt.Verror, s_p.opt.Verror), (s_k.weights, s_p.weights)):
        assert _same_bits(a, b)
    assert torch.equal(s_k.last_changed, s_p.last_changed)
    assert int((s_k.last_changed == 0).sum()) == 50_000


def test_fused_ce_card_equals_cpu(dev):
    from commefficient_tpu_torch.ops.fused_ce import lm_head_nll
    rng = np.random.RandomState(0)
    N, E, V = 300, 64, 20_000          # 3 chunks of 8192, the last short
    hidden = torch.from_numpy(rng.randn(N, E).astype(np.float32))
    wte = torch.from_numpy((0.1 * rng.randn(V, E)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, V, N))
    labels[:3] = torch.tensor([0, V - 1, 8192])
    g = torch.from_numpy(rng.rand(N).astype(np.float32))
    outs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cpu", dev):
            h = hidden.to(device).requires_grad_(True)
            w = wte.to(device).requires_grad_(True)
            nll = lm_head_nll(h, w, labels.to(device), 8192, torch.float32)
            dh, dw = torch.autograd.grad(torch.sum(nll * g.to(device)),
                                         (h, w))
            outs.append([t.detach().cpu() for t in (nll, dh, dw)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


def test_gpt2_remat_gradient_bitwise_on_the_card(dev):
    from commefficient_tpu_torch.federated.client import \
        _masked_loss_and_grad
    from commefficient_tpu_torch.federated.losses import \
        make_gpt2_train_loss
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.utils.params import flatten_params
    rng = np.random.RandomState(1)
    B, C, T = 2, 2, 64
    ids = rng.randint(0, 300, (B, C, T))
    batch = tuple(torch.from_numpy(a).to(dev) for a in (
        ids, rng.randint(T // 2, T, (B, C)),
        np.where(rng.rand(B, C, T) < 0.3, ids, -1),
        np.full((B,), C - 1), rng.randint(256, 261, (B, C, T))))
    grads, launches = [], []
    for remat in (False, True):
        cfg = GPT2Config(vocab_size=300, n_positions=T, n_embd=64,
                         n_layer=2, n_head=4, dropout=0.1,
                         attn_impl="blockwise", remat=remat)
        model = GPT2DoubleHeads(cfg).reset_parameters(
            torch.Generator().manual_seed(0)).to(dev)
        flat, unflatten = flatten_params(model)
        before = cuda_lib.LAUNCHES.get("flash_fwd", 0)
        grads.append(_masked_loss_and_grad(
            make_gpt2_train_loss(model), unflatten, flat + 0.01, batch,
            torch.ones(B, device=dev), seed=3)[0])
        torch.cuda.synchronize()
        launches.append(cuda_lib.LAUNCHES.get("flash_fwd", 0) - before)
    assert launches == [2, 4]
    assert _same_bits(grads[0], grads[1])


def test_download_counts_card_equals_cpu(dev):
    from commefficient_tpu_torch.federated.round import download_counts
    rng = np.random.RandomState(2)
    for W, d in ((1, 1_000), (4, 1_000_003), (8, 65_536)):
        last_changed = torch.from_numpy(
            rng.randint(-2, 6, d).astype(np.int32))
        stale = torch.from_numpy(rng.randint(-1, 6, W).astype(np.int32))
        stale[W // 2:] = stale[W // 2]
        want = download_counts(last_changed, stale)
        got = download_counts(last_changed.to(dev), stale.to(dev))
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d,c,r,off,B", [(50_000, 1_000, 5, 0, 1),
                                         (30_000, 128, 3, 0, 8),
                                         (20_000, 777, 3, 1_234, 3)])
def test_global_sketch_card_equals_cpu(dev, d, c, r, off, B):
    """The global scheme's dense sketch (a sorted plan and one segment_sum
    launch) on the card bitwise the CPU's, at a (3, 128) table's long
    runs too, and the same over two runs."""
    cs = CountSketch(d=d, c=c, r=r, seed=7, scheme="global")
    n = d - off
    x = np.random.RandomState(d + B).randn(B, n).astype(np.float32)
    x[:, ::9] = 0.0
    before = cuda_lib.LAUNCHES["segment_sum"]
    got = cs.sketch_rows(torch.from_numpy(x).to(dev), off)
    assert cuda_lib.LAUNCHES["segment_sum"] == before + 1
    want = cs.sketch_rows(torch.from_numpy(x), off)
    assert _same_bits(got.cpu(), want)
    assert _same_bits(got, cs.sketch_rows(torch.from_numpy(x).to(dev), off))


def test_global_recovery_card_equals_cpu(dev):
    """Global estimates (PyTorch on both devices) and their top-k (the
    per-row radix on the card, its plain version on the CPU), fused and
    not, bitwise."""
    cs = CountSketch(d=40_000, c=500, r=5, seed=3, scheme="global")
    table = torch.from_numpy(np.random.RandomState(1).randn(5, 500).astype(
        np.float32))
    tables = torch.stack([table, -table, torch.zeros_like(table)])
    assert _same_bits(cs.estimates_rows(tables.to(dev)).cpu(),
                      cs.estimates_rows(tables))
    for fused in (True, False):
        v1, i1 = cs.unsketch_values_indices(table.to(dev), 2_000, fused)
        v0, i0 = cs.unsketch_values_indices(table, 2_000, fused)
        assert torch.equal(i1.cpu(), i0) and _same_bits(v1.cpu(), v0)


@pytest.mark.parametrize("rep", ["sparse", "sketched"])
def test_client_codecs_card_equal_cpu(dev, rep):
    """The sparse encode (a stable sort by |x| a row) and decode, and the
    sketched encode and decode, on the card bitwise the CPU's."""
    from commefficient_tpu_torch.federated import client_store as store
    d = 30_000
    codec = (store.SparseCodec(d, cap=1_000) if rep == "sparse" else
             store.SketchedCodec(d, r=3, c=128, k=1_000, seed=21))
    rows = np.random.RandomState(2).randn(4, d).astype(np.float32)
    rows[0, 5_000:] = 0.0
    rows[1, ::2] = rows[1, 1::2]           # |x| ties across pairs
    rows[2, :40] = 1e-23                   # squares underflow to 0
    enc_cpu = codec.encode_rows(torch.from_numpy(rows))
    enc_dev = codec.encode_rows(torch.from_numpy(rows).to(dev))
    for key in enc_cpu:
        assert _same_bits(enc_dev[key].cpu(), enc_cpu[key]), key
    assert _same_bits(codec.decode_rows(enc_dev).cpu(),
                      codec.decode_rows(enc_cpu))


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_offload_round_card_bitwise_device_resident(dev, rep):
    """local_topk rounds on the card with the rows offloaded (pinned
    staging, the side stream, gather-ahead, lazy writeback at depth 2)
    bitwise the same rounds with the rows on the card, over rounds that
    share clients, a padded slot and an abort."""
    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.toy import TinyMLP
    n, W, B = 8, 3, 4
    rng = np.random.RandomState(0)
    rounds = []
    for r in range(8):
        xs = rng.randn(W, B, 8).astype(np.float32)
        mask = np.ones((W, B), np.float32)
        if r == 2:
            mask[-1] = 0.0
        if r == 5:
            xs[0, 0, 0] = np.nan
        rounds.append((np.arange(r, r + W) % n,
                       (xs, rng.randint(0, 2, (W, B)).astype(np.int32)),
                       mask))
    learners = []
    for offload in (False, True):
        model = TinyMLP(num_classes=2, hidden=64, in_channels=8,
                        image_size=1).reset_parameters(
            torch.Generator().manual_seed(1))
        cfg = FedConfig(mode="local_topk", error_type="local",
                        local_momentum=0.9, k=50, num_workers=W,
                        num_clients=n, client_state=rep,
                        client_state_offload=offload)
        ln = FedLearner(model, cfg, make_cv_loss(model), device=dev)
        outs = []
        for i, (ids, batch, mask) in enumerate(rounds):
            nxt = rounds[i + 1][0] if i + 1 < len(rounds) else None
            outs.append(ln.finalize_round_metrics(ln.train_round_async(
                ids, batch, mask, next_client_ids=nxt)))
        ln.flush_offload()
        learners.append((ln, outs))
    (dev_ln, a), (off_ln, b) = learners
    assert [x["loss"] for x in a[:5]] == [x["loss"] for x in b[:5]]
    assert a[-1]["aborted"] and b[-1]["aborted"]
    assert _same_bits(dev_ln.state.weights, off_ln.state.weights)
    assert off_ln._offload_pipe.stats["rows_from_pending"] > 0
    for field in ("velocities", "errors"):
        stored = getattr(dev_ln.state.clients, field)
        arena = off_ln.host_store.arena(field)
        if rep == "dense":
            assert _same_bits(stored[:n].cpu(), arena)
        else:
            for key in ("idx", "val"):
                assert _same_bits(stored[key][:n].cpu(), arena[key])


@pytest.mark.parametrize("size", [1, 3])
def test_device_prefetch_pinned_copies_on_the_card(dev, size):
    """``device_prefetch`` to the card: the columns arrive on the device
    with their values and dtypes and in order, from pinned memory on the
    side stream, the ids and the mask stay host numpy arrays, and an
    array the producer rewrites after its item was put keeps the values
    it had then."""
    from commefficient_tpu_torch.data.prefetch import device_prefetch
    rng = np.random.RandomState(size)
    items = [(rng.randint(0, 100, 4).astype(np.int32),
              (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
               rng.randint(0, 10, (4, 8)).astype(np.int32)),
              (rng.rand(4, 8) > 0.2).astype(np.float32)) for _ in range(6)]
    want = [(i.copy(), tuple(c.copy() for c in cols), m.copy())
            for i, cols, m in items]

    def produce():
        for ids, cols, mask in items:
            yield ids, cols, mask
            cols[0][...] = -1.0   # the producer reuses its buffer
    out = list(device_prefetch(produce(), size=size, device=dev))
    torch.cuda.synchronize()
    assert len(out) == len(want)
    for (ids, cols, mask), (wi, wc, wm) in zip(out, want):
        assert isinstance(ids, np.ndarray)
        np.testing.assert_array_equal(ids, wi)
        for c, w in zip(cols, wc):
            assert c.device.type == "cuda" and c.dtype == torch.from_numpy(
                w).dtype
            np.testing.assert_array_equal(c.cpu().numpy(), w)
        assert isinstance(mask, np.ndarray)
        np.testing.assert_array_equal(mask, wm)


def test_scan_window_on_the_card_bitwise_single_rounds(dev):
    """A sketch-mode window of 3 rounds on the card (the sketch and
    recovery kernels) bitwise 3 pipelined single rounds: per-round
    metrics, weights and server state; the window's dispatch makes no
    host sync (sync debug mode "error")."""
    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.toy import TinyMLP
    W, B = 3, 4
    rng = np.random.RandomState(2)
    rounds = [(rng.choice(8, W, replace=False).astype(np.int32),
               (rng.randn(W, B, 8).astype(np.float32),
                rng.randint(0, 2, (W, B)).astype(np.int32)),
               np.ones((W, B), np.float32)) for _ in range(3)]
    learners = []
    for _ in range(2):
        model = TinyMLP(num_classes=2, hidden=512, in_channels=8,
                        image_size=1).reset_parameters(
            torch.Generator().manual_seed(3))
        cfg = FedConfig(mode="sketch", error_type="virtual",
                        virtual_momentum=0.9, k=200, num_rows=5,
                        num_cols=1000, num_workers=W, num_clients=8)
        learners.append(FedLearner(model, cfg, make_cv_loss(model),
                                   device=dev))
    one, win = learners
    pipe = one.pipeline()
    outs_one = [o for o in (pipe.push(one.train_round_async(*r))
                            for r in rounds) if o is not None]
    outs_one.append(pipe.flush())
    stacked = (np.stack([r[0] for r in rounds]),
               tuple(torch.from_numpy(np.stack([r[1][i] for r in rounds]))
                     .to(dev) for i in range(2)),
               torch.from_numpy(np.stack([r[2] for r in rounds])).to(dev))
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raw = win.train_rounds_scan(*stacked)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_lib.LAUNCHES["sketch"] == 3
    outs_win = win.finalize_scan_metrics(raw)
    for a, b in zip(outs_one, outs_win):
        assert (a["loss"], a["upload_bytes"], a["download_bytes"],
                a["update_l2"]) == (b["loss"], b["upload_bytes"],
                                    b["download_bytes"], b["update_l2"])
        np.testing.assert_array_equal(a["metrics"], b["metrics"])
    for x, y in ((one.state.weights, win.state.weights),
                 (one.state.opt.Vvelocity, win.state.opt.Vvelocity),
                 (one.state.opt.Verror, win.state.opt.Verror)):
        assert _same_bits(x, y)


def _sketch_learner(dev, fault_model=None, **kw):
    """A narrow sketch-mode learner on ``dev`` (TinyMLP, d = 5,634)."""
    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.toy import TinyMLP
    model = TinyMLP(num_classes=2, hidden=512, in_channels=8,
                    image_size=1).reset_parameters(
        torch.Generator().manual_seed(4))
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=200, num_rows=5, num_cols=1000,
                    num_workers=3, num_clients=8, **kw)
    if cfg.server_mode == "buffered":
        from commefficient_tpu_torch.federated.buffer import \
            BufferedFedLearner
        return BufferedFedLearner(model, cfg, make_cv_loss(model),
                                  device=dev, fault_model=fault_model)
    from commefficient_tpu_torch.federated.api import FedLearner
    return FedLearner(model, cfg, make_cv_loss(model), device=dev)


def _robust_rounds(n=6, seed=6):
    rng = np.random.RandomState(seed)
    return [(rng.choice(8, 3, replace=False).astype(np.int32),
             (rng.randn(3, 4, 8).astype(np.float32),
              rng.randint(0, 2, (3, 4)).astype(np.int32)),
             np.ones((3, 4), np.float32)) for _ in range(n)]


def test_checkpoint_roundtrip_on_the_card(dev, tmp_path):
    """A sketch learner's checkpoint on the card: a fresh learner loads
    every state tensor onto the card in its dtype, bitwise, with the sink
    row zero, and its next round is bitwise the saved learner's."""
    from commefficient_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                          save_checkpoint,
                                                          state_leaves)
    rounds = _robust_rounds(3)
    a, b = _sketch_learner(dev), _sketch_learner(dev)
    for r in rounds[:2]:
        a.train_round(*r)
    load_checkpoint(save_checkpoint(str(tmp_path), a, "t", step=2), b)
    for (p, x, _), (_, y, _) in zip(state_leaves(a.state),
                                    state_leaves(b.state)):
        assert y.device == x.device and y.dtype == x.dtype, p
        assert (_same_bits(x, y) if x.dtype == torch.float32
                else torch.equal(x, y)), p
    assert a.rounds_done == b.rounds_done == 2
    ma, mb = a.train_round(*rounds[2]), b.train_round(*rounds[2])
    assert (ma["loss"], ma["upload_bytes"]) == (mb["loss"],
                                                mb["upload_bytes"])
    assert _same_bits(a.state.weights, b.state.weights)


def test_buffered_server_on_the_card(dev):
    """The lock-step buffered learner on the card bitwise the sync one;
    a faulted schedule twice, bitwise, its event loop's counters equal
    to the same learner's on the CPU."""
    from commefficient_tpu_torch.federated.faults import FaultModel
    rounds = _robust_rounds()
    runs = []
    for kw in ({}, {"server_mode": "buffered"}):
        ln = _sketch_learner(dev, **kw)
        runs.append((ln, [ln.train_round(*r)["loss"] for r in rounds]))
    (sync, sync_losses), (lockstep, lockstep_losses) = runs
    assert sync_losses == lockstep_losses
    assert _same_bits(sync.state.weights, lockstep.state.weights)
    faulted = []
    for device in (dev, dev, torch.device("cpu")):
        ln = _sketch_learner(
            device, server_mode="buffered", buffer_m=2, staleness_alpha=0.5,
            fault_model=FaultModel(5, 8, straggler_frac=0.3,
                                   dropout_prob=0.1, crash_prob=0.1))
        for r in rounds:
            ln.train_round(*r)
        ln.flush_faults()
        faulted.append(ln)
    x, y, cpu = faulted
    assert _same_bits(x.state.weights, y.state.weights)
    assert x.applies_done > 1 and x.fault_stats == y.fault_stats
    assert (x.fault_stats, x.applies_done, x.sim_time) == (
        cpu.fault_stats, cpu.applies_done, cpu.sim_time)


def test_quarantine_on_the_card(dev):
    """--client_quarantine on the card: a NaN client's contribution is
    excluded from the sketched aggregate, its client benched, and the
    weights stay finite."""
    rounds = _robust_rounds(3)
    ids, (xs, ys), mask = rounds[1]
    xs = xs.copy()
    xs[0, 0, 0] = np.nan
    rounds[1] = (ids, (xs, ys), mask)
    ln = _sketch_learner(dev, client_quarantine=True, quarantine_rounds=2)
    outs = [ln.train_round(*r) for r in rounds]
    assert not any(o["aborted"] for o in outs)
    assert bool(torch.isfinite(ln.state.weights).all())
    q = ln.state.quarantine.cpu()
    assert int((q > 0).sum()) == 1 and int(q[int(ids[0])]) == 1


def _narrow_gpt2(dev):
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    cfg = GPT2Config(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                     n_head=4, dropout=0.0, attn_impl="blockwise")
    model = GPT2DoubleHeads(cfg).reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)
    return model, {n: p.detach() for n, p in model.named_parameters()}


def test_serving_prefill_runs_flash_and_paged_replies_match_dense(dev):
    """A narrow GPT2 served on the card: every admission's prefill
    launches the flash forward once a layer, and the paged server's greedy
    replies equal each request decoded alone by the dense-cache engine."""
    from commefficient_tpu_torch.serving import (ContinuousBatchingServer,
                                                 DecodeEngine)
    model, params = _narrow_gpt2(dev)
    engine = DecodeEngine(model, params, eos_id=257, max_len=48)
    rng = np.random.RandomState(0)
    prompts = [(rng.randint(0, 256, n).tolist(), [259] * n)
               for n in (5, 16, 9, 12, 3, 7)]
    srv = ContinuousBatchingServer(engine, slots=3, prefill_len=16,
                                   kv_cache="paged", page_size=4)
    rids = [srv.submit(ids, types, 260, 10) for ids, types in prompts]
    cuda_lib.LAUNCHES.clear()
    replies = srv.run()
    assert cuda_lib.LAUNCHES["flash_fwd"] == 2 * len(prompts)
    solo = [engine.generate([p], [260], max_new=10)[0] for p in prompts]
    assert [replies[r] for r in rids] == solo


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_kv_quant_on_the_card_bitwise_the_cpu(dev, mode):
    from commefficient_tpu_torch.ops import kv_quant as kvq
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 16, 12, 64, generator=g)
    q, s = kvq.quantize_pages(x.to(dev), mode)
    qc, sc = kvq.quantize_pages(x, mode)
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    assert torch.equal(kvq.dequantize_pages(q, s, mode).cpu(),
                       kvq.dequantize_pages(qc, sc, mode))


def test_decode_attention_on_the_card_matches_the_cpu(dev):
    from commefficient_tpu_torch.ops.attention import (
        decode_attention, paged_verify_attention)
    g = torch.Generator().manual_seed(2)
    q = torch.randn(4, 3, 12, 64, generator=g)
    k = torch.randn(4, 96, 12, 64, generator=g)
    v = torch.randn(4, 96, 12, 64, generator=g)
    pos = torch.tensor([0, 17, 50, 93])
    want = decode_attention(q, k, v, pos)
    got = decode_attention(q.to(dev), k.to(dev), v.to(dev), pos.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    pools = (k.reshape(24, 16, 12, 64), v.reshape(24, 16, 12, 64))
    pt = torch.arange(24, dtype=torch.int32).reshape(4, 6)
    want = paged_verify_attention(q, *pools, pt, pos)
    got = paged_verify_attention(q.to(dev), pools[0].to(dev),
                                 pools[1].to(dev), pt.to(dev), pos.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_on_the_card_matches_the_cpu(dev, capacity_factor):
    """The Switch MoE FFN's routing, output, aux and gradients on the card
    against the CPU's (float32, TF32 off): the same assignments and keep
    mask (no near-tie at these seeds), values within 1e-5 of their largest
    magnitude."""
    from commefficient_tpu_torch.ops.moe import MoEFFN
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    layers = [MoEFFN(64, 4, 256, capacity_factor) for _ in range(2)]
    with torch.no_grad():
        for p in layers[0].parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=g))
    layers[1].load_state_dict(layers[0].state_dict())
    layers[1].to(dev)
    x = torch.randn(512, 64, generator=g)
    w = torch.randn(512, 64, generator=g)
    outs = []
    for layer, d in zip(layers, ("cpu", dev)):
        xx = x.to(d, copy=True).requires_grad_(True)
        y, aux = layer(xx)
        (torch.sum(y * w.to(d)) + aux).backward()
        r = layer.route(x.to(d))
        outs.append([r.expert.cpu(), r.keep.cpu(), y.detach().cpu(),
                     aux.detach().cpu(), xx.grad.cpu()]
                    + [p.grad.cpu() for p in layer.parameters()])
    (ec, kc, *vc), (eg, kg, *vg) = outs
    assert torch.equal(ec, eg) and torch.equal(kc, kg)
    if capacity_factor < 1:
        assert not bool(kc.all())
    for a, b in zip(vc, vg):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_moe_gpt2_sketch_rounds_on_the_card_match_the_cpu(dev):
    """Two sketch rounds of a narrow 4-expert GPT2 learner on the card
    (flash kernels, sketch and recovery) and on the CPU from the same
    weights and batches: losses within 1e-4 relative, bytes equal."""
    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import (
        make_gpt2_train_loss, make_gpt2_val_loss)
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    torch.backends.cuda.matmul.allow_tf32 = False
    W, B, C, T = 2, 2, 2, 64
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 261, (W, B, C, T)).astype(np.int32)
        cols = (ids, rng.randint(T // 2, T, (W, B, C)).astype(np.int32),
                np.where(rng.rand(W, B, C, T) < 0.3, ids, -1).astype(
                    np.int32), np.full((W, B), C - 1, np.int32),
                rng.randint(256, 261, (W, B, C, T)).astype(np.int32))
        batches.append((rng.choice(4, W, replace=False).astype(np.int32),
                        cols, np.ones((W, B), np.float32)))
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=500, num_cols=4000, num_rows=5,
                    num_clients=4, num_workers=W, weight_decay=0.0)
    outs = []
    for device in ("cpu", dev):
        gcfg = GPT2Config(vocab_size=300, n_positions=T, n_embd=64,
                          n_layer=2, n_head=4, dropout=0.0,
                          attn_impl="blockwise")
        gcfg.moe_experts = 4
        model = GPT2DoubleHeads(gcfg).reset_parameters(
            torch.Generator().manual_seed(0))
        learner = FedLearner(model, cfg, make_gpt2_train_loss(model),
                             make_gpt2_val_loss(model), device=device)
        cuda_lib.LAUNCHES.clear()
        outs.append([learner.train_round(ids, cols, m, epoch_frac=r)
                     for r, (ids, cols, m) in enumerate(batches)])
    assert cuda_lib.LAUNCHES["flash_fwd"] == 4
    assert cuda_lib.LAUNCHES["sketch"] == 2
    for a, b in zip(*outs):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(a["loss"])
        assert (a["download_bytes"], a["upload_bytes"]) == (
            b["download_bytes"], b["upload_bytes"])
