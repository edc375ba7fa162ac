"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test here skips. On a
machine with one (and without JAX, so without the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each sketch and top-k kernel must equal its plain version bitwise at
small shapes, odd lengths (tails that are no multiple of a tile), a
nonzero block offset, per-row k and planted ties included; the flash
attention kernels match theirs within float32 rounding (O and lse atol
1e-5, gradients 1e-4 of their largest magnitude; bf16 2e-2), with and
without dropout, and are deterministic. ``chip_smoke.py`` repeats this at
the main paths' full width.
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops import flash_attention as fa
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.sketch_kernels import (
    estimates, estimates_plain, sketch_vec, sketch_vec_batched,
    sketch_vec_batched_plain, sketch_vec_plain)

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
    before = cuda_lib.LAUNCHES["count_plain"]
    dense = tk.topk_select(x, kk, int(kk.max()))
    assert cuda_lib.LAUNCHES["count_plain"] == before + 9
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
    fused = tk.fused_true_topk(g, vv, ve, k, 0.9)
    assert all(_same_bits(a, b) for a, b in zip(fused, ref))


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


@pytest.mark.parametrize("dtype,D,T,rate", [
    (torch.float32, 64, 256, 0.0), (torch.float32, 64, 256, 0.1),
    (torch.float32, 32, 100, 0.1), (torch.float32, 128, 200, 0.1),
    (torch.float32, 40, 130, 0.1), (torch.bfloat16, 64, 256, 0.1)])
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
