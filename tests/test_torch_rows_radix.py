"""The per-row histogram radix of the port's dense-stream top-k (plain and
resid sources) on the CPU, where the wrappers take the plain versions
(the card's kernels are held against these in
``tests/test_torch_cuda_kernels.py``):

* the per-row digit radix (``radix_threshold_rows_plain``) gives, row by
  row, the ``(t, n_take)`` of the eight-round nibble radix over
  ``_count_bits`` (``_radix_threshold_batched``, which mirrors the
  reference's), on random, planted-tie, all-zero, +-0.0 and NaN-bearing
  scores, with per-row k of 0, 1, a middle k and n in one call;
* its per-row histogram and pick equal the one-row versions row by row;
* ``topk_select`` with a k = 0 row (2-D, per-row k, with the mask) is
  BITWISE the reference's batched ``topk_select_pallas`` in interpret
  mode;
* the workspace views read t and n_take where the kernels write them, and
  the kernel wrappers refuse a stream off the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.ops import topk_kernels as jtk
from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops import topk_kernels as tk

N = 5_003     # not a multiple of 4: rows start unaligned
B = 4


def _score_rows(case: str) -> torch.Tensor:
    """(B, N) int32 score bits, each row of ``case`` from its own seed."""
    rows = []
    for r in range(B):
        rng = np.random.RandomState(17 * len(case) + r)
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
            rows.append(tk._score_bits(torch.from_numpy(x)))
            continue
        raw = rng.randn(N).astype(np.float32).view(np.int32)
        if case == "signed_zeros":
            # scores of +-0.0 and raw +-0.0 bits (0 and INT32_MIN)
            raw[rng.choice(N, N // 2, replace=False)] = 0
            raw[rng.choice(N, N // 4, replace=False)] = np.int32(-2 ** 31)
        else:  # nan: x86's quiet NaN, the card's NaN score, a NaN with its
            # sign bit set, +inf
            for v, frac in ((0x7FC00000, 7), (0x7FFFFFFF, 9),
                            (np.int32(-0x00400000), 5), (0x7F800000, 11)):
                raw[rng.choice(N, N // frac, replace=False)] = v
        rows.append(torch.from_numpy(raw))
    return torch.stack(rows)


KK = [0, 1, N // 2 + 17, N]


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "signed_zeros",
                                  "nan"])
def test_rows_radix_equals_nibble_radix(case):
    bits = _score_rows(case)
    kk = torch.tensor(KK)
    t, n_take = tk.radix_threshold_rows_plain(bits, kk)
    rt, rn = tk._radix_threshold_batched(lambda c: tk._count_bits(bits, c),
                                         kk, "cpu")
    assert t.dtype == torch.int32 and n_take.dtype == torch.int64
    assert t.tolist() == rt.tolist() and n_take.tolist() == rn.tolist()
    # k = 0 leaves t at INT32_MAX and keeps nothing
    assert int(t[0]) == 2 ** 31 - 1 and int(n_take[0]) <= 0
    sel = tk._select_mask(bits, t, n_take)
    assert int(sel[0].sum()) == 0
    for r, k in enumerate(KK):
        one = tk.radix_threshold_plain(bits[r], k)
        assert (int(one[0]), int(one[1])) == (int(t[r]), int(n_take[r]))


def test_rows_histogram_and_pick_equal_one_row():
    bits = _score_rows("ties")
    prefix = torch.tensor([0, 3, 1017, 2047])
    k_rem = torch.tensor([0, 1, 900, N])
    for shift, width in tk.DIGITS:
        hist = tk.digit_histogram_plain(bits, prefix, shift, width)
        assert hist.shape == (B, 1 << width) and hist.dtype == torch.int32
        b, above = tk.digit_pick_plain(hist, k_rem)
        for r in range(B):
            one = tk.digit_histogram_plain(bits[r], int(prefix[r]), shift,
                                           width)
            assert torch.equal(hist[r], one)
            ob, oa = tk.digit_pick_plain(one, int(k_rem[r]))
            assert (int(b[r]), int(above[r])) == (int(ob), int(oa))


def test_topk_select_k0_row_matches_reference_batched_kernel():
    rng = np.random.RandomState(5)
    x = rng.randn(B, N).astype(np.float32)
    x[1] = 0.0                                   # every score ties at 0
    x[2, rng.choice(N, 900, replace=False)] = 1.5
    kk = np.array([0, 40, 300, 1], np.int32)
    k = 300
    with jtk.force_dispatch("kernel"):
        fn = jax.vmap(lambda v, kk_: jtk.topk_select_pallas(
            v, kk_, k=k, with_mask=True, interpret=True))
        r_masked, r_mask = fn(jnp.asarray(x), jnp.asarray(kk))
    before = dict(cuda_lib.LAUNCHES)
    masked, mask = tk.topk_select(torch.from_numpy(x), torch.from_numpy(kk),
                                  k, with_mask=True)
    assert dict(cuda_lib.LAUNCHES) == before     # the CPU takes no kernel
    np.testing.assert_array_equal(masked.numpy().view(np.int32),
                                  np.asarray(r_masked).view(np.int32))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(r_mask))
    np.testing.assert_array_equal(mask.sum(1).numpy(), kk)


def test_rows_views_read_the_kernels_layout():
    ws = tk.rows_workspace(3, "cpu")
    assert ws.shape == (3, tk._WS_COUNTS) and not ws.any()
    for r, (t, n_take) in enumerate(((7, -5), (2 ** 31 - 1, 3 << 33),
                                     (0, 1))):
        ws[r, tk._WS_CTRL + 6] = t
        ws[r, tk._WS_CTRL + 8:tk._WS_CTRL + 10] = torch.tensor(
            [n_take], dtype=torch.int64).view(torch.int32)
        ws[r, tk._WS_HIST[2] + 511] = r + 1
    views = tk.rows_views(ws)
    assert views["t"].tolist() == [7, 2 ** 31 - 1, 0]
    assert views["n_take"].tolist() == [-5, 3 << 33, 1]
    assert [h.shape[1] for h in views["hists"]] == [2048, 2048, 512]
    assert views["hists"][2][:, 511].tolist() == [1, 2, 3]


def test_rows_wrappers_refuse_other_devices():
    x = torch.zeros((2, 100))
    kk = torch.zeros(2, dtype=torch.int64)
    ws = tk.rows_workspace(2, "cpu")
    with pytest.raises(ValueError, match="device"):
        tk.rows_hist(x, kk, ws, 0)
    with pytest.raises(ValueError, match="device"):
        tk.rows_radix(x, kk)
    with pytest.raises(ValueError, match="device"):
        tk.rows_select(x, ws)
    with pytest.raises(ValueError, match="device"):
        tk.rows_resid(x[0], x[0], ws)
    meta = torch.zeros((2, 100), device="meta")
    with pytest.raises(ValueError, match="device"):
        tk.topk_select(meta, 5, 5)
    with pytest.raises(ValueError, match="workspace"):
        tk._check_workspace(tk.rows_workspace(3, "meta"), meta, "rows_select")
