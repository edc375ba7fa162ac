"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test here skips. On a
machine with one (and without JAX, so without the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Each kernel must equal its plain version bitwise at small shapes, odd
lengths and a nonzero block offset included; ``chip_smoke.py`` repeats
this at the main path's full width.
"""

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.countsketch import CountSketch
from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
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
