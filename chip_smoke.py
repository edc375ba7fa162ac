#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (commefficient_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from csrc/ (one nvcc per source, all at once), timed;
2. kernel parity at full width, every kernel against its plain PyTorch
   version, bitwise:
   - a seeded (6,568,640,) vector sketched into a 5 x 500,096 table
     (twice: the kernel is deterministic), then the fused unsketch + top-k
     at k=50,000, and a table with planted ties;
   - the plain count and select on an (8, 6,568,640) batch with per-row
     k of 50,000 / 25,000 / 1, planted ties across tiles and an all-zero
     row; the resid select on (err, v) at d with planted ties and with
     selected +-0.0; the estimates of the sketched table, which must also
     equal the fused selection's masked values where its mask is set;
   - the batched estimates of 8 tables (the sketched one, an all-zero one,
     seeded normals) at B = 8, 3 and 1, every table bitwise equal to the
     unbatched kernel and to the plain version, and the same over two
     runs;
   - one sketch-mode server step with --server_fused auto against off:
     update, Vvelocity and Verror bitwise equal (each step also timed);
   - the batched sketch on an (8, 6,568,640) batch (an all-zero row and a
     row of planted heavy coordinates among seeded ones) and on an offset
     slice of it, row by row bitwise equal to its plain version and to the
     unbatched kernel, and the same over two runs;
3. kernel times with CUDA events (median of 25), beside the plain
   versions, one PyTorch library call for the same work where there is
   one, and the bound computed from this run's bytes and operations;
4. the main paths, each ``training.cv.train(args, max_rounds=3)`` at
   ResNet9's full width (d = 6,568,640) on Synthetic with 8 workers and
   k=50,000, every launch counter set to 0 just before it and read just
   after:
   - sketch (the headline FetchSGD flags, 5 x 500k, virtual error and
     momentum 0.9, 32 images a worker): sketch 3, count 27, select 3;
   - true_topk (virtual error, momentum 0.9): count_plain 27,
     select_resid 3;
   - local_topk (local error and momentum 0.9, 100 clients): count_plain
     27 (8 rows a launch), select_plain 3;
   - sketch with --server_fused off: sketch 3, estimates_batched 3 (the
     reference's off branch runs the batched grid at B = 1);
   - uncompressed (momentum 0.9) and fedavg (2 local epochs in chunks of
     16, lr decay 0.9): no kernel;
   - sketch_clip (the sketch flags + --max_grad_norm 1.0) and sketch_dp
     (+ --dp --dp_mode worker --l2_norm_clip 1.0 --noise_multiplier 1e-3):
     the per-worker sketch, sketch_batched 3 (the 8 clients' tables in one
     launch a round), count 27, select 3, and no unbatched sketch;
   - uncompressed_dp_server (+ --dp --dp_mode server, the same clip and
     noise): no kernel;
   with finite losses and weights and exact upload bytes per client;
5. a reference check on a small input: two rounds of a narrow ResNet9
   learner on CUDA (kernels) and on the CPU (plain versions) from the same
   weights and batches must agree, in sketch, true_topk and local_topk,
   and in sketch with --max_grad_norm and with DP (noise 0);
6. the flash attention kernels (forward, dq, dkv) against their plain
   versions at the GPT2 path's shape (BH 768 = 64 sequences x 12 heads,
   T 256, D 64): float32 at dropout 0 and 0.1 (O within 1e-5, dq/dk/dv
   within 1e-4 of their largest magnitude), float32 at dropout 0.1 at the
   gpt2_clip path's per-client shape (BH 192 = 16 sequences x 12 heads;
   the same limits), bfloat16 (O within 2e-2),
   and T 1100, D 128 at dropout 0.1 (three logical dropout tiles, a
   ragged end); every kernel run twice, bitwise equal; then their times
   beside the plain versions, the bound and
   ``scaled_dot_product_attention`` (forward, and its autograd backward);
   then the checks of phase 2's first item and the kernel times of phase 3
   for sketch, count and select again at the GPT2 path's d = 124,051,201
   (a seeded vector into the same 5 x 500,096 table, k = 50,000; plain
   versions timed over 3 runs), and the batched sketch's check and times
   at that d with B = 4; then the hardware-RNG dropout kernel against its
   plain version, bitwise: the GPT2 path's (64, 256, 768) float32 at rates
   0.1 and 0.5, the mc head's (64, 768), a (300, 1024) view with a partial
   logical block and a bfloat16 case, each twice; the reference's contract
   at (512, 1024), rate 0.1 (keep fraction within 5e-3 of 0.9, kept values
   exactly f32(1/0.9), the gradient of the sum equal to the output, a
   second seed differing in over 10%); its time at (64, 256, 768) beside
   the plain version, ``torch.nn.functional.dropout`` and the bound;
7. the GPT2 path: ``training.gpt2.train(args, max_rounds=3)`` with the
   flags of ``examples/gpt2_personachat.sh`` on SyntheticPersona at
   GPT2-small's width (d = 124,051,201, ``--attn_impl blockwise``,
   sketch 5 x 500k, k = 50,000, 4 workers of 8 dialogs x 2 candidates x
   256 tokens): counters zeroed just before the rounds and read when the
   validation pass starts (flash_fwd, flash_bwd_dq, flash_bwd_dkv 36
   each, sketch 3, count 27, select 3), the validation pass's launches
   read apart (flash_fwd 12 per batch, nothing else); finite losses,
   weights and validation nll, exact upload bytes; round ms printed;
   then round 3's batch once more under ``torch.profiler``, its device
   time printed by kernel class beside its wall time; then the same with
   --max_grad_norm 1.0 (gpt2_clip): the per-worker path, one forward and
   backward per client, so flash_fwd, flash_bwd_dq, flash_bwd_dkv 144 each
   (12 layers x 4 clients x 3 rounds), sketch_batched 3, count 27, select
   3, and no unbatched sketch; its round 3 profiled in the same way; then
   gpt2_tpu_bits, the gpt2 flags with ``args.dropout_impl = "tpu_bits"``
   set on the parsed namespace (no CLI value selects it, as in the
   reference): gpt2's launches and hw_dropout 156 (26 sites a forward, 26
   a backward, 3 rounds), none in validation; profiled in the same way;
8. a reference check of a narrow GPT2 learner (2 layers) on CUDA (flash
   kernels) and on the CPU: two sketch rounds from the same weights and
   batches, losses within 1e-4 relative, bytes equal; at dropout 0, and
   with tpu_bits at dropout 0.1 (attention dropout on the output on both
   sides), where the card's dropout kernel and the CPU's plain version
   draw the same bits.

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository (the port's package not beside it), it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--virtual_momentum", "0.9", "--num_workers", "8",
            "--local_batch_size", "32", "--k", "50000", "--num_rows", "5",
            "--num_cols", "500000", "--dataset_name", "Synthetic",
            "--device", "cuda"]
D_RESNET9 = 6_568_640
K = 50_000
TABLE_FLOATS = 5 * 500_096
_BASE = ["--num_workers", "8", "--k", "50000", "--dataset_name",
         "Synthetic", "--device", "cuda"]
# name: (flags, launches over 3 rounds, upload bytes per client)
PATHS = {
    "sketch": (HEADLINE, {"sketch": 3, "count": 27, "select": 3},
               4 * TABLE_FLOATS),
    "true_topk": (_BASE + ["--mode", "true_topk", "--error_type", "virtual",
                           "--virtual_momentum", "0.9",
                           "--local_batch_size", "32"],
                  {"count_plain": 27, "select_resid": 3}, 4 * D_RESNET9),
    "local_topk": (_BASE + ["--mode", "local_topk", "--error_type", "local",
                            "--local_momentum", "0.9", "--num_clients",
                            "100", "--local_batch_size", "32"],
                   {"count_plain": 27, "select_plain": 3}, 4 * K),
    # the reference's off branch runs the batched estimates grid at B = 1
    "sketch_server_fused_off": (HEADLINE + ["--server_fused", "off"],
                                {"sketch": 3, "estimates_batched": 3},
                                4 * TABLE_FLOATS),
    "uncompressed": (_BASE + ["--mode", "uncompressed",
                              "--virtual_momentum", "0.9",
                              "--local_batch_size", "32"], {},
                     4 * D_RESNET9),
    "fedavg": (_BASE + ["--mode", "fedavg", "--local_batch_size", "-1",
                        "--num_fedavg_epochs", "2", "--fedavg_batch_size",
                        "16", "--fedavg_lr_decay", "0.9"], {},
               4 * D_RESNET9),
}
DP_FLAGS = ["--l2_norm_clip", "1.0", "--noise_multiplier", "1e-3"]
# the per-worker sketch: the W clients' tables in one batched launch a
# round, and no sketch of the aggregate
PER_WORKER_SKETCH = {"sketch_batched": 3, "count": 27, "select": 3}
PATHS.update({
    "sketch_clip": (HEADLINE + ["--max_grad_norm", "1.0"],
                    PER_WORKER_SKETCH, 4 * TABLE_FLOATS),
    "sketch_dp": (HEADLINE + ["--dp", "--dp_mode", "worker"] + DP_FLAGS,
                  PER_WORKER_SKETCH, 4 * TABLE_FLOATS),
    "uncompressed_dp_server": (PATHS["uncompressed"][0] + [
        "--dp", "--dp_mode", "server"] + DP_FLAGS, {}, 4 * D_RESNET9),
})
# per-row k of the batched parity check: full, an all-zero row, contested
# ties at k/2, and k = 1
KK_ROWS = [K, K, K // 2, 1, K, K, K, K]
GPT2_FLAGS = ["--model", "gpt2", "--vocab_pad_to", "50262", "--attn_impl",
              "blockwise", "--mode", "sketch", "--error_type", "virtual",
              "--virtual_momentum", "0.9", "--num_workers", "4",
              "--local_batch_size", "8", "--k", "50000", "--num_rows", "5",
              "--num_cols", "500000", "--max_seq_len", "256", "--lr_scale",
              "0.04", "--weight_decay", "0", "--dataset_name",
              "SyntheticPersona", "--device", "cuda"]
D_GPT2 = 124_051_201
# name: (extra flags, attributes set on the parsed namespace, launches over
# 3 rounds). gpt2: 12 layers a round, the sketch of d = 124M one launch a
# round; gpt2_clip: the per-worker path, one forward and backward per
# client (12 layers x 4 clients a round), the 4 clients' tables in one
# batched launch a round; gpt2_tpu_bits: dropout_impl "tpu_bits", which no
# CLI value selects (as in the reference), so 26 hardware-RNG dropout
# sites a forward (the embedding, each layer's attention projection and
# MLP, the mc head; the attention probabilities stay in the flash
# kernels) and 26 in the backward
GPT2_SKETCH = {"flash_fwd": 36, "flash_bwd_dq": 36, "flash_bwd_dkv": 36,
               "sketch": 3, "count": 27, "select": 3}
GPT2_PATHS = {
    "gpt2": ([], {}, GPT2_SKETCH),
    "gpt2_clip": (["--max_grad_norm", "1.0"], {},
                  {"flash_fwd": 144, "flash_bwd_dq": 144,
                   "flash_bwd_dkv": 144, "sketch_batched": 3, "count": 27,
                   "select": 3}),
    "gpt2_tpu_bits": ([], {"dropout_impl": "tpu_bits"},
                      dict(GPT2_SKETCH, hw_dropout=156)),
}
GPT2_WORKERS = 4
FLASH_SHAPE = (768, 256, 64)      # (BH, T, D) of the GPT2 path
# gpt2_clip runs the attention one client at a time: BH = 768 / 4 = 192
FLASH_SHAPE_CLIENT = (FLASH_SHAPE[0] // GPT2_WORKERS,) + FLASH_SHAPE[1:]
FLASH_RATE = 0.1
# the hardware-RNG dropout's inputs on the GPT2 path: the (64, 256, 768)
# activations at every site but the mc head's (64, 768)
HW_SHAPE = (64, 256, 768)
HW_RATE = 0.1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
REPS = 25


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _same_bits(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _time_ms(fn, reps=REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warmup."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(nbytes: float, ops: float):
    """(ms, kind): the larger of bytes over HBM rate and operations over
    the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# integer and float operations per (row, coordinate) of the tiled hash:
# the cubic sign polynomial (3 mul + 3 add), the murmur finalizer (2 mul,
# 3 shift, 3 xor), the low-bit test and the select (2); the window read's
# address (2); per (row, block) the two block mixes, modulo and mask (~25)
_OPS_SIGN = 16
_OPS_BLOCK = 25
_OPS_MEDIAN = {1: 0, 3: 4, 5: 10}


def _sketch_cost(cs, B=1):
    """B vectors of length d into B tables: each vector read and each
    table written once; the hashing once (the batched kernel shares it
    between its rows) plus one add per (batch row, row, coordinate)."""
    nbytes = B * (4 * cs.d + 4 * cs.r * cs.c_eff)
    ops = (cs.r * cs.d * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
           + B * cs.r * cs.d)
    return _bound(nbytes, ops)


def _estimate_ops(cs):
    return (cs.d * (cs.r * (_OPS_SIGN + 3) + _OPS_MEDIAN[cs.r] + 1)
            + cs.r * cs.nblocks * _OPS_BLOCK)


def _count_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 4 * 16 + 4 * 16
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 32)


def _select_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 8 + 4 * cs.d + 4 * cs.d
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 4)


def _count_plain_cost(rows, n):
    # per element: the square, 16 compares and 16 adds; 16 candidates
    # read and 16 counts written per row
    return _bound(4 * rows * n + 2 * 4 * 16 * rows, rows * n * 33)


def _select_plain_cost(rows, n):
    # the stream read, the masked stream written (no mask); per element
    # the square, two compares, the rank and the select
    return _bound(4 * rows * n * 2 + 12 * rows, rows * n * 6)


def _select_resid_cost(n):
    # (err, v) read, (update, velocity, error) written
    return _bound(4 * n * 5 + 12, n * 8)


def _estimates_cost(cs):
    return _bound(4 * cs.r * cs.c_eff + 4 * cs.d, _estimate_ops(cs))


def _estimates_batched_cost(cs, B):
    """B tables read and B (d,) vectors written once; the window hashes and
    signs once per coordinate for all tables, then r gathers and products
    and the median per (table, coordinate)."""
    ops = (cs.d * cs.r * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
           + B * cs.d * (cs.r + _OPS_MEDIAN[cs.r] + 1))
    return _bound(B * (4 * cs.r * cs.c_eff + 4 * cs.d), ops)


# operations of the hardware-RNG dropout an element: the position's two
# products and sum, the block seed's product and sum, the finalizer's three
# shifts, four xors and two products, the compare, the multiply and the
# select
_OPS_HW = 20


def _hw_dropout_cost(n, itemsize=4):
    """x read and the output written once; the hash an element."""
    return _bound(2 * itemsize * n, _OPS_HW * n)


def phase_build():
    from commefficient_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    for name in cuda_lib.SOURCES:
        log = cuda_lib.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")


def phase_parity(dev, d, errs):
    """Sketch, count, select and the fused unsketch + top-k against their
    plain versions, bitwise, at ``d`` with the main paths' 5 x 500k table
    and k; the largest error of each kernel goes into ``errs``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
                                                            sketch_vec_plain)
    cs = CountSketch(d, 500_000, 5, seed=42)
    rng = np.random.RandomState(0)
    x = (rng.randn(cs.d) * 1e-3).astype(np.float32)
    hot = rng.choice(cs.d, 2 * K, replace=False)
    x[hot] += rng.randn(2 * K).astype(np.float32)
    vec = torch.from_numpy(x).to(dev)
    del x, hot

    table = sketch_vec(cs, vec)
    again = sketch_vec(cs, vec)
    plain = sketch_vec_plain(cs, vec)
    torch.cuda.synchronize()
    if not _same_bits(table, again):
        raise AssertionError("sketch kernel differs between two runs")
    if not _same_bits(table, plain):
        raise AssertionError("sketch kernel != plain version, max abs err "
                             f"{_max_abs_err(table, plain)}")
    off = 1000   # a bucket-style slice placed at block 1000
    part = vec[off * 128: off * 128 + cs.d // 3].contiguous()
    if not _same_bits(sketch_vec(cs, part, off),
                      sketch_vec_plain(cs, part, off)):
        raise AssertionError("sketch kernel != plain version at an offset")
    errs["sketch"] = max(errs.get("sketch", 0.0), _max_abs_err(table, plain))
    del again, plain
    print(f"parity sketch: bitwise equal to plain at d={cs.d}, table "
          f"{cs.r}x{cs.c_eff}, deterministic over 2 runs, offset slice ok",
          flush=True)

    ties = torch.from_numpy(rng.choice(
        np.array([-3, -2, -1, 1, 2, 3], np.float32),
        size=(cs.r, cs.c_eff))).to(dev)
    for name, tab in (("sketched vector", table), ("planted ties", ties)):
        masked, mask = tk.unsketch_select(cs, tab, K)
        p_masked, p_mask = tk.unsketch_select_plain(cs, tab, K)
        if not (_same_bits(masked, p_masked) and _same_bits(mask, p_mask)):
            raise AssertionError(f"unsketch_select != plain ({name})")
        n_sel = int(mask.sum())
        if n_sel != K:
            raise AssertionError(f"selected {n_sel} != k={K} ({name})")
        # the two kernels on their own, at this table's radix candidates
        t, n_take = tk._radix_threshold(
            lambda c: tk.count_plain(cs, tab, c), K, dev)
        for cands in (tk._wrap_i32(torch.arange(16, device=dev) << 28),
                      tk._wrap_i32(t.long() + torch.arange(16, device=dev)
                                   - 8)):
            kc, pc = tk.count(cs, tab, cands), tk.count_plain(cs, tab, cands)
            if not torch.equal(kc, pc):
                raise AssertionError(f"count kernel {kc.tolist()} != plain "
                                     f"{pc.tolist()} ({name})")
            errs["count"] = max(errs.get("count", 0.0), _max_abs_err(kc, pc))
        ks = tk.select(cs, tab, t, n_take)
        ps = tk.select_plain(cs, tab, t, n_take)
        if not (_same_bits(ks[0], ps[0]) and _same_bits(ks[1], ps[1])):
            raise AssertionError(f"select kernel != plain ({name})")
        errs["select"] = max(errs.get("select", 0.0),
                             _max_abs_err(ks[0], ps[0]),
                             _max_abs_err(ks[1], ps[1]))
        print(f"parity unsketch_select ({name}, d={cs.d}): count, select "
              f"and the fused k={K} selection bitwise equal to plain; "
              f"threshold bits {int(t)}, ties taken {int(n_take)}",
              flush=True)
    return cs, vec, table


def _resid_inputs(dev, rng, sparse):
    """(g, vv, ve) at d: 2k ties at |err| = 6 (above all but ~2k normals
    at d = 6.57M, so k = 50k lands in them), or with only 0.6k nonzero
    coordinates and the rest +-0.0, so k selects zeros too."""
    import torch
    g, vv, ve = (rng.randn(D_RESNET9).astype(np.float32) for _ in range(3))
    if sparse:
        zero = rng.permutation(D_RESNET9)[3 * K // 5:]
        for a in (g, vv, ve):
            a[zero] = 0.0
            a[zero[::2]] = -0.0   # err = -0.0 + (-0.0 + 0.9 * -0.0)
    else:
        tie = rng.choice(D_RESNET9, 2 * K, replace=False)
        g[tie], vv[tie], ve[tie] = 6.0, 0.0, 0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (g, vv, ve))


def phase_parity_stream(dev, cs, table, errs):
    """The plain count and select (B = 8, per-row k), the resid select,
    the estimates, and the server step with its two recovery routes."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.server import (make_sketch,
                                                          server_update)
    from commefficient_tpu_torch.federated.state import ServerOptState
    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (estimates,
                                                            estimates_plain)
    rng = np.random.RandomState(1)
    x = rng.randn(len(KK_ROWS), D_RESNET9).astype(np.float32)
    x[1] = 0.0                                     # every score ties at 0
    x[2, rng.choice(D_RESNET9, 3 * K, replace=False)] = 3.0
    xs = torch.from_numpy(x).to(dev)
    kk = torch.tensor(KK_ROWS, device=dev)
    t, n_take = tk._radix_threshold_batched(
        lambda c: tk.count_rows_plain(xs, c), kk, dev)
    errs["count_plain"] = errs["select_plain"] = 0.0
    for cands in (tk._wrap_i32(torch.arange(16, device=dev) << 28).expand(
            len(KK_ROWS), 16).contiguous(),
            tk._wrap_i32(t.long()[:, None] + torch.arange(16, device=dev)
                         - 8)):
        kc, pc = tk.count_rows(xs, cands), tk.count_rows_plain(xs, cands)
        if not torch.equal(kc, pc):
            raise AssertionError("count_plain kernel != plain version")
        errs["count_plain"] = max(errs["count_plain"], _max_abs_err(kc, pc))
    for with_mask in (True, False):
        ks = tk.select_rows(xs, t, n_take, with_mask)
        ps = tk.select_rows_plain(xs, t, n_take, with_mask)
        if not _same_bits(ks[0], ps[0]) or (
                with_mask and not _same_bits(ks[1], ps[1])):
            raise AssertionError("select_plain kernel != plain version")
        errs["select_plain"] = max(errs["select_plain"],
                                   _max_abs_err(ks[0], ps[0]))
    sums = ks[0].ne(0).sum(1).tolist()
    mask_sums = tk.select_rows(xs, t, n_take, True)[1].sum(1)
    if not torch.equal(mask_sums, kk):
        raise AssertionError(f"per-row selections {mask_sums.tolist()} "
                             f"!= kk {KK_ROWS}")
    if not _same_bits(tk.topk_select(xs, kk, K), ps[0]):
        raise AssertionError("topk_select != plain selection")
    print(f"parity count_plain/select_plain (8 x {D_RESNET9}, kk "
          f"{KK_ROWS}): bitwise equal to plain, with and without mask; "
          f"nonzeros kept {sums}, ties taken {n_take.tolist()}", flush=True)
    del ks, ps

    errs["select_resid"] = 0.0
    for name, sparse in (("planted ties", False), ("selected +-0.0", True)):
        g, vv, ve = _resid_inputs(dev, rng, sparse)
        v = g + 0.9 * vv
        err = ve + v
        t1, n1 = tk._radix_threshold(
            lambda c: tk.count_rows_plain(err[None], c[None])[0], K, dev)
        got = tk.select_resid(err, v, t1, n1)
        ref = tk.select_resid_plain(err, v, t1, n1)
        fused = tk.fused_true_topk(g, vv, ve, K, 0.9)
        for a, b, c in zip(got, ref, fused):
            if not (_same_bits(a, b) and _same_bits(c, b)):
                raise AssertionError(f"select_resid != plain ({name})")
            errs["select_resid"] = max(errs["select_resid"],
                                       _max_abs_err(a, b))
        upd = got[0]
        kept_neg0 = int(((upd == 0) & torch.signbit(upd)
                         & torch.signbit(got[2])).sum())
        if sparse and kept_neg0 == 0:
            raise AssertionError("no selected -0.0 kept its residual")
        print(f"parity select_resid ({name}): update, velocity, error "
              f"bitwise equal to plain and to fused_true_topk; ties taken "
              f"{int(n1)}, selected -0.0 kept {kept_neg0}", flush=True)
    inputs = {"xs": xs, "kk": kk, "t": t, "n_take": n_take, "err": err,
              "v": v, "t1": t1, "n1": n1}

    est = estimates(cs, table)
    p_est = estimates_plain(cs, table)
    masked, mask = tk.unsketch_select(cs, table, K)
    sel = mask.bool()
    if not _same_bits(est, p_est) or not _same_bits(masked[sel], est[sel]):
        raise AssertionError("estimates kernel != plain / fused selection")
    errs["estimates"] = _max_abs_err(est, p_est)
    print(f"parity estimates: bitwise equal to plain at d={cs.d}, and to "
          f"the fused selection's {int(sel.sum())} masked values",
          flush=True)

    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=K, num_cols=cs.c,
                    num_rows=cs.r).finalize(cs.d)
    sketch = make_sketch(cfg)
    state = ServerOptState(*(torch.from_numpy(
        rng.randn(*cfg.transmit_shape).astype(np.float32)).to(dev)
        for _ in range(2)))
    outs = [server_update(table, state, replace(cfg, server_fused=f),
                          0.1, sketch) for f in ("auto", "off")]
    (ua, sa), (uo, so) = outs
    if not (_same_bits(ua, uo) and _same_bits(sa.Vvelocity, so.Vvelocity)
            and _same_bits(sa.Verror, so.Verror)):
        raise AssertionError("server step: --server_fused auto != off")
    step_ms = {f: _time_ms(lambda c=replace(cfg, server_fused=f):
                           server_update(table, state, c, 0.1, sketch))
               for f in ("auto", "off")}
    print(f"server A/B (sketch, k={K}): --server_fused auto and off give "
          f"bitwise equal update ({int(ua.ne(0).sum())} nonzeros), "
          f"Vvelocity and Verror; one server step takes "
          f"{step_ms['auto']:.4f} ms auto, {step_ms['off']:.4f} ms off",
          flush=True)
    return inputs


def phase_parity_batched(dev, d, B, errs):
    """The batched sketch of a seeded (B, d) batch (row 1 all zero, row 2
    with 2k planted heavy coordinates) and of an offset slice of it, row by
    row bitwise equal to its plain version and to the unbatched kernel,
    and the same over two runs. Returns ``(cs, vecs)``."""
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.ops.sketch_kernels import (
        sketch_vec, sketch_vec_batched, sketch_vec_batched_plain)
    cs = CountSketch(d, 500_000, 5, seed=42)
    gen = torch.Generator(device=dev).manual_seed(B)
    vecs = torch.randn(B, d, generator=gen, device=dev) * 1e-3
    vecs[1] = 0.0
    hot = torch.randperm(d, generator=gen, device=dev)[:2 * K]
    vecs[2, hot] += torch.randn(2 * K, generator=gen, device=dev)
    del hot
    off = 1000    # a bucket-style slice placed at block 1000
    part = vecs[:, off * 128: off * 128 + d // 3].contiguous()
    for tag, x, o in (("", vecs, 0), (f", offset block {off}", part, off)):
        got = sketch_vec_batched(cs, x, o)
        again = sketch_vec_batched(cs, x, o)
        torch.cuda.synchronize()
        if not _same_bits(got, again):
            raise AssertionError(f"sketch_batched differs between two runs"
                                 f" (B={B}, d={d}{tag})")
        for b in range(B):
            plain = sketch_vec_batched_plain(cs, x[b:b + 1], o)[0]
            one = sketch_vec(cs, x[b], o)
            if not (_same_bits(got[b], plain) and _same_bits(got[b], one)):
                raise AssertionError(
                    f"sketch_batched row {b} != plain / unbatched kernel "
                    f"(B={B}, d={d}{tag}), max abs err "
                    f"{_max_abs_err(got[b], plain)}")
            errs["sketch_batched"] = max(errs.get("sketch_batched", 0.0),
                                         _max_abs_err(got[b], plain))
            del plain, one
        if got[1].any():
            raise AssertionError("sketch_batched: the all-zero row's table "
                                 "is not zero")
        del got, again
    del part
    print(f"parity sketch_batched (B={B}, d={d}, table {cs.r}x{cs.c_eff}): "
          f"every row bitwise equal to plain and to the unbatched kernel, "
          f"an all-zero row and a planted row included, offset slice ok, "
          f"deterministic over 2 runs", flush=True)
    return cs, vecs


def phase_timing_batched(cs, vecs, plain_reps=REPS):
    """Times of the batched sketch beside its plain version, B launches of
    the unbatched kernel, one ``index_add_`` per row at precomputed
    buckets (the library call) and the bound."""
    import torch

    from commefficient_tpu_torch.ops.sketch_kernels import (
        sketch_vec, sketch_vec_batched, sketch_vec_batched_plain)
    B, d = vecs.shape
    dev = vecs.device
    buckets, signs = [], []
    for row in range(cs.r):
        s, b = cs._row_hashes(row, torch.arange(d, device=dev))
        buckets.append(b + row * cs.c_eff)
        signs.append(s)
    buckets, signs = torch.cat(buckets), torch.cat(signs)
    signed = [signs * vecs[b].repeat(cs.r) for b in range(B)]
    del signs
    flat = torch.zeros(B, cs.r * cs.c_eff, device=dev)

    def library():
        for b in range(B):
            flat[b].index_add_(0, buckets, signed[b])

    r = dict(
        ms=_time_ms(lambda: sketch_vec_batched(cs, vecs)),
        plain_ms=_time_ms(lambda: sketch_vec_batched_plain(cs, vecs),
                          plain_reps),
        library_ms=_time_ms(library),
        unbatched_ms=_time_ms(lambda: [sketch_vec(cs, vecs[b])
                                       for b in range(B)]),
        cost=_sketch_cost(cs, B), at=f"B={B}, d={d}")
    del buckets, signed, flat
    torch.cuda.empty_cache()
    bound_ms, kind = r["cost"]
    print(f"time sketch_batched ({r['at']}): kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
          f"{B} unbatched launches {r['unbatched_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: sketch_batched = {B} index_add_ calls, one per row, "
          f"of the {cs.r}x{d} signed values at precomputed buckets "
          f"(scatter only, atomic order)", flush=True)
    return r


def phase_timing(cs, vec, table, plain_reps=REPS):
    """Times of the sketch, count and select kernels at ``cs.d`` beside
    their plain versions (median of ``plain_reps``), the library calls and
    the bound."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
                                                            sketch_vec_plain)
    dev = vec.device
    t, n_take = tk._radix_threshold(lambda c: tk.count(cs, table, c), K, dev)
    cands = tk._wrap_i32(t.long() + torch.arange(16, device=dev) - 8)
    est = cs.estimates(table)
    scores = est * est
    # the same scatter as one library call, hashes precomputed: the
    # sketch's index_add_ yardstick (scatter only, atomic order)
    buckets, signed = [], []
    for row in range(cs.r):
        s, b = cs._row_hashes(row, torch.arange(cs.d, device=dev))
        buckets.append(b + row * cs.c_eff)
        signed.append(s * vec)
    buckets, signed = torch.cat(buckets), torch.cat(signed)
    flat = torch.zeros(cs.r * cs.c_eff, device=dev)
    topk_ms = _time_ms(lambda: torch.topk(scores, K))
    rows = {
        "sketch": dict(
            ms=_time_ms(lambda: sketch_vec(cs, vec)),
            plain_ms=_time_ms(lambda: sketch_vec_plain(cs, vec),
                              plain_reps),
            library_ms=_time_ms(lambda: flat.index_add_(0, buckets, signed)),
            cost=_sketch_cost(cs)),
        "count": dict(
            ms=_time_ms(lambda: tk.count(cs, table, cands)),
            plain_ms=_time_ms(lambda: tk.count_plain(cs, table, cands),
                              plain_reps),
            library_ms=topk_ms, cost=_count_cost(cs)),
        "select": dict(
            ms=_time_ms(lambda: tk.select(cs, table, t, n_take)),
            plain_ms=_time_ms(lambda: tk.select_plain(cs, table, t, n_take),
                              plain_reps),
            library_ms=topk_ms, cost=_select_cost(cs)),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} (d={cs.d}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: sketch = index_add_ of the {cs.r}x{cs.d} signed "
          f"values at precomputed buckets (scatter only); count, select = "
          f"torch.topk(k={K}) of the (d,) squared estimates (selection "
          f"only, for the count+select pair)", flush=True)
    return rows


def phase_timing_stream(cs, table, inputs):
    """Times of the plain/resid count and select kernels at the main
    paths' shapes (B = 8 for local_topk, B = 1 for true_topk) and of the
    estimates kernel."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import (estimates,
                                                            estimates_plain)
    xs, t, n_take = inputs["xs"], inputs["t"], inputs["n_take"]
    err, v, t1, n1 = inputs["err"], inputs["v"], inputs["t1"], inputs["n1"]
    B, n = xs.shape
    dev = xs.device
    cands = tk._wrap_i32(t.long()[:, None] + torch.arange(16, device=dev)
                         - 8)
    err_rows = err[None]
    cands1 = tk._wrap_i32(t1.long() + torch.arange(16, device=dev)
                          - 8)[None]
    scores8, scores1 = xs * xs, err * err
    topk_b8 = _time_ms(lambda: torch.topk(scores8, K, dim=-1))
    topk_b1 = _time_ms(lambda: torch.topk(scores1, K))
    rows = {
        "count_plain": dict(
            ms=_time_ms(lambda: tk.count_rows(xs, cands)),
            plain_ms=_time_ms(lambda: tk.count_rows_plain(xs, cands)),
            library_ms=topk_b8, cost=_count_plain_cost(B, n),
            at=f"B={B}, n={n}"),
        "count_plain_b1": dict(
            ms=_time_ms(lambda: tk.count_rows(err_rows, cands1)),
            plain_ms=_time_ms(lambda: tk.count_rows_plain(err_rows, cands1)),
            library_ms=topk_b1, cost=_count_plain_cost(1, n),
            at=f"B=1, n={n}"),
        "select_plain": dict(
            ms=_time_ms(lambda: tk.select_rows(xs, t, n_take)),
            plain_ms=_time_ms(lambda: tk.select_rows_plain(xs, t, n_take)),
            library_ms=topk_b8, cost=_select_plain_cost(B, n),
            at=f"B={B}, n={n}, no mask"),
        "select_resid": dict(
            ms=_time_ms(lambda: tk.select_resid(err, v, t1, n1)),
            plain_ms=_time_ms(lambda: tk.select_resid_plain(err, v, t1, n1)),
            library_ms=topk_b1, cost=_select_resid_cost(n),
            at=f"n={n}"),
        "estimates": dict(
            ms=_time_ms(lambda: estimates(cs, table)),
            plain_ms=_time_ms(lambda: estimates_plain(cs, table)),
            library_ms=None, cost=_estimates_cost(cs),
            at=f"{cs.r}x{cs.c_eff} -> {cs.d}; no main path launches this "
               "unbatched grid: --server_fused off takes estimates_batched "
               "at B=1, as the reference does"),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"time {name} ({r['at']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: count_plain, select_plain = torch.topk(k={K}, "
          f"dim=-1) of the 8 rows' squares; count_plain_b1, select_resid = "
          f"torch.topk(k={K}) of err's squares (selection only, for the "
          f"count+select pair); estimates: no single library call",
          flush=True)
    return rows


def phase_parity_estimates_batched(dev, cs, table, errs):
    """The batched estimates of 8 tables (the sketched table of phase 2,
    an all-zero one, seeded normals) at B = 8, 3 (a partial tile of 8) and
    1, each table bitwise equal to the unbatched kernel and to the plain
    version, and the same over two runs. Returns the 8 tables."""
    import torch

    from commefficient_tpu_torch.ops.sketch_kernels import (
        estimates, estimates_batched, estimates_plain)
    gen = torch.Generator(device=dev).manual_seed(4)
    tables = torch.randn((8, cs.r, cs.c_eff), generator=gen, device=dev)
    tables[0] = table
    tables[1] = 0.0
    errs["estimates_batched"] = 0.0
    for B in (8, 3, 1):
        got = estimates_batched(cs, tables[:B])
        again = estimates_batched(cs, tables[:B])
        torch.cuda.synchronize()
        if not _same_bits(got, again):
            raise AssertionError(f"estimates_batched differs between two "
                                 f"runs (B={B})")
        for b in range(B):
            plain = estimates_plain(cs, tables[b])
            if not (_same_bits(got[b], plain)
                    and _same_bits(got[b], estimates(cs, tables[b]))):
                raise AssertionError(
                    f"estimates_batched table {b} != plain / unbatched "
                    f"kernel (B={B}), max abs err "
                    f"{_max_abs_err(got[b], plain)}")
            errs["estimates_batched"] = max(errs["estimates_batched"],
                                            _max_abs_err(got[b], plain))
        del got, again
    print(f"parity estimates_batched (B = 8, 3, 1, d={cs.d}): every table "
          f"bitwise equal to plain and to the unbatched kernel, the "
          f"sketched table and an all-zero one included, deterministic "
          f"over 2 runs", flush=True)
    return tables


def phase_timing_estimates_batched(cs, table, tables):
    """Times of the batched estimates at B = 8 beside its plain version
    and 8 launches of the unbatched kernel, and at B = 1 beside the
    unbatched kernel (row 4)."""
    from commefficient_tpu_torch.ops.sketch_kernels import (
        estimates, estimates_batched, estimates_batched_plain)
    B = tables.shape[0]
    one = table[None]
    r = dict(
        ms=_time_ms(lambda: estimates_batched(cs, tables)),
        plain_ms=_time_ms(lambda: estimates_batched_plain(cs, tables)),
        library_ms=None,
        unbatched_ms=_time_ms(lambda: [estimates(cs, t) for t in tables]),
        b1_ms=_time_ms(lambda: estimates_batched(cs, one)),
        row4_ms=_time_ms(lambda: estimates(cs, table)),
        cost=_estimates_batched_cost(cs, B),
        at=f"B={B}, {cs.r}x{cs.c_eff} -> {cs.d}")
    bound_ms, kind = r["cost"]
    print(f"time estimates_batched ({r['at']}): kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, library none, {B} unbatched "
          f"launches {r['unbatched_ms']:.4f} ms, bound {bound_ms:.5f} ms "
          f"({kind}); at B=1 {r['b1_ms']:.4f} ms against the unbatched "
          f"kernel's {r['row4_ms']:.4f} ms (bound "
          f"{_estimates_batched_cost(cs, 1)[0]:.5f} ms)", flush=True)
    return r


def phase_hw_dropout_parity(dev, errs):
    """The hardware-RNG dropout kernel against its plain version, bitwise:
    the GPT2 path's (64, 256, 768) at rates 0.1 and 0.5, the mc head's
    (64, 768), a (300, 1024) view whose second logical block is partial,
    and bfloat16; each run twice, bitwise equal. Then the reference's
    on-device contract at (512, 1024), rate 0.1: keep fraction within
    5e-3 of 0.9, kept values exactly f32(1/0.9), the gradient of the sum
    equal to the output, a second seed differing in over 10%."""
    import torch

    from commefficient_tpu_torch.ops.dropout import (fold_in, hw_dropout,
                                                     hw_dropout_plain,
                                                     seed_words)
    cases = [(HW_SHAPE, torch.float32, HW_RATE),
             (HW_SHAPE, torch.float32, 0.5),
             ((64, 768), torch.float32, HW_RATE),
             ((300, 1024), torch.float32, HW_RATE),
             ((16, 256, 768), torch.bfloat16, HW_RATE)]
    gen = torch.Generator(device=dev).manual_seed(8)
    errs["hw_dropout"] = 0.0
    for i, (shape, dtype, rate) in enumerate(cases):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        seeds = seed_words(fold_in(8, i))
        got = hw_dropout(x, seeds, rate)
        again = hw_dropout(x, seeds, rate)
        plain = hw_dropout_plain(x, seeds, rate)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), again.view(bits)):
            raise AssertionError(f"hw_dropout differs between two runs "
                                 f"({shape}, {dtype}, rate {rate})")
        if got.dtype != dtype or not torch.equal(got.view(bits),
                                                 plain.view(bits)):
            raise AssertionError(f"hw_dropout != plain ({shape}, {dtype}, "
                                 f"rate {rate}), max abs err "
                                 f"{_max_abs_err(got, plain)}")
        errs["hw_dropout"] = max(errs["hw_dropout"], _max_abs_err(got, plain))
        print(f"parity hw_dropout ({tuple(shape)}, {dtype}, rate {rate}): "
              f"bitwise equal to plain, deterministic over 2 runs, keep "
              f"fraction {float((got != 0).double().mean()):.6f}",
              flush=True)
        del x, got, again, plain

    ones = torch.ones((512, 1024), device=dev, requires_grad=True)
    y = hw_dropout(ones, seed_words(7), HW_RATE)
    (g,) = torch.autograd.grad(y.sum(), ones)
    y = y.detach()
    keep = float((y != 0).double().mean())
    scale = float(np.float32(1.0 / (1.0 - HW_RATE)))
    kept = y[y != 0]
    differ = float((hw_dropout(ones.detach(), seed_words(8), HW_RATE)
                    != y).double().mean())
    exact = torch.equal(kept, torch.full_like(kept, scale))
    same_mask = torch.equal(g, y)
    if abs(keep - (1.0 - HW_RATE)) >= 5e-3 or not exact or not same_mask \
            or differ <= 0.1:
        raise AssertionError(f"hw_dropout contract: keep {keep}, scaling "
                             f"exact {exact}, grad = output {same_mask}, "
                             f"second seed differs in {differ}")
    print(f"contract hw_dropout ((512, 1024), rate {HW_RATE}): keep "
          f"fraction {keep:.6f}, kept values exactly {scale!r}, backward "
          f"mask = forward mask, a second seed differs in {differ:.4f}",
          flush=True)


def phase_hw_dropout_timing(dev):
    """Times of the hardware-RNG dropout at the GPT2 path's activation
    shape beside its plain version, ``torch.nn.functional.dropout`` (the
    library row) and the bound; the mc head's shape printed apart."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops.dropout import (hw_dropout,
                                                     hw_dropout_plain,
                                                     seed_words)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(HW_SHAPE, generator=gen, device=dev)
    seeds = seed_words(1234)
    at = f"{HW_SHAPE}, f32, rate {HW_RATE}"
    r = dict(ms=_time_ms(lambda: hw_dropout(x, seeds, HW_RATE)),
             plain_ms=_time_ms(lambda: hw_dropout_plain(x, seeds, HW_RATE)),
             library_ms=_time_ms(lambda: F.dropout(x, HW_RATE,
                                                   training=True)),
             cost=_hw_dropout_cost(x.numel()), at=at)
    mc = x[:, 0].contiguous()
    mc_ms = _time_ms(lambda: hw_dropout(mc, seeds, HW_RATE))
    bound_ms, kind = r["cost"]
    print(f"time hw_dropout ({at}): kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({kind}); at the mc head's {tuple(mc.shape)} "
          f"{mc_ms:.4f} ms", flush=True)
    print("  library: hw_dropout = torch.nn.functional.dropout(x, "
          f"{HW_RATE}, training=True) at the same shape (its own bits)",
          flush=True)
    return r


def phase_path(name):
    """One main path: 3 full-width rounds through ``training.cv.train``
    with every launch counter zeroed just before and read just after."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    flags, want, per_client = PATHS[name]
    args = build_parser().parse_args(flags)
    np.random.seed(args.seed)
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, max_rounds=3, log=False)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    rounds = row["rounds"]
    if len(rounds) != 3:
        raise AssertionError(f"{name}: ran {len(rounds)} rounds, expected 3")
    w = learner.state.weights
    if learner.cfg.grad_size != D_RESNET9 or w.shape != (D_RESNET9,):
        raise AssertionError(f"{name}: d = {learner.cfg.grad_size}")
    if not all(math.isfinite(r["loss"]) for r in rounds) \
            or not bool(torch.isfinite(w).all()) \
            or not math.isfinite(row["test_loss"]):
        raise AssertionError(f"{name}: non-finite loss or weights")
    # the first round has all 8 workers (the epoch tail may have fewer)
    if rounds[0]["upload_bytes"] != 8 * per_client or any(
            r["upload_bytes"] % per_client for r in rounds):
        raise AssertionError(f"{name}: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]} are "
                             f"not {per_client} per client")
    changed = int((learner.state.last_changed >= 0).sum())
    print(f"path {name}: launches {launches}, losses "
          f"{[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, upload B "
          f"{[int(r['upload_bytes']) for r in rounds]}, test_loss "
          f"{row['test_loss']:.6f}, {changed} weights changed", flush=True)
    del learner, row
    torch.cuda.empty_cache()
    return launches


REFERENCE_CONFIGS = {
    "sketch": dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                   num_cols=2000, num_rows=5),
    "true_topk": dict(mode="true_topk", error_type="virtual",
                      virtual_momentum=0.9),
    "local_topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9),
    # the per-worker sketch, its batched kernel on the card (DP noise 0:
    # the two devices' generators draw different normals)
    "sketch_clip": dict(mode="sketch", error_type="virtual",
                        virtual_momentum=0.9, num_cols=2000, num_rows=5,
                        max_grad_norm=1.0),
    "sketch_dp": dict(mode="sketch", error_type="virtual",
                      virtual_momentum=0.9, num_cols=2000, num_rows=5,
                      do_dp=True, l2_norm_clip=1.0, noise_multiplier=0.0),
}


def phase_reference(dev):
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
    rng = np.random.RandomState(1)
    batches = [(rng.choice(10, 4, replace=False).astype(np.int32),
                (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (4, 8)).astype(np.int32)),
                np.ones((4, 8), np.float32)) for _ in range(2)]
    for mode, kw in REFERENCE_CONFIGS.items():
        cfg = FedConfig(k=200, num_clients=10, num_workers=4, **kw)
        outs = {}
        for device in ("cpu", dev):
            model = ResNet9(channels=ch).reset_parameters(
                torch.Generator().manual_seed(0))
            loss = make_cv_loss(model)
            learner = FedLearner(model, cfg, loss, loss, device=device)
            ms = [learner.train_round(ids, cols, m, epoch_frac=1.0)
                  for ids, cols, m in batches]
            outs[str(device)] = (ms, learner.state.weights.cpu())
        (m_cpu, w_cpu), (m_gpu, w_gpu) = outs["cpu"], outs[str(dev)]
        for a, b in zip(m_cpu, m_gpu):
            if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
                raise AssertionError(f"{mode}: loss cpu {a['loss']} != "
                                     f"cuda {b['loss']}")
            if (a["download_bytes"], a["upload_bytes"]) != (
                    b["download_bytes"], b["upload_bytes"]):
                raise AssertionError(f"{mode}: byte metrics differ between "
                                     "cpu and cuda")
        close = torch.isclose(w_gpu, w_cpu, rtol=1e-3, atol=1e-5)
        frac = float(close.float().mean())
        if frac < 0.99:
            raise AssertionError(f"{mode}: only {frac:.4f} of weights agree")
        print(f"reference {mode} (narrow ResNet9, 2 rounds, cuda vs cpu "
              f"plain): losses {[round(m['loss'], 6) for m in m_gpu]} vs "
              f"{[round(m['loss'], 6) for m in m_cpu]}, bytes equal, "
              f"{frac:.6f} of weights within rtol 1e-3", flush=True)


def _flash_inputs(dev, bh, t, d, dtype, seed):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(bh, t, d, generator=gen, device=dev).to(dtype)
                 for _ in range(4))


def _flash_args(d, rate):
    from commefficient_tpu_torch.ops import flash_attention as fa
    return ((1234567, -7654321), d ** -0.5, fa.DEFAULT_BLOCK_Q,
            fa.DEFAULT_BLOCK_K, rate)


def _flash_run(q, k, v, g, args):
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    o, lse = fa.flash_fwd(q, k, v, *args)
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, *args)
    return o, lse, dq, dk, dv


def _flash_check(dev, bh, t, d, dtype, rate, seed):
    """Kernels twice (bitwise equal) and against the plain versions:
    ``({name: max abs err}, {name: err relative to max |plain|})``."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(dev, bh, t, d, dtype, seed)
    args = _flash_args(d, rate)
    got = _flash_run(q, k, v, g, args)
    again = _flash_run(q, k, v, g, args)
    torch.cuda.synchronize()
    names = ("o", "lse", "dq", "dk", "dv")
    for name, a, b in zip(names, got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"flash kernels are not deterministic: {name}"
                                 f" differs between two runs ({bh}, {t}, {d},"
                                 f" {dtype}, rate {rate})")
    ref = fa.flash_fwd_plain(q, k, v, *args) + fa.flash_bwd_plain(
        q, k, v, g, *args)
    err = {n: _max_abs_err(a, b) for n, a, b in zip(names, got, ref)}
    rel = {n: err[n] / max(float(b.double().abs().max()), 1e-30)
           for n, b in zip(names, ref)}
    return err, rel


def phase_flash_parity(dev, errs):
    import torch
    bh, t, d = FLASH_SHAPE
    cases = [("f32", bh, t, d, torch.float32, 0.0),
             ("f32", bh, t, d, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_CLIENT, torch.float32, FLASH_RATE),
             ("bf16", bh, t, d, torch.bfloat16, FLASH_RATE),
             ("f32", 24, 1100, 128, torch.float32, FLASH_RATE)]
    errs.update(flash_fwd=0.0, flash_bwd_dq=0.0, flash_bwd_dkv=0.0)
    for i, (tag, bh_, t_, d_, dtype, rate) in enumerate(cases):
        err, rel = _flash_check(dev, bh_, t_, d_, dtype, rate, seed=i)
        print(f"parity flash ({tag}, BH={bh_}, T={t_}, D={d_}, rate "
              f"{rate}): bitwise equal over 2 runs; max abs err O "
              f"{err['o']:.3e}, lse {err['lse']:.3e}; relative to max |.|: "
              f"dq {rel['dq']:.3e}, dk {rel['dk']:.3e}, dv {rel['dv']:.3e}",
              flush=True)
        if dtype == torch.float32:
            bad = [n for n in ("o", "lse") if err[n] > 1e-5] + [
                n for n in ("dq", "dk", "dv") if rel[n] > 1e-4]
            if (t_, d_) == (t, d):
                errs["flash_fwd"] = max(errs["flash_fwd"], err["o"])
                errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], err["dq"])
                errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"],
                                            err["dk"], err["dv"])
        else:
            bad = [n for n in ("o",) if err[n] > 2e-2]
        if bad:
            raise AssertionError(f"flash kernels disagree with the plain "
                                 f"versions ({tag}, T={t_}, D={d_}, rate "
                                 f"{rate}) in {bad}: {err} / {rel}")


def _flash_cost(kind, bh, t, d):
    """(ms, kind) of the least time for one kernel at (bh, t, d) float32:
    each input read once and each output written once; the causal
    products' flops (forward 2 T^2 D BH, dq 1.5x, dkv 2x)."""
    tensor, row = 4 * bh * t * d, 4 * bh * t
    flops = 2 * t * t * d * bh
    if kind == "fwd":       # q, k, v -> O, lse
        return _bound(4 * tensor + row, flops)
    if kind == "dq":        # q, k, v, dO, lse, delta -> dq
        return _bound(5 * tensor + 2 * row, 1.5 * flops)
    return _bound(6 * tensor + 2 * row, 2 * flops)  # ... -> dk, dv


def phase_flash_timing(dev):
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops import flash_attention as fa
    bh, t, d = FLASH_SHAPE
    q, k, v, g = _flash_inputs(dev, bh, t, d, torch.float32, 0)
    args = _flash_args(d, FLASH_RATE)
    o, lse = fa.flash_fwd(q, k, v, *args)
    delta = torch.sum(g * o, dim=-1)
    # the same attention as one library call, (B, H, T, D) views of the
    # (BH, T, D) tensors; its backward through autograd
    q4, k4, v4, g4 = (x.view(bh // 12, 12, t, d) for x in (q, k, v, g))
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, dropout_p=FLASH_RATE)
    lib_fwd = _time_ms(lambda: sdpa(q4, k4, v4))
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
    out = sdpa(*leaves)
    lib_bwd = _time_ms(lambda: torch.autograd.grad(out, leaves, g4,
                                                   retain_graph=True))
    plain_bwd = _time_ms(lambda: fa.flash_bwd_plain(q, k, v, g, *args))
    at = f"BH={bh}, T={t}, D={d}, f32, rate {FLASH_RATE}"
    rows = {
        "flash_fwd": dict(
            ms=_time_ms(lambda: fa.flash_fwd(q, k, v, *args)),
            plain_ms=_time_ms(lambda: fa.flash_fwd_plain(q, k, v, *args)),
            library_ms=lib_fwd, cost=_flash_cost("fwd", bh, t, d), at=at),
        "flash_bwd_dq": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta,
                                                *args)),
            plain_ms=plain_bwd, library_ms=lib_bwd,
            cost=_flash_cost("dq", bh, t, d), at=at),
        "flash_bwd_dkv": dict(
            ms=_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                 *args)),
            plain_ms=plain_bwd, library_ms=lib_bwd,
            cost=_flash_cost("dkv", bh, t, d), at=at),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} ({at}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({kind})", flush=True)
    print("  library: flash_fwd = scaled_dot_product_attention(is_causal, "
          f"dropout_p={FLASH_RATE}) forward; flash_bwd_dq, flash_bwd_dkv = "
          "its whole autograd backward (dq, dk, dv together); plain ms of "
          "both backward rows = the plain forward's autograd (dq, dk, dv "
          "together)", flush=True)
    return rows


# kernel classes of the round's device-time breakdown, by name substring
_KERNEL_CLASSES = (
    ("flash attention (B5-B7)", ("fwd_kernel", "dq_kernel", "dkv_kernel")),
    ("hardware-RNG dropout (B8)", ("hw_dropout_kernel",)),
    ("sketch and top-k (B1-B3)", ("sketch_kernel", "count_kernel",
                                  "select_kernel", "tie_count_kernel",
                                  "exclusive_scan_kernel")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
)


def _kernel_class(name: str) -> str:
    for label, keys in _KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def _profile_round(name, learner, call):
    """One more round (round 3's batch again) under ``torch.profiler``:
    device time by kernel class and the top kernels, beside the round's
    wall time. Prints the breakdown; checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ids, batch, mask = call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train_round(ids, batch, mask)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print(f"profile {name} round: the profiler recorded no device time",
              flush=True)
        return
    by_class = {}
    for e in kernels:
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    print(f"profile {name} round (torch.profiler, one round): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; by class: " + ", ".join(
              f"{c} {ms:.3f} ms ({ms / busy_ms:.4f})"
              for c, ms in sorted(by_class.items(), key=lambda x: -x[1])),
          flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{_kernel_class(e.key)}: {e.key[:90]}", flush=True)
    torch.cuda.synchronize()


def phase_gpt2_path(tmpdir, name, profile=False):
    """3 rounds of a GPT2 path; launches of the rounds and of the
    validation pass read apart; then, with ``profile``, one more round
    under the profiler."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    extra, namespace, want = GPT2_PATHS[name]
    args = build_gpt2_parser().parse_args(GPT2_FLAGS + extra + [
        "--dataset_dir", tmpdir])
    for key, value in namespace.items():
        setattr(args, key, value)
    np.random.seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, max_rounds=3, log=False)
    torch.cuda.synchronize()
    launches = row["launches_after_rounds"]
    val = {k: v - launches.get(k, 0) for k, v in cuda_lib.LAUNCHES.items()
           if v - launches.get(k, 0)}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    n_layer = learner.model.config.n_layer
    if val != {"flash_fwd": n_layer * row["val_batches"]}:
        raise AssertionError(f"{name}: validation launches {val} over "
                             f"{row['val_batches']} batches, expected "
                             f"flash_fwd {n_layer} a batch")
    rounds = row["rounds"]
    w = learner.state.weights
    if len(rounds) != 3 or learner.cfg.grad_size != D_GPT2 \
            or w.shape != (D_GPT2,):
        raise AssertionError(f"{name}: {len(rounds)} rounds, d = "
                             f"{learner.cfg.grad_size}")
    if not all(math.isfinite(r["loss"]) for r in rounds) \
            or not bool(torch.isfinite(w).all()) \
            or not math.isfinite(row["nll"]):
        raise AssertionError(f"{name}: non-finite loss, weights or val nll")
    if any(r["upload_bytes"] != GPT2_WORKERS * 4 * TABLE_FLOATS
           for r in rounds):
        raise AssertionError(f"{name}: upload bytes "
                             f"{[r['upload_bytes'] for r in rounds]} are "
                             f"not {4 * TABLE_FLOATS} per client x "
                             f"{GPT2_WORKERS}")
    print(f"path {name}: d = {learner.cfg.grad_size}, launches {launches}, "
          f"validation launches {val} over {row['val_batches']} batches, "
          f"losses {[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, upload B "
          f"{[int(r['upload_bytes']) for r in rounds]}, val nll "
          f"{row['nll']:.6f}, mc_acc {row['mc_acc']:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if profile:
        _profile_round(name, learner, row["last_batch"])
    del learner, row
    torch.cuda.empty_cache()
    return launches


# name: (GPT2Config attributes, launches of the card's 2 rounds). With
# tpu_bits the attention dropout goes on the attention output on both
# sides ("output"): under "auto" the card would drop the probabilities in
# the flash kernels and the CPU the output. 8 sites a forward (embedding,
# 2 x (attention output, projection, MLP), mc head), 8 in the backward.
GPT2_REFERENCE_CASES = {
    "dropout 0": (dict(dropout=0.0), {"flash_fwd": 4}),
    "tpu_bits, dropout 0.1": (dict(dropout=0.1, dropout_impl="tpu_bits",
                                   attn_dropout="output"),
                              {"flash_fwd": 4, "hw_dropout": 32}),
}


def phase_gpt2_reference(dev):
    """Two sketch rounds of a narrow GPT2 learner with the flash kernels
    (and with tpu_bits the hardware-RNG dropout kernel) on the card and
    the plain versions on the CPU, from the same weights, batches and
    seeds, per case of ``GPT2_REFERENCE_CASES``."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import (
        make_gpt2_train_loss, make_gpt2_val_loss)
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.ops import cuda_lib
    W, B, C, T = 4, 2, 2, 64
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        ids = rng.randint(0, 261, (W, B, C, T)).astype(np.int32)
        cols = (ids, rng.randint(T // 2, T, (W, B, C)).astype(np.int32),
                np.where(rng.rand(W, B, C, T) < 0.3, ids, -1).astype(
                    np.int32), np.full((W, B), C - 1, np.int32),
                rng.randint(256, 261, (W, B, C, T)).astype(np.int32))
        batches.append((rng.choice(8, W, replace=False).astype(np.int32),
                        cols, np.ones((W, B), np.float32)))
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=500, num_cols=4000, num_rows=5,
                    num_clients=8, num_workers=W, weight_decay=0.0)
    for case, (attrs, want) in GPT2_REFERENCE_CASES.items():
        outs = {}
        for device in ("cpu", dev):
            gcfg = GPT2Config(vocab_size=300, n_positions=T, n_embd=64,
                              n_layer=2, n_head=4, attn_impl="blockwise")
            for key, value in attrs.items():
                setattr(gcfg, key, value)
            model = GPT2DoubleHeads(gcfg).reset_parameters(
                torch.Generator().manual_seed(0))
            learner = FedLearner(model, cfg, make_gpt2_train_loss(model),
                                 make_gpt2_val_loss(model), device=device)
            before = dict(cuda_lib.LAUNCHES)
            ms = [learner.train_round(ids, cols, m, epoch_frac=r)
                  for r, (ids, cols, m) in enumerate(batches)]
            outs[str(device)] = (ms, {
                k: cuda_lib.LAUNCHES[k] - before.get(k, 0) for k in want})
        (m_cpu, n_cpu), (m_gpu, n_gpu) = outs["cpu"], outs[str(dev)]
        if any(n_cpu.values()) or n_gpu != want:
            raise AssertionError(f"gpt2 reference ({case}): launches "
                                 f"{n_cpu} on the CPU, {n_gpu} on the card, "
                                 f"expected none and {want}")
        for a, b in zip(m_cpu, m_gpu):
            if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
                raise AssertionError(f"gpt2 reference ({case}): loss cpu "
                                     f"{a['loss']} != cuda {b['loss']}")
            if (a["download_bytes"], a["upload_bytes"]) != (
                    b["download_bytes"], b["upload_bytes"]):
                raise AssertionError(f"gpt2 reference ({case}): byte "
                                     "metrics differ")
        print(f"reference gpt2 ({case}; 2 layers, n_embd 64, T {T}, 2 "
              f"sketch rounds, cuda kernels {n_gpu} vs cpu): losses "
              f"{[round(m['loss'], 6) for m in m_gpu]} vs "
              f"{[round(m['loss'], 6) for m in m_cpu]}, bytes equal",
              flush=True)


SOURCES = {
    "sketch": ("commefficient_tpu_torch/csrc/sketch.cu",
               "commefficient_tpu/ops/sketch_kernels.py:285"),
    "count": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
              "commefficient_tpu/ops/topk_kernels.py:200"),
    "select": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
               "commefficient_tpu/ops/topk_kernels.py:355"),
    "count_plain": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                    "commefficient_tpu/ops/topk_kernels.py:200"),
    "select_plain": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "select_resid": ("commefficient_tpu_torch/csrc/topk_stream.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "estimates": ("commefficient_tpu_torch/csrc/estimates.cu",
                  "commefficient_tpu/ops/sketch_kernels.py:183"),
    "flash_fwd": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                  "commefficient_tpu/ops/flash_attention.py:183"),
    "flash_bwd_dq": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                     "commefficient_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                      "commefficient_tpu/ops/flash_attention.py:356"),
    "sketch_batched": ("commefficient_tpu_torch/csrc/sketch.cu",
                       "commefficient_tpu/ops/sketch_kernels.py:285 "
                       "(batched grid :381)"),
    "estimates_batched": ("commefficient_tpu_torch/csrc/estimates.cu",
                          "commefficient_tpu/ops/sketch_kernels.py:183 "
                          "(batched grid :248)"),
    "hw_dropout": ("commefficient_tpu_torch/csrc/hw_dropout.cu",
                   "commefficient_tpu/ops/dropout.py:121"),
}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    try:
        import commefficient_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = _smi()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    errs = {}
    cs, vec, table = phase_parity(dev, D_RESNET9, errs)
    inputs = phase_parity_stream(dev, cs, table, errs)
    times = phase_timing(cs, vec, table)
    times.update(phase_timing_stream(cs, table, inputs))
    tables = phase_parity_estimates_batched(dev, cs, table, errs)
    times["estimates_batched"] = phase_timing_estimates_batched(cs, table,
                                                                tables)
    del vec, table, inputs, tables
    cs, vecs = phase_parity_batched(dev, D_RESNET9, 8, errs)
    times["sketch_batched"] = phase_timing_batched(cs, vecs)
    del cs, vecs
    torch.cuda.empty_cache()
    launches = {}
    for name in PATHS:
        for kernel, n in phase_path(name).items():
            launches[kernel] = launches.get(kernel, 0) + n
    phase_reference(dev)
    phase_flash_parity(dev, errs)
    times.update(phase_flash_timing(dev))
    phase_hw_dropout_parity(dev, errs)
    times["hw_dropout"] = phase_hw_dropout_timing(dev)
    # the sketch-mode kernels again at the GPT2 path's d (timed apart: the
    # kernel line keeps ResNet9's d)
    cs, vec, table = phase_parity(dev, D_GPT2, errs)
    phase_timing(cs, vec, table, plain_reps=3)
    del cs, vec, table
    cs, vecs = phase_parity_batched(dev, D_GPT2, GPT2_WORKERS, errs)
    phase_timing_batched(cs, vecs, plain_reps=3)
    del cs, vecs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in GPT2_PATHS:
            for kernel, n in phase_gpt2_path(tmpdir, name,
                                             profile=True).items():
                launches[kernel] = launches.get(kernel, 0) + n
    phase_gpt2_reference(dev)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = times[name]
        bound_ms, kind = r["cost"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": kind, "library_ms": r["library_ms"],
            "at": r.get("at", f"d={D_RESNET9}")})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
