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
     at k=50,000, and a table with planted ties; the first port's count
     and select kernels (on no path: the radix below replaced them)
     against theirs;
   - the first port's plain count and select (on no path now) on
     an (8, 6,568,640) batch with per-row k of 50,000 / 25,000 / 1,
     planted ties across tiles and an all-zero row; its resid select on
     (err, v) at d with planted ties and with selected +-0.0; the
     estimates of the sketched table, which must also equal the fused
     selection's masked values where its mask is set;
   - the batched estimates of 8 tables (the sketched one, an all-zero one,
     seeded normals) at B = 8, 3 and 1, every table bitwise equal to the
     unbatched kernel and to the plain version, and the same over two
     runs;
   - the estimate-once histogram radix (est_hist, two digit_hist passes,
     the dense and the compact select) on the sketched table, planted
     ties, an all-zero table and one with +-0.0 and NaN cells: the stored
     estimates, each digit histogram, t and n_take (also against the count
     kernels' radix), the dense and compact outputs bitwise equal to the
     plain versions, and the same over two runs;
   - the per-row histogram radix of the dense streams (rows_hist x 3,
     then rows_select or rows_resid) on an (8, 6,568,640) batch with
     per-row k ``KK_RADIX`` (a k = 0 row; random, all-zero, planted-tie
     and NaN-bearing rows) and at B = 1 on true_topk's (err, v) with
     planted ties and with selected +-0.0: each pass's per-row histograms,
     t, n_take and the outputs bitwise equal to the plain versions, and
     the entry points' second runs equal to the first;
   - one sketch-mode server step with --server_fused auto against off:
     update, Vvelocity and Verror bitwise equal; then 10 alternating pairs
     of the two steps, timed;
   - the sparse re-sketch of the k survivors, three planted in one bucket
     as 1e8, 1, -1e8: the card's table bitwise the CPU's, over two runs;
   - the batched sketch on an (8, 6,568,640) batch (an all-zero row and a
     row of planted heavy coordinates among seeded ones) and on an offset
     slice of it, row by row bitwise equal to its plain version and to the
     unbatched kernel, and the same over two runs;
3. kernel times with CUDA events (median of 25), beside the plain
   versions, one PyTorch library call for the same work where there is
   one, and the bound computed from this run's bytes and operations; the
   whole recovery (new compact, new dense, old count x 9 + select) as 20
   alternating rounds, beside ``torch.topk`` of the squared estimates and
   ``estimates_batched`` + ``torch.topk``; the per-row radix's passes and
   selects, and its whole top-k at B = 8 and B = 1 against the first
   port's route (nibble glue, count_plain x 9, the select) and
   ``torch.topk`` of the squares, as 20 alternating rounds;
4. the main paths, each ``training.cv.train(args, max_rounds=3)`` at
   ResNet9's full width (d = 6,568,640) on Synthetic with 8 workers and
   k=50,000, every launch counter set to 0 just before it and read just
   after:
   - sketch (the headline FetchSGD flags, 5 x 500k, virtual error and
     momentum 0.9, 32 images a worker): sketch 3 and the recovery's
     kernels: est_hist 3, digit_hist 6, radix_compact 3, segment_sum 3;
   - true_topk (virtual error, momentum 0.9): rows_hist 9, rows_resid 3;
   - local_topk (local error and momentum 0.9, 100 clients): rows_hist 9
     (8 rows a launch), rows_select 3;
   - sketch with --server_fused off: sketch 3, estimates_batched 3 (the
     reference's off branch runs the batched grid at B = 1), segment_sum
     3;
   - uncompressed (momentum 0.9) and fedavg (2 local epochs in chunks of
     16, lr decay 0.9): no kernel;
   - sketch_clip (the sketch flags + --max_grad_norm 1.0) and sketch_dp
     (+ --dp --dp_mode worker --l2_norm_clip 1.0 --noise_multiplier 1e-3):
     the per-worker sketch, sketch_batched 3 (the 8 clients' tables in one
     launch a round), the recovery's kernels, and no unbatched sketch;
   - uncompressed_dp_server (+ --dp --dp_mode server, the same clip and
     noise): no kernel;
   with finite losses and weights and exact upload bytes per client;
   then the sketch path twice more from the same seed: per-round losses,
   weights, Vvelocity and Verror bitwise equal; and one ResNet9 forward
   and backward at its batch timed with cuDNN's deterministic mode off,
   then on;
5. a reference check on a small input: two rounds of a narrow ResNet9
   learner on CUDA (kernels) and on the CPU (plain versions) from the same
   weights and batches must agree, in sketch, true_topk and local_topk,
   and in sketch with --max_grad_norm and with DP (noise 0);
6. the flash attention kernels (the tensor-core forward, dq and dk/dv,
   and the first port's scalar ones, on no path) against
   their plain versions and each other at the GPT2 path's shape (BH 768
   = 64 sequences x 12 heads, T 256, D 64): float32 at dropout 0 and 0.1
   (O within 1e-5, dq/dk/dv within 1e-4 of their largest magnitude),
   float32 at dropout 0.1 at the gpt2_clip path's per-client shape (BH
   192 = 16 sequences x 12 heads; the same limits), bfloat16 (O within
   2e-2), and T 1100, D 128 at dropout 0.1 (three logical dropout tiles,
   a ragged end); every kernel run twice, bitwise equal; then the
   tensor-core forward, dq and dk/dv, the scalar ones, the port's whole
   backward (delta, dq, dk/dv) and ``scaled_dot_product_attention``'s
   forward and autograd backward as 20 alternating rounds, the plain
   versions beside them, each kernel with two bounds (3xTF32 on the
   tensor cores, float32 on the CUDA cores);
   then the checks of phase 2's first item, the radix parity and the
   server A/B, and the kernel and recovery times of phase 3 for sketch,
   count, select and the radix again at the GPT2 path's d = 124,051,201
   (a seeded vector into the same 5 x 500,096 table, k = 50,000; plain
   versions timed over 3 runs), and the batched sketch's check and times
   at that d with B = 4; the B = 1 resid top-k at that d (parity, passes,
   20 alternating rounds against the old route and ``torch.topk``); then
   the hardware-RNG dropout kernel against its
   plain version, bitwise: the GPT2 path's (64, 256, 768) float32 at rates
   0.1 and 0.5, the mc head's (64, 768), a (300, 1024) view with a partial
   logical block and a bfloat16 case, each twice; the reference's contract
   at (512, 1024), rate 0.1 (keep fraction within 5e-3 of 0.9, kept values
   exactly f32(1/0.9), the gradient of the sum equal to the output, a
   second seed differing in over 10%); its call against
   ``torch.nn.functional.dropout``'s as 20 alternating rounds at (64,
   256, 768) and at the mc head's (64, 768), each one's device time
   alone (200 launches back to back between one pair of events), the
   plain version and the bound;
7. the GPT2 path: ``training.gpt2.train(args, max_rounds=3)`` with the
   flags of ``examples/gpt2_personachat.sh`` on SyntheticPersona at
   GPT2-small's width (d = 124,051,201, ``--attn_impl blockwise``,
   sketch 5 x 500k, k = 50,000, 4 workers of 8 dialogs x 2 candidates x
   256 tokens): counters zeroed just before the rounds and read when the
   validation pass starts (flash_fwd, flash_bwd_dq, flash_bwd_dkv 36
   each, sketch 3 and the recovery's kernels), the validation pass's launches
   read apart (flash_fwd 12 per batch, nothing else); finite losses,
   weights and validation nll, exact upload bytes; round ms printed;
   then round 3's batch once more under ``torch.profiler``, its device
   time printed by kernel class beside its wall time; then the same with
   --max_grad_norm 1.0 (gpt2_clip): the per-worker path, one forward and
   backward per client, so flash_fwd, flash_bwd_dq, flash_bwd_dkv 144 each
   (12 layers x 4 clients x 3 rounds), sketch_batched 3, the recovery's
   kernels, and no unbatched sketch; its round 3 profiled in the same way; then
   gpt2_tpu_bits, the gpt2 flags with ``args.dropout_impl = "tpu_bits"``
   set on the parsed namespace (no CLI value selects it, as in the
   reference): gpt2's launches and hw_dropout 156 (26 sites a forward, 26
   a backward, 3 rounds), none in validation; profiled in the same way;
   then the gpt2 path twice more from the same seed (ROADMAP C5b), the
   first run freed before the second: per-round losses, weights,
   Vvelocity and Verror bitwise equal;
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
import re
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
# the sketch server's recovery over 3 rounds: the estimate-once histogram
# radix (one est_hist and two digit_hist passes, the compact select) and
# the deterministic segmented sum of the survivors' re-sketch
RECOVERY = {"est_hist": 3, "digit_hist": 6, "radix_compact": 3,
            "segment_sum": 3}
# name: (flags, launches over 3 rounds, upload bytes per client)
PATHS = {
    "sketch": (HEADLINE, dict(RECOVERY, sketch=3), 4 * TABLE_FLOATS),
    "true_topk": (_BASE + ["--mode", "true_topk", "--error_type", "virtual",
                           "--virtual_momentum", "0.9",
                           "--local_batch_size", "32"],
                  {"rows_hist": 9, "rows_resid": 3}, 4 * D_RESNET9),
    "local_topk": (_BASE + ["--mode", "local_topk", "--error_type", "local",
                            "--local_momentum", "0.9", "--num_clients",
                            "100", "--local_batch_size", "32"],
                   {"rows_hist": 9, "rows_select": 3}, 4 * K),
    # the reference's off branch runs the batched estimates grid at B = 1
    "sketch_server_fused_off": (HEADLINE + ["--server_fused", "off"],
                                {"sketch": 3, "estimates_batched": 3,
                                 "segment_sum": 3}, 4 * TABLE_FLOATS),
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
PER_WORKER_SKETCH = dict(RECOVERY, sketch_batched=3)
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
# per-row k of the per-row radix's check: KK_ROWS' values and a k = 0 row
KK_RADIX = [K, K, K // 2, 1, 0, K, K, K]
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
GPT2_SKETCH = dict(RECOVERY, flash_fwd=36, flash_bwd_dq=36,
                   flash_bwd_dkv=36, sketch=3)
GPT2_PATHS = {
    "gpt2": ([], {}, GPT2_SKETCH),
    "gpt2_clip": (["--max_grad_norm", "1.0"], {},
                  dict(RECOVERY, flash_fwd=144, flash_bwd_dq=144,
                       flash_bwd_dkv=144, sketch_batched=3)),
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
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor-core peak, dense
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


def _time_ms(fn, reps=REPS, setup=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warmup;
    ``setup()`` runs before each call, outside the timed events."""
    import torch
    for _ in range(3):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
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
    table written once; the hashing once (the least the function needs:
    the rows of a batch could share it) plus one add per (batch row, row,
    coordinate)."""
    nbytes = B * (4 * cs.d + 4 * cs.r * cs.c_eff)
    ops = (cs.r * cs.d * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
           + B * cs.r * cs.d)
    return _bound(nbytes, ops)


def _sketch_design(cs, B=1):
    """(bytes, ms at the HBM rate) the kernel itself moves from device
    memory for B rows at most: x r times a row (each row's warps sweep it;
    fewer where the L2 keeps it between sweeps), the r packed window lists
    and the table once a row."""
    nbytes = B * (4 * cs.r * cs.d + 4 * cs.r * cs.nblocks
                  + 4 * cs.r * cs.c_eff)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _device_ms(fn, setup=None, n=20) -> float:
    """Device time of one ``fn()``: ``n`` calls back to back between one
    pair of CUDA events, over ``n``; with ``setup`` (a workspace restore)
    before each call, less the time of ``n`` setups alone."""
    if setup is None:
        return _back_to_back_ms(fn, n)

    def both():
        setup()
        fn()
    return _back_to_back_ms(both, n) - _back_to_back_ms(setup, n)


def _estimate_ops(cs):
    return (cs.d * (cs.r * (_OPS_SIGN + 3) + _OPS_MEDIAN[cs.r] + 1)
            + cs.r * cs.nblocks * _OPS_BLOCK)


def _count_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 4 * 16 + 4 * 16
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 32)


def _select_cost(cs):
    nbytes = 4 * cs.r * cs.c_eff + 8 + 4 * cs.d + 4 * cs.d
    return _bound(nbytes, _estimate_ops(cs) + cs.d * 4)


# operations a coordinate of the histogram radix, besides the estimate:
# the square, the key's clamp, the prefix test, the digit's shift and mask,
# and the warp-aggregated histogram add
_OPS_RADIX = 6


def _est_hist_cost(cs):
    """The table read and the (d,) estimates written once (plus the first
    digit's 2,048 counters); the estimates' operations and the first
    digit's."""
    return _bound(4 * cs.r * cs.c_eff + 4 * cs.d + 4 * 2048,
                  _estimate_ops(cs) + _OPS_RADIX * cs.d)


def _digit_hist_cost(cs):
    """One digit pass: the stored estimates read once."""
    return _bound(4 * cs.d + 4 * 2048, _OPS_RADIX * cs.d)


def _radix_select_cost(cs, dense):
    """The stored estimates read once; dense: the masked estimates and the
    int32 mask written, else the k values and int64 indices."""
    out = 8 * cs.d if dense else 12 * K
    return _bound(4 * cs.d + out, _OPS_RADIX * cs.d)


def _radix_design_bytes(cs, dense):
    """The bytes the design itself moves in one recovery: the table, the
    scratch written once and read by both digit passes and twice by the
    select (its counts, then the select pass), and the outputs."""
    out = 8 * cs.d if dense else 12 * K
    return 4 * cs.r * cs.c_eff + 5 * 4 * cs.d + out


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
            kernel = "?"
            for line in log.read_text().splitlines():
                if "Function properties for" in line:
                    kernel = _demangle(line.split(" for ", 1)[1].strip())
                elif "registers" in line or "spill" in line:
                    print(f"  ptxas {name} {kernel}: {line.strip()}")


def _demangle(symbol: str) -> str:
    """A kernel's symbol as ``name<template arguments>`` where the machine
    has ``c++filt``, else as it is."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", out)
    return m.group(1) if m else (out or symbol)


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
    """The plain count and select (B = 8, per-row k), the resid select and
    the estimates."""
    import torch

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
    return inputs


def phase_server_ab(dev, cs, table, pairs=10):
    """One sketch-mode server step with --server_fused auto against off:
    update, Vvelocity and Verror bitwise equal; then ``pairs`` alternating
    timings of the two steps (each the median of 5 CUDA-event timings)."""
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.server import (make_sketch,
                                                          server_update)
    from commefficient_tpu_torch.federated.state import ServerOptState
    rng = np.random.RandomState(2)
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=K, num_cols=cs.c,
                    num_rows=cs.r).finalize(cs.d)
    sketch = make_sketch(cfg)
    state = ServerOptState(*(torch.from_numpy(
        rng.randn(*cfg.transmit_shape).astype(np.float32)).to(dev)
        for _ in range(2)))
    cfgs = {f: replace(cfg, server_fused=f) for f in ("auto", "off")}
    (ua, sa), (uo, so) = (server_update(table, state, cfgs[f], 0.1, sketch)
                          for f in ("auto", "off"))
    if not (_same_bits(ua, uo) and _same_bits(sa.Vvelocity, so.Vvelocity)
            and _same_bits(sa.Verror, so.Verror)):
        raise AssertionError(f"server step (d={cs.d}): --server_fused auto "
                             "!= off")
    nonzeros = int(ua.ne(0).sum())
    del ua, sa, uo, so
    ms = {"auto": [], "off": []}
    for i in range(pairs):
        for f in (("auto", "off") if i % 2 == 0 else ("off", "auto")):
            ms[f].append(_time_ms(lambda c=cfgs[f]: server_update(
                table, state, c, 0.1, sketch), reps=5))
    wins = sum(a < o for a, o in zip(ms["auto"], ms["off"]))
    print(f"server A/B (sketch, d={cs.d}, k={K}): --server_fused auto and "
          f"off give bitwise equal update ({nonzeros} nonzeros), Vvelocity "
          f"and Verror; {pairs} alternating pairs of one server step: auto "
          f"median {float(np.median(ms['auto'])):.4f} ms, off median "
          f"{float(np.median(ms['off'])):.4f} ms, auto faster in {wins} of "
          f"{pairs}; auto {[round(x, 4) for x in ms['auto']]}, off "
          f"{[round(x, 4) for x in ms['off']]}", flush=True)
    torch.cuda.empty_cache()


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
        device_ms=_device_ms(lambda: sketch_vec_batched(cs, vecs)),
        plain_ms=_time_ms(lambda: sketch_vec_batched_plain(cs, vecs),
                          plain_reps),
        library_ms=_time_ms(library),
        unbatched_ms=_time_ms(lambda: [sketch_vec(cs, vecs[b])
                                       for b in range(B)]),
        cost=_sketch_cost(cs, B), at=f"B={B}, d={d}")
    del buckets, signed, flat
    torch.cuda.empty_cache()
    bound_ms, kind = r["cost"]
    design_b, design_ms = _sketch_design(cs, B)
    print(f"time sketch_batched ({r['at']}): kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f} ms a call, 20 back to back), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
          f"{B} unbatched calls {r['unbatched_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({kind}); the design's bytes at most "
          f"{design_b:,} ({design_ms:.5f} ms: x {cs.r} times a row)",
          flush=True)
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
            device_ms=_device_ms(lambda: sketch_vec(cs, vec)),
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
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back)" if "device_ms" in r else "")
        print(f"time {name} (d={cs.d}): kernel {r['ms']:.4f} ms{dev_ms}, "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind})",
              flush=True)
    design_b, design_ms = _sketch_design(cs)
    print(f"  sketch: the design's bytes at most {design_b:,} "
          f"({design_ms:.5f} ms: x {cs.r} times, once a row's sweep)",
          flush=True)
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
            device_ms=_device_ms(lambda: estimates(cs, table)),
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
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back)" if "device_ms" in r else "")
        print(f"time {name} ({r['at']}): kernel {r['ms']:.4f} ms{dev_ms}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
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
        device_ms=_device_ms(lambda: estimates_batched(cs, tables)),
        plain_ms=_time_ms(lambda: estimates_batched_plain(cs, tables)),
        library_ms=None,
        unbatched_ms=_time_ms(lambda: [estimates(cs, t) for t in tables]),
        b1_ms=_time_ms(lambda: estimates_batched(cs, one)),
        b1_device_ms=_device_ms(lambda: estimates_batched(cs, one)),
        row4_ms=_time_ms(lambda: estimates(cs, table)),
        cost=_estimates_batched_cost(cs, B),
        at=f"B={B}, {cs.r}x{cs.c_eff} -> {cs.d}")
    bound_ms, kind = r["cost"]
    print(f"time estimates_batched ({r['at']}): kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f} ms a call, 20 back to back), "
          f"plain {r['plain_ms']:.4f} ms, library none, {B} unbatched "
          f"launches {r['unbatched_ms']:.4f} ms, bound {bound_ms:.5f} ms "
          f"({kind}); at B=1 {r['b1_ms']:.4f} ms (device "
          f"{r['b1_device_ms']:.4f} ms) against the unbatched kernel's "
          f"{r['row4_ms']:.4f} ms (bound "
          f"{_estimates_batched_cost(cs, 1)[0]:.5f} ms)", flush=True)
    return r


def _radix_tables(dev, cs, table):
    """The tables of the radix parity: the sketched vector's, planted ties
    (few distinct magnitudes, ties spread over every tile), all zero, and
    seeded normals with +-0.0 and NaN cells."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(cs.d % 1000)
    ties = torch.tensor([-3, -2, -1, 1, 2, 3], dtype=torch.float32,
                        device=dev)[torch.randint(
                            6, (cs.r, cs.c_eff), generator=gen, device=dev)]
    nan0 = torch.randn((cs.r, cs.c_eff), generator=gen, device=dev)
    u = torch.rand((cs.r, cs.c_eff), generator=gen, device=dev)
    nan0[u < 0.3] = 0.0
    nan0[(u >= 0.3) & (u < 0.5)] = -0.0
    nan0[u > 0.99995] = float("nan")
    return {"sketched vector": table, "planted ties": ties,
            "all zero": torch.zeros_like(table), "+-0.0 and NaN": nan0}


def phase_parity_radix(dev, cs, table, errs):
    """The estimate-once histogram radix against its plain versions at
    ``cs.d``, bitwise, on each table of ``_radix_tables``: the stored
    estimates, each pass's digit histogram, t and n_take (also against the
    first port's count kernels' radix), the dense and the compact select;
    then both entry points again, bitwise equal to the first run."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    for name in ("est_hist", "digit_hist", "radix_select", "radix_compact"):
        errs.setdefault(name, 0.0)
    for name, tab in _radix_tables(dev, cs, table).items():
        est, ws = tk.unsketch_radix(cs, tab, K)
        dense = tk.radix_select(est, cs.d, K, ws, dense=True)
        compact = tk.radix_select(est, cs.d, K, ws, dense=False)
        views = tk.radix_views(ws)
        p_est = cs.estimates(tab)
        if not _same_bits(est[:cs.d], p_est):
            raise AssertionError(f"est_hist estimates != plain ({name}, "
                                 f"d={cs.d})")
        bits = tk._score_bits(p_est)
        prefix = torch.zeros((), dtype=torch.int64, device=dev)
        k_rem = prefix + K
        for p, ((shift, width), hist) in enumerate(zip(tk.DIGITS,
                                                       views["hists"])):
            want = tk.digit_histogram_plain(bits, prefix, shift, width)
            if not torch.equal(hist, want):
                raise AssertionError(f"digit histogram of pass {p} != "
                                     f"plain ({name}, d={cs.d})")
            key = "est_hist" if p == 0 else "digit_hist"
            errs[key] = max(errs[key], _max_abs_err(hist, want))
            b, above = tk.digit_pick_plain(want, k_rem)
            prefix, k_rem = (prefix << width) | b, k_rem - above
        t, n_take = tk.radix_threshold_plain(bits, K)
        del bits
        got = (int(views["t"]), int(views["n_take"]))
        ct, cn = tk._radix_threshold(lambda c: tk.count(cs, tab, c), K, dev)
        if got != (int(t), int(n_take)) or got != (int(ct), int(cn)):
            raise AssertionError(f"radix (t, n_take) {got} != plain "
                                 f"{(int(t), int(n_take))} / count kernels' "
                                 f"{(int(ct), int(cn))} ({name}, d={cs.d})")
        p_dense = tk._select_est(p_est, t, n_take)
        p_compact = tk.select_compact_plain(p_est, t, n_take, K)
        if not (_same_bits(dense[0], p_dense[0])
                and torch.equal(dense[1], p_dense[1])):
            raise AssertionError(f"radix_select != plain ({name}, "
                                 f"d={cs.d})")
        if not (_same_bits(compact[0], p_compact[0])
                and torch.equal(compact[1], p_compact[1])):
            raise AssertionError(f"radix_compact != plain ({name}, "
                                 f"d={cs.d})")
        errs["radix_select"] = max(errs["radix_select"],
                                   _max_abs_err(dense[0], p_dense[0]),
                                   _max_abs_err(dense[1], p_dense[1]))
        errs["radix_compact"] = max(errs["radix_compact"],
                                    _max_abs_err(compact[0], p_compact[0]),
                                    _max_abs_err(compact[1], p_compact[1]))
        del p_est, p_dense, p_compact, est, ws
        again = tk.unsketch_select(cs, tab, K)
        if not (_same_bits(again[0], dense[0])
                and torch.equal(again[1], dense[1])):
            raise AssertionError(f"unsketch_select differs between two runs "
                                 f"({name}, d={cs.d})")
        del again
        again = tk.unsketch_compact(cs, tab, K)
        if not (_same_bits(again[0], compact[0])
                and torch.equal(again[1], compact[1])):
            raise AssertionError(f"unsketch_compact differs between two "
                                 f"runs ({name}, d={cs.d})")
        kept = int(dense[1].sum())
        del again, dense, compact
        print(f"parity radix ({name}, d={cs.d}, k={K}): stored estimates, "
              f"the 3 digit histograms, t {got[0]}, n_take {got[1]} (= the "
              f"count kernels' radix), dense and compact selects bitwise "
              f"equal to plain, deterministic over 2 runs; {kept} kept",
              flush=True)
    torch.cuda.empty_cache()


def phase_timing_radix(cs, table, pairs=20):
    """Times of the histogram radix at ``cs.d``: each kernel alone (its
    workspace restored outside the timed events) beside its plain version
    and bound; the whole recovery, compact and dense, against the first
    port's count x 9 + select as ``pairs`` alternating rounds in this
    process (each side the median of 25 timings); ``torch.topk`` of the
    squared estimates, and ``estimates_batched`` + ``torch.topk``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.sketch_kernels import estimates_batched
    dev, d = table.device, cs.d
    est, ws = tk.radix_workspace(d, dev)
    snaps = []
    tk.est_hist(cs, table, K, est, ws)
    snaps.append(ws.clone())
    for p in (1, 2):
        tk.digit_hist(est, d, K, ws, p)
        snaps.append(ws.clone())
    p_est = cs.estimates(table)
    bits = tk._score_bits(p_est)
    prefixes = [torch.zeros((), dtype=torch.int64, device=dev)]
    k_rem = prefixes[0] + K
    for shift, width in tk.DIGITS:
        b, above = tk.digit_pick_plain(tk.digit_histogram_plain(
            bits, prefixes[-1], shift, width), k_rem)
        prefixes.append((prefixes[-1] << width) | b)
        k_rem = k_rem - above
    t, n_take = tk.radix_threshold_plain(bits, K)
    scores = p_est * p_est
    del bits

    def restore(i):
        return lambda: ws.copy_(snaps[i])

    def plain_pass(p):
        shift, width = tk.DIGITS[p]
        est_ = cs.estimates(table) if p == 0 else p_est
        hist = tk.digit_histogram_plain(tk._score_bits(est_), prefixes[p],
                                        shift, width)
        return tk.digit_pick_plain(hist, K)

    topk_ms = _time_ms(lambda: torch.topk(scores, K))
    est_topk_ms = _time_ms(lambda: torch.topk(
        torch.square(estimates_batched(cs, table[None])[0]), K))
    digit_ms = [_time_ms(lambda p=p: tk.digit_hist(est, d, K, ws, p),
                         setup=restore(p - 1)) for p in (1, 2)]
    plain_reps = REPS if d < 2 * 10 ** 7 else 3
    rows = {
        "est_hist": dict(
            ms=_time_ms(lambda: tk.est_hist(cs, table, K, est, ws),
                        setup=ws.zero_),
            device_ms=_device_ms(lambda: tk.est_hist(cs, table, K, est, ws),
                                 setup=ws.zero_),
            plain_ms=_time_ms(lambda: plain_pass(0), plain_reps),
            library_ms=None, cost=_est_hist_cost(cs)),
        "digit_hist": dict(
            ms=float(np.mean(digit_ms)),
            plain_ms=float(np.mean([_time_ms(lambda p=p: plain_pass(p),
                                             plain_reps) for p in (1, 2)])),
            library_ms=None, cost=_digit_hist_cost(cs),
            at=f"d={d}; mean of pass 1 {digit_ms[0]:.4f} ms and pass 2 "
               f"{digit_ms[1]:.4f} ms"),
        "radix_compact": dict(
            ms=_time_ms(lambda: tk.radix_select(est, d, K, ws, False),
                        setup=restore(2)),
            plain_ms=_time_ms(lambda: tk.select_compact_plain(
                p_est, t, n_take, K), plain_reps),
            library_ms=topk_ms, cost=_radix_select_cost(cs, False)),
        "radix_select": dict(
            ms=_time_ms(lambda: tk.radix_select(est, d, K, ws, True),
                        setup=restore(2)),
            plain_ms=_time_ms(lambda: tk._select_est(p_est, t, n_take),
                              plain_reps),
            library_ms=topk_ms, cost=_radix_select_cost(cs, True)),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        dev_ms = (f" (device {r['device_ms']:.4f} ms a call, 20 back to "
                  f"back, less 20 workspace restores)" if "device_ms" in r
                  else "")
        print(f"time {name} ({r.get('at', f'd={d}')}): kernel "
              f"{r['ms']:.4f} ms{dev_ms}, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {bound_ms:.5f} ms ({kind})",
              flush=True)
    del snaps, p_est, scores

    def old():
        t_, n_ = tk._radix_threshold(lambda c: tk.count(cs, table, c), K,
                                     dev)
        return tk.select(cs, table, t_, n_)

    sides = {"old": old,
             "new_dense": lambda: tk.unsketch_select(cs, table, K),
             "new_compact": lambda: tk.unsketch_compact(cs, table, K)}
    ms = {name: [] for name in sides}
    names = list(sides)
    for i in range(pairs):
        order = names if i % 2 == 0 else names[::-1]
        for name in order:
            ms[name].append(_time_ms(sides[name]))
    med = {name: float(np.median(v)) for name, v in ms.items()}
    ratio = [o / n for o, n in zip(ms["old"], ms["new_dense"])]
    pair_bound = sum(r["cost"][0] for r in
                     (rows["est_hist"], rows["digit_hist"],
                      rows["digit_hist"], rows["radix_compact"]))
    design_ms = max(_radix_design_bytes(cs, False) / HBM_BYTES_PER_S * 1e3,
                    (_estimate_ops(cs) + 5 * _OPS_RADIX * d)
                    / CUDA_CORE_OPS_PER_S * 1e3)
    print(f"time recovery (d={d}, k={K}, {pairs} alternating rounds): new "
          f"compact {med['new_compact']:.4f} ms, new dense "
          f"{med['new_dense']:.4f} ms, old count x 9 + select "
          f"{med['old']:.4f} ms (old / new dense: median "
          f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
          f"{max(ratio):.3f}); torch.topk of the squared estimates "
          f"{topk_ms:.4f} ms, estimates_batched + torch.topk "
          f"{est_topk_ms:.4f} ms; bound of the compact recovery "
          f"{pair_bound:.5f} ms (sum of its kernels' bounds; the design's "
          f"own bytes and operations {design_ms:.5f} ms)", flush=True)
    print(f"  rounds: new compact {[round(x, 4) for x in ms['new_compact']]},"
          f" new dense {[round(x, 4) for x in ms['new_dense']]}, old "
          f"{[round(x, 4) for x in ms['old']]}", flush=True)
    del est, ws
    torch.cuda.empty_cache()
    return rows


def _rows_stream(dev):
    """The (8, d) stream of the per-row radix's check, one row per case:
    seeded normals (rows 0, 3, 4, 6, 7), all zero (1), 3k planted ties at
    3.0 (2, k/2 among them), normals with 30% +0.0, 20% -0.0 and 1% NaN
    (5)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((len(KK_RADIX), D_RESNET9), generator=gen, device=dev)
    x[1] = 0.0
    x[2, torch.randperm(D_RESNET9, generator=gen, device=dev)[:3 * K]] = 3.0
    u = torch.rand(D_RESNET9, generator=gen, device=dev)
    x[5, u < 0.3] = 0.0
    x[5, (u >= 0.3) & (u < 0.5)] = -0.0
    x[5, u > 0.99] = float("nan")
    return x


def _check_rows_radix(tag, x, kk, ws, errs):
    """A ``rows_radix`` workspace against the plain versions, per row:
    each pass's histograms, t and n_take. Returns the plain (t, n_take)."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    views = tk.rows_views(ws)
    bits = tk._score_bits(x)
    prefix, k_rem = torch.zeros_like(kk), kk
    for p, ((shift, width), hist) in enumerate(zip(tk.DIGITS,
                                                   views["hists"])):
        want = tk.digit_histogram_plain(bits, prefix, shift, width)
        if not torch.equal(hist, want):
            raise AssertionError(f"rows_hist pass {p} histograms != plain "
                                 f"({tag})")
        errs["rows_hist"] = max(errs["rows_hist"], _max_abs_err(hist, want))
        b, above = tk.digit_pick_plain(want, k_rem)
        prefix, k_rem = (prefix << width) | b, k_rem - above
    t, n_take = tk.radix_threshold_rows_plain(bits, kk)
    if not (torch.equal(views["t"], t)
            and torch.equal(views["n_take"], n_take)):
        raise AssertionError(f"rows_hist (t, n_take) {views['t'].tolist()}, "
                             f"{views['n_take'].tolist()} != plain "
                             f"{t.tolist()}, {n_take.tolist()} ({tag})")
    return t, n_take


def phase_parity_rows(dev, errs):
    """The per-row histogram radix (the plain and resid sources' route)
    against its plain versions at ResNet9's d, bitwise: at
    B = 8 with ``KK_RADIX`` over random, all-zero, planted-tie and
    NaN-bearing rows, each pass's per-row histograms, t and n_take, the
    select with and without the mask; at B = 1 the resid select over
    ``_resid_inputs`` (planted ties; selected +-0.0); every entry point
    twice, bitwise equal. Returns the timing phase's inputs."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    for name in ("rows_hist", "rows_select", "rows_resid"):
        errs.setdefault(name, 0.0)
    xs = _rows_stream(dev)
    kk = torch.tensor(KK_RADIX, device=dev)
    ws = tk.rows_radix(xs, kk)
    t, n_take = _check_rows_radix(f"B=8, kk {KK_RADIX}", xs, kk, ws, errs)
    for with_mask in (True, False):
        got = tk.rows_select(xs, ws, with_mask)
        ref = tk.select_rows_plain(xs, t, n_take, with_mask)
        if not _same_bits(got[0], ref[0]) or (
                with_mask and not torch.equal(got[1], ref[1])):
            raise AssertionError(f"rows_select != plain (mask {with_mask})")
        errs["rows_select"] = max(errs["rows_select"],
                                  _max_abs_err(got[0], ref[0]))
    kept = ref[0].ne(0).sum(1).tolist()
    again = tk.topk_select(xs, kk, K, with_mask=True)
    if not (_same_bits(again[0], ref[0]) and torch.equal(
            again[1], tk.select_rows_plain(xs, t, n_take, True)[1])):
        raise AssertionError("topk_select differs from its first run / the "
                             "plain selection")
    taken = again[1].sum(1).tolist()
    print(f"parity rows_hist/rows_select (8 x {D_RESNET9}, kk {KK_RADIX}; "
          f"random, all-zero, planted ties, NaN rows): per-pass histograms, "
          f"t {t.tolist()}, n_take {n_take.tolist()} and the select with "
          f"and without mask bitwise equal to plain, deterministic over 2 "
          f"runs; selected {taken}, nonzeros kept {kept}", flush=True)
    del again, got, ref, ws

    rng = np.random.RandomState(12)
    kk1 = torch.full((1,), K, dtype=torch.int64, device=dev)
    for name, sparse in (("planted ties", False), ("selected +-0.0", True)):
        g, vv, ve = _resid_inputs(dev, rng, sparse)
        v = g + 0.9 * vv
        err = ve + v
        ws1 = tk.rows_radix(err[None], kk1)
        t1, n1 = _check_rows_radix(f"B=1, {name}", err[None], kk1, ws1, errs)
        got = tk.rows_resid(err, v, ws1)
        ref = tk.select_resid_plain(err, v, t1[0], n1[0])
        fused = tk.fused_true_topk(g, vv, ve, K, 0.9)
        for a, b, c in zip(got, ref, fused):
            if not (_same_bits(a, b) and _same_bits(c, b)):
                raise AssertionError(f"rows_resid != plain / fused_true_topk"
                                     f" ({name})")
            errs["rows_resid"] = max(errs["rows_resid"], _max_abs_err(a, b))
        print(f"parity rows_hist/rows_resid (B=1, n={D_RESNET9}, k={K}, "
              f"{name}): histograms, t {int(t1[0])}, n_take {int(n1[0])}, "
              f"update, velocity and error bitwise equal to plain and to a "
              f"second run through fused_true_topk", flush=True)
    return {"xs": xs, "kk": kk, "err": err, "v": v, "kk1": kk1}


def _rows_hist_cost(rows, n):
    """One digit pass: the stream read once, the rows' histograms
    written."""
    return _bound(4 * rows * n + 4 * rows * 2048, _OPS_RADIX * rows * n)


def _time_rows_passes(x, kk, plain_reps=REPS):
    """Each digit pass alone (its workspace restored outside the timed
    events) and its plain version: ``(ms [3], plain ms [3], ws after the
    last pass)``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    ws = tk.rows_workspace(x.shape[0], x.device)
    snaps = [ws.clone()]
    for p in range(3):
        tk.rows_hist(x, kk, ws, p)
        snaps.append(ws.clone())
    bits = tk._score_bits(x)
    prefixes, k_rem = [torch.zeros_like(kk)], kk
    for shift, width in tk.DIGITS:
        b, above = tk.digit_pick_plain(tk.digit_histogram_plain(
            bits, prefixes[-1], shift, width), k_rem)
        prefixes.append((prefixes[-1] << width) | b)
        k_rem = k_rem - above
    ms = [_time_ms(lambda p=p: tk.rows_hist(x, kk, ws, p),
                   setup=lambda p=p: ws.copy_(snaps[p])) for p in range(3)]

    def plain_pass(p):
        shift, width = tk.DIGITS[p]
        return tk.digit_pick_plain(tk.digit_histogram_plain(
            tk._score_bits(x), prefixes[p], shift, width), kk)

    plain = [_time_ms(lambda p=p: plain_pass(p), plain_reps)
             for p in range(3)]
    ws.copy_(snaps[3])
    return ms, plain, ws


def _alternate(sides, pairs):
    """``pairs`` alternating rounds of every side (each the median of 25
    CUDA-event timings): ``{side: [ms a round]}``."""
    ms = {name: [] for name in sides}
    names = list(sides)
    for i in range(pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            ms[name].append(_time_ms(sides[name]))
    return ms


def _report_route(tag, ms, bound_ms, design_ms):
    med = {name: float(np.median(v)) for name, v in ms.items()}
    ratio = [o / n for o, n in zip(ms["old"], ms["new"])]
    print(f"time {tag} ({len(ms['new'])} alternating rounds): new "
          f"{med['new']:.4f} ms, old (nibble glue + count_plain x 9 + "
          f"select) {med['old']:.4f} ms (old / new: median "
          f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
          f"{max(ratio):.3f}), torch.topk of the squares {med['topk']:.4f} "
          f"ms; bound of the function {bound_ms:.5f} ms, of the design's "
          f"own bytes {design_ms:.5f} ms", flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(x, 4) for x in v]}" for name, v in ms.items()),
          flush=True)
    return med


def phase_timing_rows(inputs, pairs=20):
    """Times of the per-row radix at the main paths' shapes: each digit
    pass, the select (B = 8, no mask: local_topk's call) and the resid
    select (B = 1: true_topk's) beside their plain versions and bounds;
    then the whole top-k by the new route, by the first port's (nibble
    glue, count_plain x 9, select_plain or select_resid) and
    ``torch.topk`` of the squares as ``pairs`` alternating rounds, at
    B = 8 and B = 1."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    xs, kk = inputs["xs"], inputs["kk"]
    err, v, kk1 = inputs["err"], inputs["v"], inputs["kk1"]
    B, n = xs.shape
    dev = xs.device
    err_rows = err[None]
    pass_ms, pass_plain, ws = _time_rows_passes(xs, kk)
    pass1_ms, pass1_plain, ws1 = _time_rows_passes(err_rows, kk1)
    views, views1 = tk.rows_views(ws), tk.rows_views(ws1)
    t, n_take = views["t"], views["n_take"]
    t1, n1 = views1["t"][0], views1["n_take"][0]
    scores8, scores1 = xs * xs, err * err
    topk_b8 = _time_ms(lambda: torch.topk(scores8, K, dim=-1))
    topk_b1 = _time_ms(lambda: torch.topk(scores1, K))
    rows = {
        "rows_hist": dict(
            ms=float(np.mean(pass_ms)), plain_ms=float(np.mean(pass_plain)),
            library_ms=topk_b8, cost=_rows_hist_cost(B, n),
            at=f"B={B}, n={n}, mean of the 3 passes: pass 0 "
               f"{pass_ms[0]:.4f} ms, 1 {pass_ms[1]:.4f}, 2 "
               f"{pass_ms[2]:.4f}; B=1: {pass1_ms[0]:.4f}, "
               f"{pass1_ms[1]:.4f}, {pass1_ms[2]:.4f} (plain "
               f"{float(np.mean(pass1_plain)):.4f}, bound "
               f"{_rows_hist_cost(1, n)[0]:.5f})"),
        "rows_select": dict(
            ms=_time_ms(lambda: tk.rows_select(xs, ws)),
            plain_ms=_time_ms(lambda: tk.select_rows_plain(xs, t, n_take)),
            library_ms=topk_b8, cost=_select_plain_cost(B, n),
            at=f"B={B}, n={n}, no mask; counts, scan and select"),
        "rows_resid": dict(
            ms=_time_ms(lambda: tk.rows_resid(err, v, ws1)),
            plain_ms=_time_ms(lambda: tk.select_resid_plain(err, v, t1, n1)),
            library_ms=topk_b1, cost=_select_resid_cost(n),
            at=f"B=1, n={n}; counts, scan and select"),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} ({r['at']}): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({kind})", flush=True)
    print(f"  library: rows_hist, rows_select = torch.topk(k={K}, dim=-1) "
          f"of the 8 rows' squares; rows_resid = torch.topk(k={K}) of err's "
          f"squares (selection only, for the whole top-k)", flush=True)
    del ws, ws1

    def old8():
        t_, n_ = tk._radix_threshold_batched(lambda c: tk.count_rows(xs, c),
                                             kk, dev)
        return tk.select_rows(xs, t_, n_)

    med8 = _report_route(
        f"top-k (B={B}, n={n}, kk {KK_RADIX})",
        _alternate({"new": lambda: tk.topk_select(xs, kk, K), "old": old8,
                    "topk": lambda: torch.topk(scores8, K, dim=-1)}, pairs),
        _select_plain_cost(B, n)[0],
        6 * 4 * B * n / HBM_BYTES_PER_S * 1e3)
    rows["rows_select"]["at"] += (f"; whole top-k {med8['new']:.4f} ms, old "
                                  f"route {med8['old']:.4f}")
    med1 = _time_rows_b1(err, v, kk1, scores1, pairs)
    rows["rows_resid"]["at"] += (f"; whole top-k {med1['new']:.4f} ms, old "
                                 f"route {med1['old']:.4f}")
    torch.cuda.empty_cache()
    return rows


def _time_rows_b1(err, v, kk1, scores1, pairs):
    """true_topk's whole top-k at B = 1, new against old route and
    ``torch.topk``, ``pairs`` alternating rounds; the momentum read, the
    same on both routes, is left out."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    err_rows = err[None]
    n = err.shape[0]

    def old1():
        t_, n_ = tk._radix_threshold_batched(
            lambda c: tk.count_rows(err_rows, c), kk1, err.device)
        return tk.select_resid(err, v, t_[0], n_[0])

    return _report_route(
        f"top-k (B=1, n={n}, k={K}, resid)",
        _alternate({"new": lambda: tk.rows_resid(
            err, v, tk.rows_radix(err_rows, kk1)), "old": old1,
            "topk": lambda: torch.topk(scores1, K)}, pairs),
        _select_resid_cost(n)[0], 4 * n * 9 / HBM_BYTES_PER_S * 1e3)


def phase_timing_rows_b1(dev, d, pairs=20):
    """The B = 1 resid top-k at the GPT2 path's d (no main path runs
    true_topk there): a seeded (err, v) pair, parity of the new route with
    the plain versions, then the alternating rounds of ``_time_rows_b1``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    gen = torch.Generator(device=dev).manual_seed(13)
    err = torch.randn(d, generator=gen, device=dev)
    v = torch.randn(d, generator=gen, device=dev)
    kk1 = torch.full((1,), K, dtype=torch.int64, device=dev)
    ws1 = tk.rows_radix(err[None], kk1)
    t1, n1 = _check_rows_radix(f"B=1, n={d}", err[None], kk1, ws1,
                               {"rows_hist": 0.0})
    got = tk.rows_resid(err, v, ws1)
    ref = tk.select_resid_plain(err, v, t1[0], n1[0])
    if not all(_same_bits(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"rows_resid != plain (n={d})")
    del got, ref, ws1
    ms, plain, _ = _time_rows_passes(err[None], kk1, plain_reps=3)
    print(f"parity rows_hist/rows_resid (B=1, n={d}, k={K}): bitwise equal "
          f"to plain; passes {ms[0]:.4f}, {ms[1]:.4f}, {ms[2]:.4f} ms "
          f"(plain {float(np.mean(plain)):.4f}, bound "
          f"{_rows_hist_cost(1, d)[0]:.5f} a pass)", flush=True)
    _time_rows_b1(err, v, kk1, err * err, pairs)
    del err, v
    torch.cuda.empty_cache()


def phase_sketch_sparse(dev, cs, table):
    """The deterministic sparse re-sketch on the card: the k survivors of
    the sketched table, three of them planted in one row-0 bucket with
    signed 1e8, 1, -1e8 (a sum that depends on the order), bitwise equal
    to the CPU's table over two runs; timed beside ``index_add_`` a row
    (atomic order)."""
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    vals, idxs = cs.unsketch_values_indices(table, K)
    signs, buckets = cs._row_hashes(0, idxs)
    b, counts = torch.unique(buckets, return_counts=True)
    three = torch.nonzero(buckets == b[counts >= 3][0]).flatten()[:3]
    vals = vals.clone()
    vals[three] = torch.tensor([1e8, 1.0, -1e8], device=dev) * signs[three]
    cpu = cs.sketch_sparse(vals.cpu(), idxs.cpu())
    before = cuda_lib.LAUNCHES["segment_sum"]
    got = cs.sketch_sparse(vals, idxs)
    again = cs.sketch_sparse(vals, idxs)
    if cuda_lib.LAUNCHES["segment_sum"] != before + 2:
        raise AssertionError("sketch_sparse did not launch segment_sum")
    if not (_same_bits(got.cpu(), cpu) and _same_bits(again, got)):
        raise AssertionError(f"sketch_sparse on the card != CPU or differs "
                             f"between runs (d={cs.d})")
    hot = got.view(-1)[buckets[three[0]]]

    def atomic():
        out = cs.zero_table(dev)
        for row in range(cs.r):
            s_, b_ = cs._row_hashes(row, idxs)
            out[row].index_add_(0, b_, s_ * vals)
        return out

    ms = _time_ms(lambda: cs.sketch_sparse(vals, idxs))
    lib_ms = _time_ms(atomic)
    print(f"parity sketch_sparse (d={cs.d}, {K} survivors, 3 planted in one "
          f"bucket as 1e8, 1, -1e8 -> {float(hot)!r}): card bitwise equal "
          f"to the CPU, deterministic over 2 runs; {ms:.4f} ms (sort + "
          f"segment_sum) against {lib_ms:.4f} ms with index_add_ atomics",
          flush=True)


def phase_repeat(dev):
    """Reproducibility of the headline sketch path (ROADMAP C5): two runs
    of 3 rounds through ``training.cv.train`` from the same seed must give
    bitwise equal per-round losses, weights, Vvelocity and Verror. Then
    what deterministic cuDNN costs: one ResNet9 forward and backward at
    the path's batch (8 workers x 32 images), called directly, with
    ``torch.backends.cudnn.deterministic`` False, then True."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.models.resnet9 import ResNet9
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    runs = []
    for _ in range(2):
        args = build_parser().parse_args(HEADLINE)
        np.random.seed(args.seed)
        learner, row = train(args, max_rounds=3, log=False)
        s = learner.state
        runs.append(([r["loss"] for r in row["rounds"]],
                     s.weights.clone(), s.opt.Vvelocity.clone(),
                     s.opt.Verror.clone()))
        del learner, row, s
    (la, *ta), (lb, *tb) = runs
    same = [_same_bits(a, b) for a, b in zip(ta, tb)]
    if [x.hex() for x in la] != [x.hex() for x in lb] or not all(same):
        raise AssertionError(f"the sketch path is not reproducible: losses "
                             f"{la} vs {lb}; weights, Vvelocity, Verror "
                             f"bitwise equal: {same}")
    del runs, ta, tb
    torch.cuda.empty_cache()
    model = ResNet9().reset_parameters(
        torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((8 * 32, 32, 32, 3), generator=gen, device=dev)
    y = torch.randint(10, (8 * 32,), generator=gen, device=dev)

    def step():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x), y).backward()

    ms = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        ms[det] = _time_ms(step)
    torch.backends.cudnn.deterministic = True
    print(f"repeat sketch (3 rounds twice, same seed): losses "
          f"{[round(v, 6) for v in la]}, losses, weights, Vvelocity and "
          f"Verror bitwise equal; ResNet9 forward + backward (256 images): "
          f"cudnn.deterministic False {ms[False]:.4f} ms, True "
          f"{ms[True]:.4f} ms", flush=True)
    del model, x, y
    torch.cuda.empty_cache()


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


def _back_to_back_ms(fn, n=200) -> float:
    """Device time of one ``fn()``: ``n`` calls back to back between one
    pair of CUDA events, over ``n``. The host's work before each launch
    hides behind the device while it is shorter than the kernel."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _host_us(fn, n=200) -> float:
    """Host time of one ``fn()`` in microseconds: ``n`` calls in a row
    on the host's clock, over ``n``, the device idle at the start so
    that no launch waits for a full queue."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return host / n * 1e6


def phase_hw_dropout_timing(dev, pairs=20):
    """The hardware-RNG dropout's call against
    ``torch.nn.functional.dropout`` (the library row) at the GPT2 path's
    activation shape and at the mc head's, as ``pairs`` alternating
    rounds (each side the median of 25 CUDA-event timings of one call, so
    the host's work before the launch counts); each one's device time
    alone (``_back_to_back_ms``) and host time (``_host_us``); the plain
    version and the bound. Every
    input needs a gradient, as the training path's activations do, so
    both calls record their autograd node as they do there."""
    import torch
    import torch.nn.functional as F

    from commefficient_tpu_torch.ops.dropout import (hw_dropout,
                                                     hw_dropout_plain,
                                                     seed_words)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(HW_SHAPE, generator=gen, device=dev)
    mc = x[:, 0].contiguous().requires_grad_(True)
    x.requires_grad_(True)
    seeds = seed_words(1234)
    hw = lambda a: (lambda: hw_dropout(a, seeds, HW_RATE))
    lib = lambda a: (lambda: F.dropout(a, HW_RATE, training=True))
    ms = _alternate({"hw": hw(x), "lib": lib(x), "hw_mc": hw(mc),
                     "lib_mc": lib(mc)}, pairs)
    med = {name: float(np.median(v)) for name, v in ms.items()}
    at = f"{HW_SHAPE}, f32 with requires_grad, rate {HW_RATE}"
    r = dict(ms=med["hw"], library_ms=med["lib"],
             plain_ms=_time_ms(lambda: hw_dropout_plain(x.detach(), seeds,
                                                        HW_RATE)),
             device_ms=_back_to_back_ms(hw(x)),
             cost=_hw_dropout_cost(x.numel()), at=at)
    lib_device_ms = _back_to_back_ms(lib(x))
    mc_device_ms = (_back_to_back_ms(hw(mc)), _back_to_back_ms(lib(mc)))
    host_us = {name: _host_us(fn) for name, fn in (
        ("hw", hw(x)), ("lib", lib(x)), ("hw_mc", hw(mc)),
        ("lib_mc", lib(mc)))}
    bound_ms, kind = r["cost"]
    ratio = [a / b for a, b in zip(ms["lib"], ms["hw"])]
    print(f"time hw_dropout ({at}; {pairs} alternating rounds of one "
          f"call): kernel {r['ms']:.4f} ms, F.dropout {r['library_ms']:.4f} "
          f"ms (F.dropout / hw_dropout: median {float(np.median(ratio)):.3f},"
          f" min {min(ratio):.3f}, max {max(ratio):.3f}); device time alone "
          f"{r['device_ms']:.4f} ms, F.dropout's {lib_device_ms:.4f} ms; "
          f"plain {r['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind}); "
          f"at the mc head's {tuple(mc.shape)} {med['hw_mc']:.4f} ms, "
          f"F.dropout {med['lib_mc']:.4f} ms, device time alone "
          f"{mc_device_ms[0]:.4f} and {mc_device_ms[1]:.4f} ms; host time "
          f"of a call (us): " + ", ".join(
              f"{name} {v:.2f}" for name, v in host_us.items()), flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(v, 4) for v in vals]}" for name, vals in ms.items()),
          flush=True)
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


def _flash_run(q, k, v, g, args, v1=False):
    """The kernels' forward and backward: the tensor-core forward, dq and
    dk/dv, or (``v1``) the first port's scalar ones."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    fwd = fa.flash_fwd_v1 if v1 else fa.flash_fwd
    bwd_dq = fa.flash_bwd_dq_v1 if v1 else fa.flash_bwd_dq
    dkv = fa.flash_bwd_dkv_v1 if v1 else fa.flash_bwd_dkv
    o, lse = fwd(q, k, v, *args)
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = bwd_dq(q, k, v, g, lse, delta, *args)
    dk, dv = dkv(q, k, v, g, lse, delta, *args)
    return o, lse, dq, dk, dv


_FLASH_NAMES = ("o", "lse", "dq", "dk", "dv")


def _flash_check(dev, bh, t, d, dtype, rate, seed):
    """Both routes' kernels twice (bitwise equal) and against the plain
    versions: ``{route: ({name: max abs err}, {name: err relative to max
    |plain|})}``, route "tc" (the path's kernels) or "v1", and "v1 - tc"
    (the two routes against each other, relative to max |plain|)."""
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    q, k, v, g = _flash_inputs(dev, bh, t, d, dtype, seed)
    args = _flash_args(d, rate)
    ref = fa.flash_fwd_plain(q, k, v, *args) + fa.flash_bwd_plain(
        q, k, v, g, *args)
    top = {n: max(float(b.double().abs().max()), 1e-30)
           for n, b in zip(_FLASH_NAMES, ref)}
    out, got = {}, {}
    for route in ("tc", "v1"):
        got[route] = _flash_run(q, k, v, g, args, v1=route == "v1")
        again = _flash_run(q, k, v, g, args, v1=route == "v1")
        torch.cuda.synchronize()
        for name, a, b in zip(_FLASH_NAMES, got[route], again):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"flash kernels ({route}) are not deterministic: {name} "
                    f"differs between two runs ({bh}, {t}, {d}, {dtype}, "
                    f"rate {rate})")
        del again
        err = {n: _max_abs_err(a, b)
               for n, a, b in zip(_FLASH_NAMES, got[route], ref)}
        out[route] = (err, {n: err[n] / top[n] for n in _FLASH_NAMES})
    err = {n: _max_abs_err(a, b)
           for n, a, b in zip(_FLASH_NAMES, got["tc"], got["v1"])}
    out["v1 - tc"] = (err, {n: err[n] / top[n] for n in _FLASH_NAMES})
    return out


def _flash_bad(dtype, err, rel):
    """The names over the limits: float32 O and lse 1e-5 absolute, dq, dk
    and dv 1e-4 of their largest magnitude; bfloat16 O 2e-2."""
    import torch
    if dtype == torch.float32:
        return [n for n in ("o", "lse") if err[n] > 1e-5] + [
            n for n in ("dq", "dk", "dv") if rel[n] > 1e-4]
    return [n for n in ("o",) if err[n] > 2e-2]


def phase_flash_parity(dev, errs):
    import torch
    bh, t, d = FLASH_SHAPE
    cases = [("f32", bh, t, d, torch.float32, 0.0),
             ("f32", bh, t, d, torch.float32, FLASH_RATE),
             ("f32", *FLASH_SHAPE_CLIENT, torch.float32, FLASH_RATE),
             ("bf16", bh, t, d, torch.bfloat16, FLASH_RATE),
             ("f32", 24, 1100, 128, torch.float32, FLASH_RATE)]
    errs.update(flash_fwd=0.0, flash_bwd_dq=0.0, flash_bwd_dkv=0.0,
                flash_fwd_v1=0.0, flash_bwd_dq_v1=0.0, flash_bwd_dkv_v1=0.0)
    for i, (tag, bh_, t_, d_, dtype, rate) in enumerate(cases):
        res = _flash_check(dev, bh_, t_, d_, dtype, rate, seed=i)
        for route, (err, rel) in res.items():
            how = ("the routes against each other" if route == "v1 - tc"
                   else "bitwise equal over 2 runs")
            print(f"parity flash {route} ({tag}, BH={bh_}, T={t_}, D={d_}, "
                  f"rate {rate}): {how}; max abs err O "
                  f"{err['o']:.3e}, lse {err['lse']:.3e}; relative to max "
                  f"|.|: dq {rel['dq']:.3e}, dk {rel['dk']:.3e}, dv "
                  f"{rel['dv']:.3e}", flush=True)
            bad = _flash_bad(dtype, err, rel)
            if bad:
                raise AssertionError(
                    f"flash kernels ({route}) disagree ({tag}, T={t_}, "
                    f"D={d_}, rate {rate}) in {bad}: {err} / {rel}")
        if dtype == torch.float32 and (t_, d_) == (t, d):
            for suffix, route in (("", "tc"), ("_v1", "v1")):
                err = res[route][0]
                errs["flash_fwd" + suffix] = max(errs["flash_fwd" + suffix],
                                                 err["o"])
                errs["flash_bwd_dq" + suffix] = max(
                    errs["flash_bwd_dq" + suffix], err["dq"])
                errs["flash_bwd_dkv" + suffix] = max(
                    errs["flash_bwd_dkv" + suffix], err["dk"], err["dv"])


def _flash_cost(kind, bh, t, d):
    """The least time for one kernel at (bh, t, d) float32, two ways:
    ``{"tensor_cores": (ms, by), "cuda_cores": (ms, by)}``. Each input is
    read once and each output written once; the causal products' flops
    (forward 2 T^2 D BH, dq 1.5x, dkv 2x) run either in 3xTF32 on the
    tensor cores (3 products at 495 TFLOP/s, the least time for float32
    accuracy) or in float32 on the CUDA cores (67 TFLOP/s)."""
    tensor, row = 4 * bh * t * d, 4 * bh * t
    flops = 2 * t * t * d * bh
    nbytes, ops = {
        "fwd": (4 * tensor + row, flops),          # q, k, v -> O, lse
        "dq": (5 * tensor + 2 * row, 1.5 * flops),  # q, k, v, dO, lse, delta
        "dkv": (6 * tensor + 2 * row, 2 * flops),   # ... -> dk, dv
    }[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * ops / TF32_OPS_PER_S * 1e3
    tc = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return {"tensor_cores": tc, "cuda_cores": _bound(nbytes, ops)}


def phase_flash_timing(dev, pairs=20):
    """The flash kernels at the GPT2 path's shape: the tensor-core
    forward, dq and dk/dv against the first port's scalar ones and SDPA's
    forward and backward, and the port's whole backward (delta, dq, dk/dv)
    against SDPA's, as ``pairs`` alternating rounds (each side the median
    of 25 CUDA-event timings); the plain versions timed once."""
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
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
    out = sdpa(*leaves)
    bwd_in = (q, k, v, g, lse, delta)

    def port_bwd():
        # as _Flash.backward: delta, then dq, then dk/dv
        dl = torch.sum(g * o, dim=-1)
        fa.flash_bwd_dq(q, k, v, g, lse, dl, *args)
        fa.flash_bwd_dkv(q, k, v, g, lse, dl, *args)
    ms = _alternate({
        "fwd": lambda: fa.flash_fwd(q, k, v, *args),
        "fwd_v1": lambda: fa.flash_fwd_v1(q, k, v, *args),
        "dq": lambda: fa.flash_bwd_dq(*bwd_in, *args),
        "dq_v1": lambda: fa.flash_bwd_dq_v1(*bwd_in, *args),
        "dkv": lambda: fa.flash_bwd_dkv(*bwd_in, *args),
        "dkv_v1": lambda: fa.flash_bwd_dkv_v1(*bwd_in, *args),
        "bwd": port_bwd,
        "sdpa_fwd": lambda: sdpa(q4, k4, v4),
        "sdpa_bwd": lambda: torch.autograd.grad(out, leaves, g4,
                                                retain_graph=True),
    }, pairs)
    med = {name: float(np.median(x)) for name, x in ms.items()}
    plain_fwd = _time_ms(lambda: fa.flash_fwd_plain(q, k, v, *args))
    plain_bwd = _time_ms(lambda: fa.flash_bwd_plain(q, k, v, g, *args))
    at = f"BH={bh}, T={t}, D={d}, f32, rate {FLASH_RATE}"

    def row(ms_, plain_ms, library_ms, kind, route):
        cost = _flash_cost(kind, bh, t, d)
        return dict(ms=ms_, plain_ms=plain_ms, library_ms=library_ms,
                    cost=cost["tensor_cores"], at=at, flash_route=route,
                    bound_cuda_cores_ms=cost["cuda_cores"][0])
    tc, v1 = "tensor cores, 3xTF32", "CUDA cores, scalar FMA"
    rows = {
        "flash_fwd": row(med["fwd"], plain_fwd, med["sdpa_fwd"], "fwd", tc),
        "flash_fwd_v1": row(med["fwd_v1"], plain_fwd, med["sdpa_fwd"],
                            "fwd", v1),
        "flash_bwd_dq": row(med["dq"], plain_bwd, med["sdpa_bwd"], "dq",
                            tc),
        "flash_bwd_dq_v1": row(med["dq_v1"], plain_bwd, med["sdpa_bwd"],
                               "dq", v1),
        "flash_bwd_dkv": row(med["dkv"], plain_bwd, med["sdpa_bwd"], "dkv",
                             tc),
        "flash_bwd_dkv_v1": row(med["dkv_v1"], plain_bwd, med["sdpa_bwd"],
                                "dkv", v1),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name} ({at}; {r['flash_route']}): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {bound_ms:.5f} ms ({kind}; "
              f"3xTF32 on the tensor cores), {r['bound_cuda_cores_ms']:.5f} "
              f"ms on the CUDA cores", flush=True)
    for new, old, lib in (("fwd", "fwd_v1", "sdpa_fwd"),
                          ("dq", "dq_v1", "sdpa_bwd"),
                          ("dkv", "dkv_v1", "sdpa_bwd")):
        ratio = [a / b for a, b in zip(ms[old], ms[new])]
        print(f"time flash {new} ({pairs} alternating rounds): tensor cores "
              f"{med[new]:.4f} ms, v1 {med[old]:.4f} ms (v1 / new: median "
              f"{float(np.median(ratio)):.3f}, min {min(ratio):.3f}, max "
              f"{max(ratio):.3f}), {lib} {med[lib]:.4f} ms", flush=True)
    ratio = [a / b for a, b in zip(ms["sdpa_bwd"], ms["bwd"])]
    print(f"time flash backward ({pairs} alternating rounds): delta + dq + "
          f"dk/dv {med['bwd']:.4f} ms, SDPA's backward {med['sdpa_bwd']:.4f}"
          f" ms (SDPA / port: median {float(np.median(ratio)):.3f}, min "
          f"{min(ratio):.3f}, max {max(ratio):.3f})", flush=True)
    print("  rounds: " + ", ".join(
        f"{name} {[round(x, 4) for x in v]}" for name, v in ms.items()),
          flush=True)
    print("  library: flash_fwd = scaled_dot_product_attention(is_causal, "
          f"dropout_p={FLASH_RATE}) forward; flash_bwd_dq, flash_bwd_dkv = "
          "its whole autograd backward (dq, dk, dv together); plain ms of "
          "the backward rows = the plain forward's autograd (dq, dk, dv "
          "together)", flush=True)
    return rows


# kernel classes of the round's device-time breakdown, by name substring
_KERNEL_CLASSES = (
    ("flash attention (B5-B7)", ("fwd_kernel", "dq_kernel", "dkv_kernel",
                                 "fwd_v1_kernel", "dq_v1_kernel",
                                 "dkv_v1_kernel")),
    ("hardware-RNG dropout (B8)", ("hw_dropout_kernel",)),
    ("sketch and top-k (B1-B3)", ("sketch_kernel", "count_kernel",
                                  "select_kernel", "tie_count_kernel",
                                  "exclusive_scan_kernel", "est_hist_kernel",
                                  "digit_hist_kernel", "rows_hist_kernel",
                                  "segment_sum_kernel")),
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


def phase_repeat_gpt2(tmpdir):
    """Reproducibility of the GPT2 path (ROADMAP C5b): two runs of 3
    rounds through ``training.gpt2.train`` with ``GPT2_FLAGS`` from the
    same seed must give bitwise equal per-round losses, weights,
    Vvelocity and Verror. The first run is freed before the second."""
    import torch

    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    runs = []
    for _ in range(2):
        args = build_gpt2_parser().parse_args(GPT2_FLAGS + [
            "--dataset_dir", tmpdir])
        np.random.seed(args.seed)
        learner, row = train(args, max_rounds=3, log=False)
        s = learner.state
        runs.append(([r["loss"] for r in row["rounds"]],
                     s.weights.clone(), s.opt.Vvelocity.clone(),
                     s.opt.Verror.clone()))
        del learner, row, s
        torch.cuda.empty_cache()
    (la, *ta), (lb, *tb) = runs
    same = [_same_bits(a, b) for a, b in zip(ta, tb)]
    if [x.hex() for x in la] != [x.hex() for x in lb] or not all(same):
        raise AssertionError(f"the gpt2 path is not reproducible: losses "
                             f"{la} vs {lb}; weights, Vvelocity, Verror "
                             f"bitwise equal: {same}")
    print(f"repeat gpt2 (3 rounds twice, same seed, d = {ta[0].numel()}): "
          f"losses {[round(v, 6) for v in la]}, losses, weights, Vvelocity "
          f"and Verror bitwise equal", flush=True)
    del runs, ta, tb
    torch.cuda.empty_cache()


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
    "flash_fwd_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                     "commefficient_tpu/ops/flash_attention.py:183"),
    "flash_bwd_dq_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                        "commefficient_tpu/ops/flash_attention.py:303"),
    "flash_bwd_dkv_v1": ("commefficient_tpu_torch/csrc/flash_attention.cu",
                         "commefficient_tpu/ops/flash_attention.py:356"),
    "sketch_batched": ("commefficient_tpu_torch/csrc/sketch.cu",
                       "commefficient_tpu/ops/sketch_kernels.py:285 "
                       "(batched grid :381)"),
    "estimates_batched": ("commefficient_tpu_torch/csrc/estimates.cu",
                          "commefficient_tpu/ops/sketch_kernels.py:183 "
                          "(batched grid :248)"),
    "hw_dropout": ("commefficient_tpu_torch/csrc/hw_dropout.cu",
                   "commefficient_tpu/ops/dropout.py:121"),
    "est_hist": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                 "commefficient_tpu/ops/topk_kernels.py:200"),
    "digit_hist": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                   "commefficient_tpu/ops/topk_kernels.py:200"),
    "radix_compact": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                      "commefficient_tpu/ops/topk_kernels.py:355"),
    "radix_select": ("commefficient_tpu_torch/csrc/unsketch_radix.cu",
                     "commefficient_tpu/ops/topk_kernels.py:355"),
    "rows_hist": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                  "commefficient_tpu/ops/topk_kernels.py:200"),
    "rows_select": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                    "commefficient_tpu/ops/topk_kernels.py:355"),
    "rows_resid": ("commefficient_tpu_torch/csrc/topk_radix.cu",
                   "commefficient_tpu/ops/topk_kernels.py:355"),
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
    phase_parity_radix(dev, cs, table, errs)
    rows_inputs = phase_parity_rows(dev, errs)
    phase_server_ab(dev, cs, table)
    phase_sketch_sparse(dev, cs, table)
    times = phase_timing(cs, vec, table)
    times.update(phase_timing_stream(cs, table, inputs))
    times.update(phase_timing_rows(rows_inputs))
    del rows_inputs
    times.update(phase_timing_radix(cs, table))
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
    phase_repeat(dev)
    phase_reference(dev)
    phase_flash_parity(dev, errs)
    times.update(phase_flash_timing(dev))
    phase_hw_dropout_parity(dev, errs)
    times["hw_dropout"] = phase_hw_dropout_timing(dev)
    # the sketch-mode kernels again at the GPT2 path's d (timed apart: the
    # kernel line keeps ResNet9's d)
    cs, vec, table = phase_parity(dev, D_GPT2, errs)
    phase_parity_radix(dev, cs, table, errs)
    phase_server_ab(dev, cs, table)
    phase_timing(cs, vec, table, plain_reps=3)
    phase_timing_radix(cs, table)
    del cs, vec, table
    phase_timing_rows_b1(dev, D_GPT2)
    cs, vecs = phase_parity_batched(dev, D_GPT2, GPT2_WORKERS, errs)
    phase_timing_batched(cs, vecs, plain_reps=3)
    del cs, vecs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        for name in GPT2_PATHS:
            for kernel, n in phase_gpt2_path(tmpdir, name,
                                             profile=True).items():
                launches[kernel] = launches.get(kernel, 0) + n
        phase_repeat_gpt2(tmpdir)
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
            "at": r.get("at", f"d={D_RESNET9}"),
            **{key: r[key] for key in ("flash_route", "bound_cuda_cores_ms",
                                       "device_ms") if key in r}})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
