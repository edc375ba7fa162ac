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
   - one sketch-mode server step with --server_fused auto against off:
     update, Vvelocity and Verror bitwise equal (each step also timed);
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
   - sketch with --server_fused off: sketch 3, estimates 3;
   - uncompressed (momentum 0.9) and fedavg (2 local epochs in chunks of
     16, lr decay 0.9): no kernel;
   with finite losses and weights and exact upload bytes per client;
5. a reference check on a small input: two rounds of a narrow ResNet9
   learner on CUDA (kernels) and on the CPU (plain versions) from the same
   weights and batches must agree, in sketch, true_topk and local_topk.

The line before the last is the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    "sketch_server_fused_off": (HEADLINE + ["--server_fused", "off"],
                                {"sketch": 3, "estimates": 3},
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
# per-row k of the batched parity check: full, an all-zero row, contested
# ties at k/2, and k = 1
KK_ROWS = [K, K, K // 2, 1, K, K, K, K]
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


def _sketch_cost(cs):
    nbytes = 4 * cs.d + 4 * cs.r * cs.c_eff
    ops = cs.r * cs.d * (_OPS_SIGN + 2) + cs.r * cs.nblocks * _OPS_BLOCK
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


def phase_parity(dev):
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    from commefficient_tpu_torch.ops.sketch_kernels import (sketch_vec,
                                                            sketch_vec_plain)
    cs = CountSketch(D_RESNET9, 500_000, 5, seed=42)
    rng = np.random.RandomState(0)
    x = (rng.randn(cs.d) * 1e-3).astype(np.float32)
    hot = rng.choice(cs.d, 2 * K, replace=False)
    x[hot] += rng.randn(2 * K).astype(np.float32)
    vec = torch.from_numpy(x).to(dev)
    errs = {}

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
    errs["sketch"] = _max_abs_err(table, plain)
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
        print(f"parity unsketch_select ({name}): count, select and the "
              f"fused k={K} selection bitwise equal to plain; "
              f"threshold bits {int(t)}, ties taken {int(n_take)}",
              flush=True)
    return cs, vec, table, errs


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


def phase_timing(cs, vec, table):
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
            plain_ms=_time_ms(lambda: sketch_vec_plain(cs, vec)),
            library_ms=_time_ms(lambda: flat.index_add_(0, buckets, signed)),
            cost=_sketch_cost(cs)),
        "count": dict(
            ms=_time_ms(lambda: tk.count(cs, table, cands)),
            plain_ms=_time_ms(lambda: tk.count_plain(cs, table, cands)),
            library_ms=topk_ms, cost=_count_cost(cs)),
        "select": dict(
            ms=_time_ms(lambda: tk.select(cs, table, t, n_take)),
            plain_ms=_time_ms(lambda: tk.select_plain(cs, table, t, n_take)),
            library_ms=topk_ms, cost=_select_cost(cs)),
    }
    for name, r in rows.items():
        bound_ms, kind = r["cost"]
        print(f"time {name}: kernel {r['ms']:.4f} ms, plain "
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
            at=f"{cs.r}x{cs.c_eff} -> {cs.d}"),
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
    t_start = time.perf_counter()
    smi = _smi()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    cs, vec, table, errs = phase_parity(dev)
    inputs = phase_parity_stream(dev, cs, table, errs)
    times = phase_timing(cs, vec, table)
    times.update(phase_timing_stream(cs, table, inputs))
    del vec, table, inputs
    torch.cuda.empty_cache()
    launches = {}
    for name in PATHS:
        for kernel, n in phase_path(name).items():
            launches[kernel] = launches.get(kernel, 0) + n
    phase_reference(dev)

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = times[name]
        bound_ms, kind = r["cost"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
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
