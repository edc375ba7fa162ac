#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (commefficient_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from csrc/ (one nvcc per source, all at once), timed;
2. kernel parity at full width: a seeded (6,568,640,) vector sketched
   into a 5 x 500,096 table (twice: the kernel is deterministic), then the
   fused unsketch + top-k at k=50,000, and a table with planted ties;
   every kernel must equal its plain PyTorch version bitwise;
3. kernel times with CUDA events (median of 25), beside the plain
   versions, one PyTorch library call for the same work, and the bound
   computed from this run's bytes and operations;
4. the main path: ``training.cv.train(args, max_rounds=3)`` at the
   headline FetchSGD flags (sketch mode, 5 x 500k, k=50k, virtual error,
   virtual momentum 0.9, ResNet9, 8 workers x 32 images, Synthetic) on
   CUDA, with every launch counter set to 0 just before it and read just
   after: sketch 3, count 27, select 3;
5. a reference check on a small input: two rounds of a narrow ResNet9
   learner on CUDA (kernels) and on the CPU (plain versions) from the same
   weights and batches must agree.

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

import numpy as np

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--virtual_momentum", "0.9", "--num_workers", "8",
            "--local_batch_size", "32", "--k", "50000", "--num_rows", "5",
            "--num_cols", "500000", "--dataset_name", "Synthetic",
            "--device", "cuda"]
D_RESNET9 = 6_568_640
K = 50_000
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


def phase_main_path():
    import torch

    from commefficient_tpu_torch.ops import cuda_lib
    from commefficient_tpu_torch.training.args import build_parser
    from commefficient_tpu_torch.training.cv import train
    args = build_parser().parse_args(HEADLINE)
    np.random.seed(args.seed)
    cuda_lib.LAUNCHES.clear()
    learner, row = train(args, max_rounds=3)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    want = {"sketch": 3, "count": 27, "select": 3}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    rounds = row["rounds"]
    if len(rounds) != 3:
        raise AssertionError(f"ran {len(rounds)} rounds, expected 3")
    w = learner.state.weights
    if learner.cfg.grad_size != D_RESNET9 or w.shape != (D_RESNET9,):
        raise AssertionError(f"d = {learner.cfg.grad_size}")
    if not all(math.isfinite(r["loss"]) for r in rounds) \
            or not bool(torch.isfinite(w).all()) \
            or not math.isfinite(row["test_loss"]):
        raise AssertionError("non-finite loss or weights")
    # every participating client uploads one 5 x 500,096 f32 table; the
    # first round has all 8 workers (the epoch tail may have fewer)
    per_client = 4 * 5 * 500_096
    if rounds[0]["upload_bytes"] != 8 * per_client or any(
            r["upload_bytes"] % per_client for r in rounds):
        raise AssertionError("upload bytes are not 4*r*c_eff per client")
    changed = int((learner.state.last_changed >= 0).sum())
    print(f"main path: d={D_RESNET9}, losses "
          f"{[round(r['loss'], 6) for r in rounds]}, round ms "
          f"{[round(r['round_s'] * 1e3, 3) for r in rounds]}, "
          f"test_loss {row['test_loss']:.6f}, {changed} weights changed",
          flush=True)
    return launches


def phase_reference(dev):
    import torch

    from commefficient_tpu_torch.config import FedConfig
    from commefficient_tpu_torch.federated.api import FedLearner
    from commefficient_tpu_torch.federated.losses import make_cv_loss
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    ch = {"prep": 8, "layer1": 16, "layer2": 16, "layer3": 16}
    cfg = FedConfig(mode="sketch", error_type="virtual",
                    virtual_momentum=0.9, k=200, num_cols=2000, num_rows=5,
                    num_clients=10, num_workers=4)
    rng = np.random.RandomState(1)
    batches = [(rng.choice(10, 4, replace=False).astype(np.int32),
                (rng.randn(4, 8, 32, 32, 3).astype(np.float32),
                 rng.randint(0, 10, (4, 8)).astype(np.int32)),
                np.ones((4, 8), np.float32)) for _ in range(2)]
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
            raise AssertionError(f"loss cpu {a['loss']} != cuda {b['loss']}")
        if (a["download_bytes"], a["upload_bytes"]) != (
                b["download_bytes"], b["upload_bytes"]):
            raise AssertionError("byte metrics differ between cpu and cuda")
    close = torch.isclose(w_gpu, w_cpu, rtol=1e-3, atol=1e-5)
    frac = float(close.float().mean())
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4f} of weights agree")
    print(f"reference (narrow ResNet9, 2 rounds, cuda vs cpu plain): "
          f"losses {[round(m['loss'], 6) for m in m_gpu]} vs "
          f"{[round(m['loss'], 6) for m in m_cpu]}, bytes equal, "
          f"{frac:.6f} of weights within rtol 1e-3", flush=True)


SOURCES = {
    "sketch": ("commefficient_tpu_torch/csrc/sketch.cu",
               "commefficient_tpu/ops/sketch_kernels.py:285"),
    "count": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
              "commefficient_tpu/ops/topk_kernels.py:200"),
    "select": ("commefficient_tpu_torch/csrc/unsketch_topk.cu",
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
    smi = _smi()
    print(f"gpu: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    cs, vec, table, errs = phase_parity(dev)
    times = phase_timing(cs, vec, table)
    del vec, table
    torch.cuda.empty_cache()
    launches = phase_main_path()
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
            "bound_by": kind, "library_ms": r["library_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
