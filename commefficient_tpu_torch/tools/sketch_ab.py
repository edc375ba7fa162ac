"""Time the CountSketch kernels of another checkout against this one's.

    python -m commefficient_tpu_torch.tools.sketch_ab --parent DIR \
        [--pairs N] [--kernels sketch,sketch_batched,estimates,est_hist]

Builds ``csrc/sketch.cu``, ``csrc/estimates.cu`` and
``csrc/unsketch_radix.cu`` of both checkouts (``DIR`` is the root of the
other one) with the same ``nvcc`` flags, at once, and prints each build's
register counts. Then, for each case (a 5 x 500,096 table, as
``chip_smoke.py``, at ResNet9's d = 6,568,640 and GPT2-small's d =
124,051,201):

- ``sketch``: the 1-D sketch of a seeded vector at both d;
- ``sketch_batched``: the sketch of a seeded (8, 6,568,640) and (4,
  124,051,201) batch, the batches of sketch_clip and gpt2_clip;
- ``estimates``: the estimates of a seeded table at batch 1, at both d;
- ``est_hist``: the estimate-once radix's first pass (the estimates
  stored, the first digit's histogram) at k = 50,000, its workspace
  zeroed before each call, outside the timing;

every side's outputs must be bitwise equal, and N pairs of timings (each
the median of 25 CUDA-event timings of one call) alternate other/this,
this/other, ... in one process, so drift within the call falls on both
sides alike. Prints one JSON line per case (each side's median, the
median of the per-pair ratio this/other and the pairs in which this side
was faster), then the card's name and power limit. Needs one card; exits
1 without it.

Each C interface the sketch and estimates kernels have had is accepted,
read from the source, and each side gets the tables it expects:
``sketch_launch(x, n, block_offset, win_ptr, win_blocks, ...)`` (one
row), ``(x, nrows, n, block_offset, win_ptr, win_blocks, ...)`` (block
ids grouped by window) or ``(x, nrows, n, block_offset, win_ptr, packed,
...)`` (each block id packed with its lane mask);
``estimates_launch(table, d, ...)`` or ``(table, B, d, ...)``. A one-row
sketch interface runs a batch row by row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from commefficient_tpu_torch.ops import cuda_lib

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_BATCHED = re.compile(r'extern "C" int sketch_launch\(const void\* x, int '
                      r'nrows')
_PACKED = re.compile(r'extern "C" int sketch_launch\([^)]*const void\* '
                     r'packed')
_BATCHED_ESTIMATES = re.compile(r'extern "C" int estimates_launch\(const '
                                r'void\* table, int B')
#: source -> {interface: the regex that finds it in the source}
_INTERFACES = {"sketch": {"batched": _BATCHED, "packed": _PACKED},
               "estimates": {"batched": _BATCHED_ESTIMATES},
               "unsketch_radix": {}}
#: case -> the source its kernel is built from
_SOURCE = {"sketch": "sketch", "sketch_batched": "sketch",
           "estimates": "estimates", "est_hist": "unsketch_radix"}
REPS = 25
DS = (6_568_640, 124_051_201)
#: the per-worker sketch's batches: sketch_clip's 8 clients at ResNet9's
#: d, gpt2_clip's 4 at GPT2's
BATCHES = ((8, 6_568_640), (4, 124_051_201))
K = 50_000


def _build(root: Path, out_dir: Path, source: str, tag: str):
    """Start ``nvcc`` on ``root``'s ``{source}.cu``; ``(proc, lib path,
    {interface: found?})``."""
    csrc = root / "commefficient_tpu_torch" / "csrc"
    src = csrc / f"{source}.cu"
    lib = out_dir / f"lib{source}_{tag}.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    text = src.read_text()
    return proc, lib, {name: bool(rx.search(text))
                       for name, rx in _INTERFACES[source].items()}


def block_ids(tabs):
    """The block-id interfaces' lists from this checkout's packed ones:
    the same window lists without the lane masks."""
    import torch
    return ((tabs.packed.long() & 0xFFFFFFFF) >> 7).to(torch.int32)


def _sketch_launcher(lib, iface, cs, x, out):
    """A no-argument function sketching the (B, n) batch ``x`` into
    ``out`` (B, r, c_eff) through ``lib`` with the interface ``iface``."""
    B, n = x.shape
    stream = cuda_lib.stream_ptr(x.device)
    tabs = cs.kernel_tables(x.device)
    lists = tabs.packed if iface["packed"] else block_ids(tabs)
    tables = (0, tabs.win_ptr.data_ptr(), lists.data_ptr(),
              tabs.coeffs.data_ptr(), cs.r, cs.nwindows, cs.nblocks)
    fn = lib.sketch_launch
    fn.restype = _I
    if iface["batched"]:
        fn.argtypes = [_P, _I, _LL, _LL, _P, _P, _P, _I, _I, _I, _P, _P]
        calls = [(x.data_ptr(), B, n) + tables + (out.data_ptr(), stream)]
    else:
        fn.argtypes = [_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P, _P]
        calls = [(x[b].data_ptr(), n) + tables + (out[b].data_ptr(), stream)
                 for b in range(B)]

    def launch(keep=(tabs, lists)):
        for args in calls:
            cuda_lib.check(fn(*args), "sketch_launch")
    return launch


def _estimates_launcher(lib, iface, cs, table, out):
    """A no-argument function writing the (d,) estimates of ``table``
    into ``out``."""
    tabs = cs.kernel_tables(table.device)
    fn = lib.estimates_launch
    fn.restype = _I
    head = [_P, _I, _LL] if iface["batched"] else [_P, _LL]
    fn.argtypes = head + [_I, _I, _P, _P, _P]
    args = ((table.data_ptr(), 1, cs.d) if iface["batched"]
            else (table.data_ptr(), cs.d)) + (
        cs.r, cs.nwindows, tabs.coeffs.data_ptr(), out.data_ptr(),
        cuda_lib.stream_ptr(table.device))

    def launch(tabs=tabs):
        cuda_lib.check(fn(*args), "estimates_launch")
    return launch


def _est_hist_launcher(lib, cs, table, est, ws):
    """A no-argument function running the radix's first pass of ``table``
    into the scratch ``est`` and the workspace ``ws``."""
    tabs = cs.kernel_tables(table.device)
    fn = lib.est_hist_launch
    fn.restype = _I
    fn.argtypes = [_P, _LL, _I, _I, _P, _LL, _P, _P, _P]
    args = (table.data_ptr(), cs.d, cs.r, cs.nwindows,
            tabs.coeffs.data_ptr(), K, est.data_ptr(), ws.data_ptr(),
            cuda_lib.stream_ptr(table.device))

    def launch(tabs=tabs):
        cuda_lib.check(fn(*args), "est_hist_launch")
    return launch


def _time_ms(fn, setup=None) -> float:
    import torch
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[REPS // 2]


def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2


def _cases(kernel: str, dev, libs):
    """Yield ``(label, {side: (launch, setup or None)}, {side: outputs})``
    for ``kernel``; ``libs[side] = (library, interface)``."""
    import torch

    from commefficient_tpu_torch.ops import topk_kernels as tk
    from commefficient_tpu_torch.ops.countsketch import CountSketch
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel in ("sketch", "sketch_batched"):
        shapes = ([(1, d) for d in DS] if kernel == "sketch"
                  else list(BATCHES))
        for B, d in shapes:
            cs = CountSketch(d, 500_000, 5, seed=42)
            x = torch.randn(B, d, generator=gen, device=dev)
            fns, outs = {}, {}
            for t, (lib, iface) in libs.items():
                outs[t] = torch.empty((B, cs.r, cs.c_eff), device=dev)
                fns[t] = (_sketch_launcher(lib, iface, cs, x, outs[t]), None)
            yield f"B={B}, d={d}", fns, outs
    elif kernel == "estimates":
        for d in DS:
            cs = CountSketch(d, 500_000, 5, seed=42)
            table = torch.randn(cs.r, cs.c_eff, generator=gen, device=dev)
            outs = {t: torch.empty(cs.d, device=dev) for t in libs}
            fns = {t: (_estimates_launcher(lib, iface, cs, table, outs[t]),
                       None) for t, (lib, iface) in libs.items()}
            yield f"B=1, d={d}", fns, outs
    else:
        for d in DS:
            cs = CountSketch(d, 500_000, 5, seed=42)
            table = torch.randn(cs.r, cs.c_eff, generator=gen, device=dev)
            fns, outs = {}, {}
            for t, (lib, _) in libs.items():
                est, ws = tk.radix_workspace(cs.d, dev)
                outs[t] = (est[:cs.d], ws)
                fns[t] = (_est_hist_launcher(lib, cs, table, est, ws),
                          ws.zero_)
            yield f"d={d}, k={K}", fns, outs


def _same(a, b) -> bool:
    import torch
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--kernels",
                    default="sketch,sketch_batched,estimates,est_hist",
                    help="comma-separated: " + ", ".join(_SOURCE))
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(_SOURCE):
        ap.error(f"--kernels: choose from {sorted(_SOURCE)}")
    import torch

    if not torch.cuda.is_available():
        print("sketch_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    here = Path(cuda_lib.__file__).resolve().parents[2]
    dev = torch.device("cuda")
    sources = sorted({_SOURCE[k] for k in kernels})
    with tempfile.TemporaryDirectory() as tmp:
        builds = {(src, tag): _build(root, Path(tmp), src, tag)
                  for src in sources for tag, root in
                  (("other", args.parent.resolve()), ("this", here))}
        libs = {}
        for (src, tag), (proc, path, iface) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {src} ({tag}) failed:\n{log}")
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"build {src} {tag} (interfaces {iface}): "
                  + " | ".join(regs), flush=True)
            libs[src, tag] = (ctypes.CDLL(str(path)), iface)
        for kernel in kernels:
            side_libs = {t: libs[_SOURCE[kernel], t]
                         for t in ("other", "this")}
            for label, fns, outs in _cases(kernel, dev, side_libs):
                for launch, setup in fns.values():
                    if setup:
                        setup()
                    launch()
                torch.cuda.synchronize()
                for t in outs:
                    if not _same(outs[t], outs["other"]):
                        raise AssertionError(f"{kernel} ({label}): {t}'s "
                                             "outputs differ from other's")
                ms = {t: [] for t in fns}
                for i in range(args.pairs):
                    order = list(fns) if i % 2 == 0 else list(fns)[::-1]
                    for t in order:
                        ms[t].append(_time_ms(*fns[t]))
                ratios = [a / b for a, b in zip(ms["this"], ms["other"])]
                row = {"kernel": kernel, "at": label, "pairs": args.pairs,
                       "bitwise_equal": True,
                       **{f"{t}_ms_median": _median(v)
                          for t, v in ms.items()},
                       "ratio_median": _median(ratios),
                       "ratio_min": min(ratios), "ratio_max": max(ratios),
                       "this_faster_pairs": sum(r < 1 for r in ratios),
                       **{f"{t}_ms": v for t, v in ms.items()}}
                print(json.dumps(row), flush=True)
                del fns, outs
                torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
