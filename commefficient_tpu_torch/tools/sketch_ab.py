"""Time the 1-D sketch and estimates kernels of another checkout against
this one's.

    python -m commefficient_tpu_torch.tools.sketch_ab --parent DIR \
        [--pairs N] [--kernels sketch,estimates]

Builds ``csrc/sketch.cu`` and ``csrc/estimates.cu`` of both checkouts
(``DIR`` is the root of the other one) with the same ``nvcc`` flags, at
once, and prints each build's register counts. Then, for each kernel at
ResNet9's d = 6,568,640 and GPT2-small's d = 124,051,201 (a 5 x 500,096
table, as ``chip_smoke.py``; the sketch of a seeded vector, the estimates
of a seeded table): both kernels' outputs must be bitwise equal, and N
pairs of timings (each the median of 25 CUDA-event timings) alternate
other/this, this/other, ... in one process, so drift within the call
falls on both sides alike. Prints the medians of both sides and of the
per-pair ratio this/other, one JSON line per (kernel, d), and the card's
name and power limit. Needs one card; exits 1 without it.

Each kernel's unbatched and batched C interfaces are accepted, read from
the source: ``sketch_launch(x, n, block_offset, ...)`` or ``(x, nrows, n,
block_offset, ...)``, ``estimates_launch(table, d, ...)`` or ``(table, B,
d, ...)``; a batched one is launched with one row.
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
_BATCHED_ESTIMATES = re.compile(r'extern "C" int estimates_launch\(const '
                                r'void\* table, int B')
#: kernel -> the regex that finds its batched C interface in the source
_INTERFACES = {"sketch": _BATCHED, "estimates": _BATCHED_ESTIMATES}
REPS = 25
DS = (6_568_640, 124_051_201)


def _build(root: Path, out_dir: Path, kernel: str, tag: str):
    """Start ``nvcc`` on ``root``'s ``{kernel}.cu``; ``(proc, lib path,
    batched interface?)``."""
    csrc = root / "commefficient_tpu_torch" / "csrc"
    src = csrc / f"{kernel}.cu"
    lib = out_dir / f"lib{kernel}_{tag}.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib, bool(_INTERFACES[kernel].search(src.read_text()))


def _launcher(lib_path: Path, kernel: str, batched: bool, cs, inp, out):
    """A no-argument function launching ``lib_path``'s unbatched
    ``kernel`` of ``inp`` into ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    tabs = cs.kernel_tables(inp.device)
    stream = cuda_lib.stream_ptr(inp.device)
    if kernel == "sketch":
        fn = lib.sketch_launch
        head = [_P, _I, _LL, _LL] if batched else [_P, _LL, _LL]
        fn.argtypes = head + [_P, _P, _P, _I, _I, _I, _P, _P]
        n = inp.shape[0]
        args = ((inp.data_ptr(), 1, n) if batched else (inp.data_ptr(), n)) \
            + (0, tabs.win_ptr.data_ptr(), tabs.win_blocks.data_ptr(),
               tabs.coeffs.data_ptr(), cs.r, cs.nwindows, cs.nblocks,
               out.data_ptr(), stream)
    else:
        fn = lib.estimates_launch
        head = [_P, _I, _LL] if batched else [_P, _LL]
        fn.argtypes = head + [_I, _I, _P, _P, _P]
        args = ((inp.data_ptr(), 1, cs.d) if batched
                else (inp.data_ptr(), cs.d)) \
            + (cs.r, cs.nwindows, tabs.coeffs.data_ptr(), out.data_ptr(),
               stream)
    fn.restype = _I

    def launch():
        cuda_lib.check(fn(*args), lib_path.name)
    return launch


def _time_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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


def _inputs(kernel: str, cs, dev):
    """The seeded input and an output buffer of ``kernel`` at ``cs.d``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "sketch":
        return (torch.randn(cs.d, generator=gen, device=dev),
                lambda: torch.empty((cs.r, cs.c_eff), device=dev))
    return (torch.randn(cs.r, cs.c_eff, generator=gen, device=dev),
            lambda: torch.empty(cs.d, device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--kernels", default="sketch,estimates",
                    help="comma-separated: sketch, estimates")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(_INTERFACES):
        ap.error(f"--kernels: choose from {sorted(_INTERFACES)}")
    import torch

    from commefficient_tpu_torch.ops.countsketch import CountSketch
    if not torch.cuda.is_available():
        print("sketch_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    here = Path(cuda_lib.__file__).resolve().parents[2]
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        builds = {(kernel, tag): _build(root, Path(tmp), kernel, tag)
                  for kernel in kernels for tag, root in
                  (("other", args.parent.resolve()), ("this", here))}
        for (kernel, tag), (proc, _, batched) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {kernel} ({tag}) failed:\n{log}")
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"build {kernel} {tag} (batched interface: {batched}): "
                  + " | ".join(regs), flush=True)
        for kernel in kernels:
            for d in DS:
                cs = CountSketch(d, 500_000, 5, seed=42)
                inp, new_out = _inputs(kernel, cs, dev)
                outs = {t: new_out() for t in ("other", "this")}
                fns = {t: _launcher(builds[kernel, t][1], kernel,
                                    builds[kernel, t][2], cs, inp, outs[t])
                       for t in outs}
                for fn in fns.values():
                    fn()
                torch.cuda.synchronize()
                if not torch.equal(outs["this"].view(torch.int32),
                                   outs["other"].view(torch.int32)):
                    raise AssertionError(f"the two {kernel} kernels' outputs "
                                         f"differ at d={d}")
                ms = {t: [] for t in fns}
                for i in range(args.pairs):
                    order = ("other", "this") if i % 2 == 0 else ("this",
                                                                 "other")
                    for t in order:
                        ms[t].append(_time_ms(fns[t]))
                ratios = [a / b for a, b in zip(ms["this"], ms["other"])]
                row = {"kernel": kernel, "d": d, "pairs": args.pairs,
                       "bitwise_equal": True,
                       "this_ms_median": _median(ms["this"]),
                       "other_ms_median": _median(ms["other"]),
                       "ratio_median": _median(ratios),
                       "ratio_min": min(ratios), "ratio_max": max(ratios),
                       "this_ms": ms["this"], "other_ms": ms["other"]}
                print(json.dumps(row), flush=True)
                del inp, outs, fns
                torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
