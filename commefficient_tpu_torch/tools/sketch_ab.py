"""Time the 1-D sketch kernel of another checkout against this one's.

    python -m commefficient_tpu_torch.tools.sketch_ab --parent DIR [--pairs N]

Builds ``csrc/sketch.cu`` of both checkouts (``DIR`` is the root of the
other one) with the same ``nvcc`` flags, at once, and prints each build's
register count. Then, at ResNet9's d = 6,568,640 and GPT2-small's d =
124,051,201 (a seeded vector into a 5 x 500,096 table, as
``chip_smoke.py``): both kernels' tables must be bitwise equal, and N
pairs of timings (each the median of 25 CUDA-event timings) alternate
other/this, this/other, ... in one process, so drift within the call
falls on both sides alike. Prints the medians of both sides and of the
per-pair ratio this/other, one JSON line per d, and the card's name and
power limit. Needs one card; exits 1 without it.

Both ``sketch_launch`` interfaces are accepted: the unbatched one ``(x, n,
block_offset, ...)`` and the batched one ``(x, nrows, n, block_offset,
...)``, read from the source.
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
REPS = 25
DS = (6_568_640, 124_051_201)


def _build(root: Path, out_dir: Path, tag: str):
    """Start ``nvcc`` on ``root``'s sketch.cu; ``(proc, lib path, batched
    interface?)``."""
    csrc = root / "commefficient_tpu_torch" / "csrc"
    src = csrc / "sketch.cu"
    lib = out_dir / f"libsketch_{tag}.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib, bool(_BATCHED.search(src.read_text()))


def _launcher(lib_path: Path, batched: bool, cs, vec, out):
    """A no-argument function launching ``lib_path``'s 1-D sketch of
    ``vec`` into ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.sketch_launch
    fn.restype = _I
    head = [_P, _I, _LL, _LL] if batched else [_P, _LL, _LL]
    fn.argtypes = head + [_P, _P, _P, _I, _I, _I, _P, _P]
    tabs = cs.kernel_tables(vec.device)
    n = vec.shape[0]
    size = (1, n) if batched else (n,)
    rest = (0, tabs.win_ptr.data_ptr(), tabs.win_blocks.data_ptr(),
            tabs.coeffs.data_ptr(), cs.r, cs.nwindows, cs.nblocks,
            out.data_ptr(), cuda_lib.stream_ptr(vec.device))

    def launch():
        cuda_lib.check(fn(vec.data_ptr(), *size, *rest), lib_path.name)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=20)
    args = ap.parse_args(argv)
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
        builds = {tag: _build(root, Path(tmp), tag) for tag, root in
                  (("other", args.parent.resolve()), ("this", here))}
        for tag, (proc, _, batched) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc ({tag}) failed:\n{log}")
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln]
            print(f"build {tag} (batched interface: {batched}): "
                  + " | ".join(regs), flush=True)
        for d in DS:
            cs = CountSketch(d, 500_000, 5, seed=42)
            gen = torch.Generator(device=dev).manual_seed(0)
            vec = torch.randn(d, generator=gen, device=dev)
            outs = {t: torch.empty((cs.r, cs.c_eff), device=dev)
                    for t in builds}
            fns = {t: _launcher(lib, batched, cs, vec, outs[t])
                   for t, (_, lib, batched) in builds.items()}
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            if not torch.equal(outs["this"].view(torch.int32),
                               outs["other"].view(torch.int32)):
                raise AssertionError(f"the two kernels' tables differ at "
                                     f"d={d}")
            ms = {t: [] for t in fns}
            for i in range(args.pairs):
                order = ("other", "this") if i % 2 == 0 else ("this",
                                                             "other")
                for t in order:
                    ms[t].append(_time_ms(fns[t]))
            ratios = [a / b for a, b in zip(ms["this"], ms["other"])]
            row = {"d": d, "pairs": args.pairs, "bitwise_equal": True,
                   "this_ms_median": _median(ms["this"]),
                   "other_ms_median": _median(ms["other"]),
                   "ratio_median": _median(ratios),
                   "ratio_min": min(ratios), "ratio_max": max(ratios),
                   "this_ms": ms["this"], "other_ms": ms["other"]}
            print(json.dumps(row), flush=True)
            del vec, outs, fns
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
