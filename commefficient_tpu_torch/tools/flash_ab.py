"""Hold the flash kernels of another checkout against this one's.

    python -m commefficient_tpu_torch.tools.flash_ab --parent DIR \
        [--pairs N]

Builds ``csrc/flash_attention.cu`` of both checkouts (``DIR`` is the root
of the other one) with the same ``nvcc`` flags, at once, and prints each
build's register counts. Then, at the GPT2 path's shape (BH 768, T 256,
D 64, float32) at dropout rates 0 and 0.1, and at gpt2_clip's BH 192 in
bfloat16 at 0.1, it launches the three tensor-core kernels (forward, dq,
dk/dv) of both sides on the same seeded inputs: this side unsharded
(head map 0, 1, 1). Every output must be bitwise the other side's. N
pairs of timings (each the median of 25 CUDA-event timings of one call)
alternate other/this, this/other, ... in one process; one JSON line per
kernel and case (each side's median, the median this/other ratio, the
pairs in which this side was faster), then the card's name and power
limit. Needs one card; exits 1 without it.

Each C interface the kernels have had is accepted, read from the source:
the tail ``(..., int dropout, void* stream)`` or, since the head map,
``(..., int dropout, int head0, int heads_local, int heads_total, void*
stream)``.
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

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
_HEADS = re.compile(r"int heads_local")
_NPTR = {"flash_fwd_launch": 5, "flash_bwd_dq_launch": 7,
         "flash_bwd_dkv_launch": 8}
CASES = (((768, 256, 64), "float32", 0.0), ((768, 256, 64), "float32", 0.1),
         ((192, 256, 64), "bfloat16", 0.1))
REPS = 25


def _build(root: Path, out_dir: Path, tag: str):
    csrc = root / "commefficient_tpu_torch" / "csrc"
    src = csrc / "flash_attention.cu"
    lib = out_dir / f"libflash_attention_{tag}.so"
    proc = subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib, bool(_HEADS.search(src.read_text()))


def _declare(lib, heads: bool):
    tail = [_I, _I, _I, _I, _F, _I, _I, _I, _I, _U, _F, _I]
    tail += [_I, _I, _I, _P] if heads else [_P]
    for fn, n in _NPTR.items():
        getattr(lib, fn).argtypes = [_P] * n + tail
        getattr(lib, fn).restype = _I


def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else (xs[m - 1] + xs[m]) / 2


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


def _launchers(lib, heads: bool, ins: dict, outs: dict, tail: list):
    """{kernel: a no-argument launch writing into ``outs``}."""
    from commefficient_tpu_torch.ops.flash_attention import _DTYPES
    q, k, v, do, lse, delta = (ins[n] for n in ("q", "k", "v", "do", "lse",
                                                "delta"))
    bh, t, d = q.shape
    stream = cuda_lib.stream_ptr(q.device)
    end = ([0, 1, 1] if heads else []) + [stream]
    common = [bh, t, d, _DTYPES[q.dtype]] + tail + end
    p = lambda x: x.data_ptr()                      # noqa: E731
    calls = {
        "flash_fwd": (lib.flash_fwd_launch,
                      [p(q), p(k), p(v), p(outs["o"]), p(outs["lse"])]),
        "flash_bwd_dq": (lib.flash_bwd_dq_launch,
                         [p(q), p(k), p(v), p(do), p(lse), p(delta),
                          p(outs["dq"])]),
        "flash_bwd_dkv": (lib.flash_bwd_dkv_launch,
                          [p(q), p(k), p(v), p(do), p(lse), p(delta),
                           p(outs["dk"]), p(outs["dv"])]),
    }

    def make(fn, ptrs):
        def launch():
            cuda_lib.check(fn(*ptrs, *common), fn.__name__)
        return launch
    return {name: make(fn, ptrs) for name, (fn, ptrs) in calls.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from commefficient_tpu_torch.ops import flash_attention as fa
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
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
        libs = {}
        for tag, (proc, path, heads) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc flash_attention ({tag}) failed:\n"
                                   f"{log}")
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"build flash_attention {tag} (head map {heads}): "
                  + " | ".join(regs), flush=True)
            lib = ctypes.CDLL(str(path))
            _declare(lib, heads)
            libs[tag] = (lib, heads)
        gen = torch.Generator(device=dev).manual_seed(0)
        for (bh, t, d), dtype, rate in CASES:
            dt = getattr(torch, dtype)
            ins = {n: torch.randn(bh, t, d, generator=gen, device=dev)
                   .to(dt) for n in ("q", "k", "v", "do")}
            seeds = (123456789, -987654321)
            scale = 1.0 / d ** 0.5
            o, lse = fa.flash_fwd(ins["q"], ins["k"], ins["v"], seeds, scale,
                                  fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K,
                                  rate)
            ins["lse"] = lse
            ins["delta"] = torch.sum(ins["do"].float() * o.float(), dim=-1)
            tail = fa._drop_args(seeds, t, fa.DEFAULT_BLOCK_Q,
                                 fa.DEFAULT_BLOCK_K, rate, None, bh)[:7]
            tail = [scale] + tail
            outs, fns = {}, {}
            for tag, (lib, heads) in libs.items():
                outs[tag] = {
                    "o": torch.empty_like(ins["q"]),
                    "lse": torch.empty(bh, t, device=dev),
                    "dq": torch.empty_like(ins["q"]),
                    "dk": torch.empty_like(ins["q"]),
                    "dv": torch.empty_like(ins["q"])}
                fns[tag] = _launchers(lib, heads, ins, outs[tag], tail)
            for tag in fns:
                for launch in fns[tag].values():
                    launch()
            torch.cuda.synchronize()
            for name, a in outs["this"].items():
                b = outs["other"][name]
                if not torch.equal(a.view(torch.int16 if a.dtype ==
                                          torch.bfloat16 else torch.int32),
                                   b.view(torch.int16 if b.dtype ==
                                          torch.bfloat16 else torch.int32)):
                    raise AssertionError(f"flash_ab: {name} differs at "
                                         f"{(bh, t, d)} {dtype} rate {rate}")
            for kernel in fns["this"]:
                ms = {"other": [], "this": []}
                for i in range(args.pairs):
                    order = ["other", "this"] if i % 2 == 0 \
                        else ["this", "other"]
                    for tag in order:
                        ms[tag].append(_time_ms(fns[tag][kernel]))
                ratios = [a / b for a, b in zip(ms["this"], ms["other"])]
                print(json.dumps({
                    "kernel": kernel, "at": [bh, t, d], "dtype": dtype,
                    "rate": rate, "pairs": args.pairs,
                    "bitwise_equal": True,
                    "other_ms_median": _median(ms["other"]),
                    "this_ms_median": _median(ms["this"]),
                    "ratio_median": _median(ratios),
                    "this_faster_pairs": sum(r < 1 for r in ratios)}),
                    flush=True)
            del ins, outs, fns
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
