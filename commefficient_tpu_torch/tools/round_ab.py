"""Whole GPT2 rounds of another checkout against this one's, on one card.

    python -m commefficient_tpu_torch.tools.round_ab --parent DIR

``DIR`` is the root of the other checkout (a ``git archive`` of the
parent, say). Builds both checkouts' kernels at once (each one's
``chip_smoke.phase_build``), then runs the sides parent, change, change,
parent, each in its own process on its own package: for gpt2 and
gpt2_clip (``chip_smoke.GPT2_PATHS``), 3 rounds of
``training.gpt2.train`` with ``chip_smoke.GPT2_FLAGS`` from the flags'
seed, each round's host ms printed, then round 3's batch once more under
``torch.profiler`` (this checkout's ``chip_smoke._profile_round``: device
time by kernel class, the elementwise add and fill totals, the top
kernels), the operators on (d,) tensors of one more round profiled with
input shapes, and digests of the final weights (their bits, and the bits of
``w + 0.0``) and their count of -0.0 written to a scratch directory. Last
it compares the digests: the runs of one side bitwise, and the two sides
bitwise and up to the sign of zero. Prints the card's name and power
limit. Needs one card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]
PATHS = ("gpt2", "gpt2_clip")


def _smoke():
    """This checkout's chip_smoke.py as a module (it imports the port
    lazily, so whichever package is first on sys.path is the one run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flat_sized_ops(name, learner, call) -> None:
    """One more round under ``torch.profiler`` with input shapes: the
    operators that take a (d,) tensor (d the flat weights' size), with
    their calls and the device time of the kernels they launch."""
    from torch.profiler import ProfilerActivity, profile
    d = learner.cfg.grad_size
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        learner.train_round(*call)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if [d] in e.input_shapes]
    print(f"ab {name}: operators on a ({d},) input in one round:", flush=True)
    for e in sorted(ops, key=lambda e: (-e.device_time_total, -e.count)
                    )[:12]:
        print(f"  {e.key} x{e.count}, device {e.device_time_total / 1e3:.3f}"
              f" ms, shapes {e.input_shapes}"[:200], flush=True)


def run_side(root: Path, paths, save: Path, tag: str) -> None:
    """One side's rounds, in this process, on ``root``'s package."""
    sys.path.insert(0, str(root))
    import torch

    from commefficient_tpu_torch.training.gpt2 import (build_gpt2_parser,
                                                       train)
    smoke = _smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        for name in paths:
            extra, namespace, _ = smoke.GPT2_PATHS[name]
            args = build_gpt2_parser().parse_args(
                smoke.GPT2_FLAGS + extra + ["--dataset_dir", tmp])
            for key, value in namespace.items():
                setattr(args, key, value)
            np.random.seed(args.seed)
            learner, row = train(args, max_rounds=3, log=False)
            torch.cuda.synchronize()
            print(f"ab {tag} {name}: round ms "
                  f"{[round(r['round_s'] * 1e3, 3) for r in row['rounds']]}"
                  f", losses {[r['loss'].hex() for r in row['rounds']]}",
                  flush=True)
            w = learner.state.weights.cpu().numpy()
            (save / f"{tag}_{name}.json").write_text(json.dumps({
                "bits": _digest(w), "bits_plus_0": _digest(w + np.float32(0)),
                "negative_zeros": int(np.sum((w == 0) & np.signbit(w)))}))
            smoke._profile_round(f"{tag} {name}", learner, row["last_batch"])
            _flat_sized_ops(f"{tag} {name}", learner, row["last_batch"])
            del learner, row
            torch.cuda.empty_cache()


def _digest(w: np.ndarray) -> str:
    return hashlib.sha256(w.view(np.int32).tobytes()).hexdigest()


def _compare(save: Path, tags, paths) -> None:
    for name in paths:
        runs = {t: json.loads((save / f"{t}_{name}.json").read_text())
                for t in tags}
        for side in ("p", "c"):
            first, *rest = (runs[t] for t in tags if t[0] == side)
            same = all(r["bits"] == first["bits"] for r in rest)
            print(f"ab {name}: the {side} runs bitwise equal: {same}; "
                  f"{first['negative_zeros']} weights are -0.0", flush=True)
        p = next(runs[t] for t in tags if t[0] == "p")
        c = next(runs[t] for t in tags if t[0] == "c")
        print(f"ab {name}: parent vs change bitwise equal: "
              f"{p['bits'] == c['bits']}; up to the sign of zero: "
              f"{p['bits_plus_0'] == c['bits_plus_0']}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True, type=Path)
    p.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    p.add_argument("--tag", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.side is not None:
        run_side(args.side, PATHS, args.save, args.tag)
        return 0
    roots = {"p": args.parent.resolve(), "c": HERE}
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import chip_smoke; chip_smoke.phase_build()"],
                               cwd=root) for root in roots.values()]
    if any([b.wait() for b in builds]):
        print("round_ab: a build failed", file=sys.stderr)
        return 1
    tags = [f"{side}{i}" for i, side in enumerate("pccp")]
    with tempfile.TemporaryDirectory() as save:
        for tag in tags:
            root = roots[tag[0]]
            done = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--parent",
                 str(roots["p"]), "--side", str(root), "--save", save,
                 "--tag", tag], cwd=root)
            if done.returncode:
                return done.returncode
        _compare(Path(save), tags, PATHS)
    print(_smoke()._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
