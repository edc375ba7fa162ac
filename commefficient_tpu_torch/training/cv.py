"""CV training entry point (port of ``commefficient_tpu/training/cv.py``).

    python -m commefficient_tpu_torch.training.cv --mode sketch \
        --error_type virtual --virtual_momentum 0.9 --num_workers 8 \
        --local_batch_size 32 --k 50000 --num_rows 5 --num_cols 500000

Runs on CUDA unless ``--device cpu`` is given; without a CUDA device and
without ``--device cpu`` it raises. On CUDA it turns TF32 off for
convolutions and matmuls: the reference trains in float32.

Epoch loop over federated rounds, piecewise-linear LR through a pivot
epoch, NaN abort, a validation pass per epoch and the byte rollup.
Checkpoints, resume, mesh, offload and scanned rounds are ROADMAP.md
A7/A9/A10/A12.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from commefficient_tpu_torch.data import FedBatcher, fed_datasets, val_batches
from commefficient_tpu_torch.federated.api import FedLearner
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.training.args import args_to_config, build_parser
from commefficient_tpu_torch.utils.device import resolve_device
from commefficient_tpu_torch.utils.schedules import cifar_lr_schedule

DATASET_CHANNELS = {"EMNIST": 1, "Digits": 1}


def _refuse_unported(args):
    for flag, on, item in (
            ("--mesh", bool(args.mesh), "A12"),
            ("--client_state_offload", args.client_state_offload, "A9"),
            ("--scan_rounds > 1", args.scan_rounds > 1, "A7")):
        if on:
            raise NotImplementedError(f"{flag} is not ported to PyTorch "
                                      f"yet (ROADMAP.md {item})")
    if args.dataset_name not in fed_datasets:
        raise NotImplementedError(
            f"dataset {args.dataset_name!r} is not ported to PyTorch yet "
            f"(ROADMAP.md A7); ported: {sorted(fed_datasets)}")


def make_dataset(args, train: bool):
    cls = fed_datasets[args.dataset_name]
    kw = dict(dataset_dir=args.dataset_dir, do_iid=args.do_iid,
              num_clients=args.num_clients, train=train, seed=args.seed)
    if args.dataset_name == "Synthetic":
        kw.update(per_class=64 if args.do_test else 512)
    return cls(**kw)


def build_learner(args, num_classes, channels, device):
    cfg = args_to_config(args)
    model = get_model(args.model, num_classes=num_classes,
                      do_batchnorm=args.do_batchnorm, in_channels=channels)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    loss = make_cv_loss(model)
    sched = cifar_lr_schedule(args.lr_scale, args.pivot_epoch,
                              args.num_epochs)
    return FedLearner(model, cfg, loss, loss, lr_schedule=sched,
                      device=device)


def train(args, max_rounds=None, log=True):
    """Train per ``args``; returns ``(learner, last epoch's row)``. The row
    carries each round's metrics and host time under ``"rounds"``."""
    _refuse_unported(args)
    device = resolve_device(args.device)
    train_set = make_dataset(args, train=True)
    val_set = make_dataset(args, train=False)
    args.num_clients = train_set.num_clients
    num_classes = train_set.num_classes
    channels = DATASET_CHANNELS.get(args.dataset_name, 3)

    batcher = FedBatcher(train_set, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    # the reference draws one probe round for its sample input before
    # training; drawing it too keeps the two packages' rounds identical
    next(iter(batcher.epoch()))
    learner = build_learner(args, num_classes, channels, device)
    spe = batcher.steps_per_epoch()
    total_rounds = 0
    t_start = time.perf_counter()
    n_epochs = int(math.ceil(args.num_epochs))
    row = {}
    for epoch in range(n_epochs):
        # fractional num_epochs truncates the last epoch's round count
        epoch_fraction = (args.num_epochs - epoch
                          if epoch == n_epochs - 1 else 1.0)
        rounds_cap = (spe if epoch_fraction >= 1
                      else max(1, int(round(spe * epoch_fraction))))
        rounds = []
        t_epoch = time.perf_counter()
        for ids, cols, mask in batcher.epoch():
            t0 = time.perf_counter()
            out = learner.train_round(ids, cols, mask,
                                      epoch_frac=total_rounds / max(spe, 1))
            out["round_s"] = time.perf_counter() - t0
            rounds.append(out)
            total_rounds += 1
            if log:
                print(f"round {total_rounds}: loss={out['loss']:.6f} "
                      f"down={out['download_bytes']:.0f}B "
                      f"up={out['upload_bytes']:.0f}B "
                      f"time={out['round_s'] * 1e3:.1f}ms", flush=True)
            if out["aborted"]:
                print(f"NaN/divergent loss ({out['loss']}); aborting "
                      f"(threshold {args.nan_threshold})")
                return learner, {"aborted": True, "loss": out["loss"],
                                 "rounds": rounds}
            if (args.do_test or len(rounds) >= rounds_cap
                    or (max_rounds and total_rounds >= max_rounds)):
                break
        train_time = time.perf_counter() - t_epoch
        t_val = time.perf_counter()
        val = learner.evaluate(val_batches(val_set, args.valid_batch_size))
        row = {
            "epoch": epoch + 1,
            "lr": rounds[-1]["lr"],
            "train_loss": float(np.mean([m["loss"] for m in rounds])),
            "train_acc": float(np.mean([m["metrics"][0] for m in rounds])),
            "train_time": train_time,
            "test_loss": val["loss"],
            "test_acc": float(val["metrics"][0]),
            "test_time": time.perf_counter() - t_val,
            "down (MiB)": learner.total_download_bytes / 2**20,
            "up (MiB)": learner.total_upload_bytes / 2**20,
            "total_time": time.perf_counter() - t_start,
        }
        if log:
            print({k: round(v, 4) if isinstance(v, float) else v
                   for k, v in row.items()}, flush=True)
        row["rounds"] = rounds
        if args.do_test or (max_rounds and total_rounds >= max_rounds):
            break
    return learner, row


def main(argv=None):
    parser = build_parser(default_lr=0.4)
    args = parser.parse_args(argv)
    if args.do_test:
        # shrink everything: tiny sketch, one round
        args.k = min(args.k, 10)
        args.num_cols = min(args.num_cols, 100)
        args.num_rows = min(args.num_rows, 1)
        args.num_epochs = 1
    np.random.seed(args.seed)
    _, final = train(args)
    final.pop("rounds", None)
    print("final:", {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in final.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
