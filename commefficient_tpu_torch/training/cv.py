"""CV training entry point (port of ``commefficient_tpu/training/cv.py``).

    python -m commefficient_tpu_torch.training.cv --dataset_name CIFAR10 \
        --dataset_dir ./dataset/cifar10 --model ResNet9 --mode sketch \
        --error_type virtual --virtual_momentum 0.9 --num_clients 100 \
        --num_workers 8 --local_batch_size 32 --k 50000 --num_rows 5 \
        --num_cols 500000 --pivot_epoch 5 --lr_scale 0.4 --scan_rounds 8

All five modes run: ``--mode sketch`` (``--server_fused auto|off``),
``true_topk``, ``local_topk``, ``uncompressed`` and ``fedavg`` (with
``--local_batch_size -1``), on every ``--model`` of the registry but
those with BatchNorm (``--batchnorm``, ResNet18, the ``norm="batch"``
ResNets), which ``build_learner`` refuses as the reference's round fails
on them; Fixup* models train their scalars at ``--scalar_lr_factor``
(0.1 by default) times the LR. ``--compute_dtype bfloat16`` runs
ResNet9's convolutions and head in bfloat16 (parameters and logits stay
float32) and is refused for any other model, as in the reference.
Datasets: CIFAR10/100 (the python-pickle batches under
``--dataset_dir``), EMNIST (LEAF json shards), ImageNet (the extracted
JPEG tree; PIL decodes it once), each with the reference's train and
test transforms; Synthetic; and the offline Digits and Patches32 (built
from scikit-learn's bundled data on first use).

Runs on CUDA unless ``--device cpu`` is given; without a CUDA device and
without ``--device cpu`` it raises. On CUDA it turns TF32 off for
convolutions and matmuls: the reference trains in float32.

The client-state and transmit flags run in every mode that takes them:
``--client_state dense|sparse|sketched`` (``--client_sketch_rows/cols``),
``--client_state_offload`` (``--offload_pipeline_depth``),
``--client_k_dist``, ``--grad_buckets`` and ``--sketch_scheme global``.

Epoch loop over federated rounds: the batches go to the device ahead of
their rounds (``data/prefetch.device_prefetch``), each round is
dispatched with the next round's client ids for the offload pipeline's
gather-ahead, and its metrics are read one round later
(``RoundPipeline``) or a window at a time under ``--scan_rounds K``
(``ScanWindow``; refused with ``--client_state_offload`` and with the
buffered server, as in the reference). Piecewise-linear LR through a
pivot epoch, NaN abort, the offloaded rows flushed at every epoch's end,
a validation pass per epoch (and one before training under
``--eval_before_start``), the byte rollup, ``TableLogger`` rows,
``--tensorboard`` scalars and a ``--profile`` trace.

Robustness: ``--server_mode buffered`` with the ``--fault_*`` schedule
(``federated/buffer.py``; its in-flight contributions are delivered and
a partial buffer applied at the end), ``--client_quarantine``,
``--checkpoint`` (the final export under ``--checkpoint_path``),
``--checkpoint_every_rounds N`` with the SIGTERM/SIGINT guard and
``--resume auto|PATH`` (``training/preempt.py``: a resumed epoch replays
its first rounds' data draws without training them, and the run ends
bitwise where the uninterrupted one does), and ``--finetune`` from
``--finetune_path`` (``utils/finetune.py``).

``--mesh clients=N`` runs the round on N ranks (``parallel/``): ``main``
launches them (or joins ``torchrun``'s), each runs ``train(args,
mesh=...)`` on its own device with the workers of its block, and rank 0
prints. A CV run refuses every inner axis with the reference's
ValueErrors.
"""

from __future__ import annotations

import math
import sys
from functools import partial

import numpy as np
import torch

from commefficient_tpu_torch.data import FedBatcher, fed_datasets, val_batches
from commefficient_tpu_torch.data.prefetch import (device_prefetch,
                                                   with_lookahead)
from commefficient_tpu_torch.data.transforms import get_transforms
from commefficient_tpu_torch.federated.losses import make_cv_loss
from commefficient_tpu_torch.models import get_model
from commefficient_tpu_torch.models.norms import BatchNorm
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel.mesh import (clients_size, main_first,
                                                   make_mesh,
                                                   padded_num_clients)
from commefficient_tpu_torch.training.args import (args_to_config,
                                                   build_parser,
                                                   learner_factory,
                                                   mesh_inner_axes,
                                                   parse_mesh,
                                                   refuse_buffered_scan,
                                                   round_up_workers_for_mesh,
                                                   scan_rounds)
from commefficient_tpu_torch.training.loop import (FeedClock, RoundAborted,
                                                   RoundFeed, end_aborted,
                                                   finish_run, raise_on_abort)
from commefficient_tpu_torch.training.preempt import TrainCheckpointer
from commefficient_tpu_torch.utils.checkpoint import save_checkpoint
from commefficient_tpu_torch.utils.device import resolve_device
from commefficient_tpu_torch.utils.finetune import \
    load_pretrained_for_finetune
from commefficient_tpu_torch.utils.logging import (ScalarWriter, TableLogger,
                                                   Timer, make_logdir,
                                                   profile_ctx)
from commefficient_tpu_torch.utils.params import scalar_lr_multipliers
from commefficient_tpu_torch.utils.schedules import cifar_lr_schedule

DATASET_CLASSES = {"CIFAR10": 10, "CIFAR100": 100, "EMNIST": 62,
                   "ImageNet": 1000, "Synthetic": 10, "Digits": 10,
                   "Patches32": 10}
DATASET_CHANNELS = {"EMNIST": 1, "Digits": 1}


def _refuse_mesh_axes(args):
    """The reference's ValueErrors for an inner mesh axis on a CV run
    (``commefficient_tpu/training/cv.py:104-124``), in its order."""
    inner = mesh_inner_axes(args.mesh)
    if inner.get("seq", 1) > 1:
        raise ValueError("--mesh seq=N applies to the gpt2 entrypoint "
                         "(sequence-parallel ring attention); CV models "
                         "have no sequence axis")
    if inner.get("model", 1) > 1:
        raise ValueError("--mesh model=M (2D clients x model federation) "
                         "is wired for the gpt2 entrypoint; CV models "
                         "have no TP layout")
    if inner.get("stage", 1) > 1:
        raise ValueError("--mesh stage=S (GPipe pipeline) is wired for "
                         "the gpt2 entrypoint; CV models have no stacked "
                         "block trunk")
    if inner.get("expert", 1) > 1:
        raise ValueError("--mesh expert=E (MoE expert parallelism) is "
                         "wired for the gpt2 entrypoint; CV models have "
                         "no MoE blocks")


def _refuse_unported(args):
    _refuse_mesh_axes(args)
    refuse_buffered_scan(args)
    if args.dataset_name not in fed_datasets:
        raise ValueError(f"--dataset_name {args.dataset_name!r} is not a CV "
                         f"dataset; choices: {sorted(fed_datasets)}")
    # the config's refusals, before any data is made
    args_to_config(args).validate()


def make_dataset(args, train: bool):
    cls = fed_datasets[args.dataset_name]
    kw = dict(dataset_dir=args.dataset_dir, do_iid=args.do_iid,
              num_clients=args.num_clients, train=train,
              transform=get_transforms(args.dataset_name, train),
              seed=args.seed)
    if args.dataset_name == "Synthetic":
        kw.update(per_class=64 if args.do_test else 512)
    return cls(**kw)


def build_learner(args, num_classes, channels, device, image_size=32,
                  mesh=None):
    """The model of ``--model`` (``--batchnorm`` goes to ResNet9 alone, as
    in the reference), seeded from ``--seed``, in a ``FedLearner`` with
    the CIFAR LR schedule and, where ``--scalar_lr_factor`` (0.1 for
    Fixup* models, 1.0 otherwise) is not 1, per-coordinate LR multipliers
    on the size-1 parameters. ``--compute_dtype`` goes to ResNet9 alone;
    for another model anything but float32 raises the reference's
    ValueError. ``image_size`` sizes TinyMLP's input layer (flax infers
    it from the sample input).

    A model with BatchNorm is refused: the reference's round applies
    ``{"params": ...}`` alone (``commefficient_tpu/federated/losses.py:22``),
    so BatchNorm's statistics have no place in it, and it fails there.

    ``--finetune`` loads ``--finetune_path``'s weights into every
    coordinate but the head's and freezes them; ``--server_mode
    buffered`` builds a ``BufferedFedLearner`` with the ``--fault_*``
    schedule (``learner_factory``). On a ``mesh`` the client rows are
    padded to a multiple of its ``clients`` axis."""
    cfg = args_to_config(args, num_clients=padded_num_clients(
        args.num_clients, mesh))
    model_kw = dict(num_classes=num_classes, in_channels=channels)
    compute_dtype = getattr(args, "compute_dtype", "float32")
    if args.model == "ResNet9":
        model_kw["do_batchnorm"] = args.do_batchnorm
        model_kw["dtype"] = compute_dtype
    elif compute_dtype != "float32":
        raise ValueError(f"--compute_dtype {compute_dtype} is only "
                         f"supported for ResNet9 (got {args.model})")
    if args.model == "TinyMLP":
        model_kw["image_size"] = image_size
    model = get_model(args.model, **model_kw)
    if any(isinstance(m, BatchNorm) for m in model.modules()):
        raise ValueError(
            f"--model {args.model}"
            f"{' --batchnorm' if args.do_batchnorm else ''} has BatchNorm, "
            "whose batch_stats the federated round cannot carry: the "
            "reference's round applies {'params': ...} alone "
            "(commefficient_tpu/federated/losses.py:22) and fails on it")
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    trainable_mask = None
    if args.do_finetune:
        def pretrained_model(meta):
            # the pretrained model of a head swap: the file's name and
            # classes, this run's input
            kw = dict(model_kw, num_classes=meta["num_classes"])
            if meta["model"] != args.model:
                kw = {k: v for k, v in kw.items()
                      if k in ("num_classes", "in_channels")}
            if (meta["model"] == "ResNet9"
                    and meta.get("do_batchnorm") is not None):
                kw["do_batchnorm"] = meta["do_batchnorm"]
            return get_model(meta["model"], **kw)
        model, trainable_mask = load_pretrained_for_finetune(
            model, args.finetune_path, make_model=pretrained_model)
    loss = make_cv_loss(model)
    sched = cifar_lr_schedule(args.lr_scale, args.pivot_epoch,
                              args.num_epochs)
    factor = args.scalar_lr_factor
    if factor is None:
        factor = 0.1 if args.model.startswith("Fixup") else 1.0
    lr_vec = (None if factor == 1.0 else
              partial(scalar_lr_multipliers, scalar_factor=factor))
    cls, extra = learner_factory(args, cfg.num_clients)
    return cls(model, cfg, loss, loss, lr_schedule=sched, device=device,
               lr_scale_vec=lr_vec, trainable_mask=trainable_mask, mesh=mesh,
               **extra)


def train(args, mesh=None, max_rounds=None, log=True):
    """Train per ``args``; returns ``(learner, last epoch's row)``. The row
    carries every finalized round's metrics in order, over all epochs,
    under ``"rounds"`` (each with its ``round_s``, ``training/loop.py``),
    and the host seconds and batches of the data feed (``"feed_s"``,
    ``"feed_batches"``). A run stopped by SIGTERM/SIGINT returns after its
    checkpoint with ``"preempted"`` in the row. On a ``mesh`` (a
    ``DeviceMesh`` this rank has joined) only rank 0 logs; every rank
    returns the global rounds' metrics."""
    _refuse_unported(args)
    log = log and distributed.is_main()
    device = resolve_device(args.device)
    with main_first(mesh):
        train_set = make_dataset(args, train=True)
        val_set = make_dataset(args, train=False)
    args.num_clients = train_set.num_clients
    num_classes = getattr(train_set, "num_classes",
                          DATASET_CLASSES[args.dataset_name])
    channels = DATASET_CHANNELS.get(args.dataset_name, 3)

    batcher = FedBatcher(train_set, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    # the reference draws one probe round for its sample input before
    # training; drawing it too keeps the two packages' rounds identical
    # (a resume's cursor then overwrites the draws it made)
    _, probe_cols, _ = next(iter(batcher.epoch()))
    learner = build_learner(args, num_classes, channels, device,
                            image_size=probe_cols[0].shape[2], mesh=mesh)
    meta = {"model": args.model, "num_classes": num_classes,
            "do_batchnorm": args.do_batchnorm}
    ckpt = TrainCheckpointer(args, learner, batcher, entry="cv", meta=meta,
                             log=log)
    cursor = ckpt.resume()
    start_epoch = cursor["epoch"] if cursor else 0
    skip0 = cursor["rounds_in_epoch"] if cursor else 0
    scan_k = scan_rounds(args)
    table = TableLogger() if log else None
    writer = (ScalarWriter(make_logdir(args))
              if args.use_tensorboard and distributed.is_main()
              else None)
    timer = Timer()
    feed = FeedClock()
    spe = batcher.steps_per_epoch()
    total_rounds = cursor["total_rounds"] if cursor else 0
    row, history = {}, []
    try:
        ckpt.guard.__enter__()
        if args.eval_before_start:
            # a logging flag must not move the trajectory: the learner's
            # generator is put back as it was
            gen_state = learner.generator.get_state()
            val0 = learner.evaluate(val_batches(val_set,
                                                args.valid_batch_size))
            learner.generator.set_state(gen_state)
            if log:
                print(f"eval before start: loss={val0['loss']:.4f} "
                      f"acc={float(val0['metrics'][0]):.4f}")
            if writer:
                writer.add_scalar("test_loss", val0["loss"], 0)
                writer.add_scalar("test_acc", float(val0["metrics"][0]), 0)
        n_epochs = int(math.ceil(args.num_epochs))
        for epoch in range(start_epoch, n_epochs):
            # fractional num_epochs truncates the last epoch's round count
            epoch_fraction = (args.num_epochs - epoch
                              if epoch == n_epochs - 1 else 1.0)
            rounds_cap = (spe if epoch_fraction >= 1
                          else max(1, int(round(spe * epoch_fraction))))
            # a resumed epoch replays its first rounds' data draws without
            # training them
            skip = skip0 if epoch == start_epoch else 0
            rounds_in_epoch = skip
            epoch_metrics = []
            # the one-round pipeline (or a K-round window): the host reads
            # round t's metrics while round t+1 runs, so an abort is seen
            # one round (or window) late; the round's sticky device guard
            # keeps the rounds after a breach from changing anything
            rounds = RoundFeed(learner, scan_k)

            def record(outs):
                for out in outs:
                    epoch_metrics.append(out)
                    history.append(out)
                    if log:
                        print(f"round {len(history)}: loss={out['loss']:.6f} "
                              f"down={out['download_bytes']:.0f}B "
                              f"up={out['upload_bytes']:.0f}B "
                              f"time={out['round_s'] * 1e3:.1f}ms",
                              flush=True)
                raise_on_abort(outs)

            # the next rounds' batches copy to the device while this one
            # computes; the one-item lookahead feeds the offload pipeline's
            # gather-ahead (the next round's rows copy meanwhile too)
            for (ids, cols, mask), nxt in with_lookahead(device_prefetch(
                    feed.wrap(batcher.epoch(skip=skip)),
                    device=learner.device, workers=learner.worker_slice)):
                record(rounds.push(
                    ids, cols, mask, total_rounds / max(spe, 1),
                    next_client_ids=None if nxt is None else nxt[0]))
                total_rounds += 1
                rounds_in_epoch += 1
                # no next batch: this round is the epoch's last, whatever
                # the estimate of steps_per_epoch says
                at_boundary = (args.do_test or rounds_in_epoch >= rounds_cap
                               or (max_rounds and total_rounds >= max_rounds)
                               or nxt is None)
                if ckpt.after_round(epoch, rounds_in_epoch, total_rounds,
                                    at_boundary,
                                    lambda: record(rounds.flush())):
                    return learner, {"preempted": True, "epoch": epoch + 1,
                                     "rounds": history}
                if at_boundary:
                    break
            # epoch boundary: pending writebacks land in the host rows, a
            # gather-ahead for a round that never ran is dropped, and the
            # last round (or window) is read
            learner.flush_offload()
            record(rounds.flush())
            train_time = timer()
            val = learner.evaluate(val_batches(val_set,
                                               args.valid_batch_size))
            val_time = timer()
            row = {
                "epoch": epoch + 1,
                "lr": epoch_metrics[-1]["lr"],
                "train_loss": float(np.mean([m["loss"]
                                             for m in epoch_metrics])),
                "train_acc": float(np.mean([m["metrics"][0]
                                            for m in epoch_metrics])),
                "train_time": train_time,
                "test_loss": val["loss"],
                "test_acc": float(val["metrics"][0]),
                "test_time": val_time,
                "down (MiB)": learner.total_download_bytes / 2**20,
                "up (MiB)": learner.total_upload_bytes / 2**20,
                "total_time": timer.total_time,
            }
            if table:
                table.append(row)
            if writer:
                for tag in ("train_loss", "train_acc", "train_time",
                            "test_loss", "test_acc", "test_time", "lr"):
                    writer.add_scalar(tag, row[tag], epoch + 1)
            row.update(rounds=history, feed_s=feed.seconds,
                       feed_batches=feed.batches)
            stop = args.do_test or (max_rounds and total_rounds >= max_rounds)
            if ckpt.at_epoch_end(epoch, n_epochs, total_rounds, stop):
                return learner, dict(row, preempted=True)
            if stop:
                break
    except RoundAborted as e:
        return end_aborted(learner, e.metrics, history, args.nan_threshold)
    finally:
        ckpt.guard.__exit__()
        if writer:
            writer.close()
    finish_run(learner, row, log)
    if args.do_checkpoint:
        save_checkpoint(args.checkpoint_path, learner, args.model, meta=meta)
    return learner, row


def _print_final(final: dict) -> None:
    for key in ("rounds", "feed_s", "feed_batches"):
        final.pop(key, None)
    print("final:", {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in final.items()})


def mesh_rank_main(args, n_clients: int) -> None:
    """One rank of a ``--mesh`` run (the launcher's target)."""
    np.random.seed(args.seed)
    mesh = make_mesh(n_clients, device_type=torch.device(args.device).type)
    main_rank = distributed.is_main()
    with profile_ctx(args.profile if main_rank else None):
        _, final = train(args, mesh=mesh)
    if main_rank:
        _print_final(final)


def main(argv=None):
    parser = build_parser(default_lr=0.4)
    args = parser.parse_args(argv)
    if args.do_test:
        # shrink everything: tiny sketch, one round
        args.k = min(args.k, 10)
        args.num_cols = min(args.num_cols, 100)
        args.num_rows = min(args.num_rows, 1)
        args.num_epochs = 1
    mesh = parse_mesh(args.mesh)
    if mesh is not None:
        round_up_workers_for_mesh(args, mesh)
        _refuse_unported(args)
        distributed.run(mesh_rank_main, clients_size(mesh),
                        (args, clients_size(mesh)),
                        device_type=torch.device(args.device).type)
        return 0
    np.random.seed(args.seed)
    with profile_ctx(args.profile):
        _, final = train(args)
    _print_final(final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
