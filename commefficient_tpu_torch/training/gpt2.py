"""GPT2/PersonaChat training entry point (port of
``commefficient_tpu/training/gpt2.py``).

    python -m commefficient_tpu_torch.training.gpt2 --model gpt2 \
        --vocab_pad_to 50262 --attn_impl blockwise --mode sketch \
        --error_type virtual --virtual_momentum 0.9 --num_workers 4 \
        --local_batch_size 8 --k 50000 --num_rows 5 --num_cols 500000 \
        --max_seq_len 256 --lr_scale 0.04 --weight_decay 0 \
        --dataset_name SyntheticPersona

Double-heads LM + MC loss, per-round linear LR decay to zero
(ref gpt2_train.py:302-307), and a validation pass per epoch reporting the
token-weighted nll, its perplexity and the MC accuracy. With no tokenizer
in a local cache the model trains from scratch over the byte-level
tokenizer; ``--vocab_pad_to 50262`` gives GPT2-small's published width
(d = 124,051,201).

Runs on CUDA unless ``--device cpu`` is given; without a CUDA device and
without ``--device cpu`` it raises. ``--attn_impl blockwise`` on CUDA runs
the flash kernels (``ops/flash_attention.py``), attention dropout inside
them. ``args.dropout_impl = "tpu_bits"``, set on the parsed namespace (the
CLI offers only ``xla`` and ``xla_rbg``, as the reference's does), runs the
model's other dropout sites through the hardware-RNG dropout kernel
(``ops/dropout.py::hw_dropout``). ``--fused_ce on`` (or ``auto`` at
``--max_seq_len`` >= 512, or the legacy ``--fused_lm_head``) takes the LM
loss through the vocab-chunked fused head (``ops/fused_ce.py``) without
materializing the logits. ``--model gpt2`` / ``openai-gpt`` with an HF
tokenizer in the local cache start from the cached HF weights where they
are cached too (``models/gpt2_import.py``); neither is fetched.
``--moe_experts E`` makes each block's MLP a Switch MoE FFN
(``ops/moe.py``) with ``--moe_capacity_factor`` and adds the
load-balancing term at ``--moe_aux_weight`` to the training loss.
``--mode local_topk --error_type local --client_state sparse
--client_state_offload`` keeps each client's rows as k index/value pairs
in host memory (``examples/gpt2_personachat.sh``'s single-card setting).
The loop is the CV entry point's (``training/loop.py``): device prefetch,
the one-round pipeline or ``--scan_rounds K`` windows,
``--eval_before_start``, ``--tensorboard`` and ``--profile``, with the
robustness flags: ``--server_mode buffered`` and the ``--fault_*``
schedule, ``--client_quarantine``, ``--checkpoint_every_rounds``, the
SIGTERM/SIGINT guard and ``--resume`` (the learner's generator, which
the dropout draws from, is in the checkpoint), and ``--checkpoint``'s
export (``gpt2.npz``, ``config.json``, ``tokenizer.json`` under
``--checkpoint_path``). After training a greedy reply to the first
validation dialog is printed (``models/gpt2_generate.sample_reply``).

``--serve_online`` runs train-while-serve instead (``online/loop.py``):

    python -m commefficient_tpu_torch.training.gpt2 --serve_online \
        --server_mode buffered --serve_personalized --client_state sparse \
        --mode local_topk --error_type local ...

serves persona traffic through a paged, personalized
``ContinuousBatchingServer``, trains the buffered cohorts on it and
hot-swaps the new base weights into the server (``--serve_slots``,
``--serve_sample``, ``--speculate_k``, ``--kv_quant``, ``--serve_disagg``,
``--online_train_every``, ``--online_swap_every``), on one device: with a
``--mesh`` it raises the reference's ValueError.

``--mesh clients=N`` runs the round on N ranks (``parallel/``), as the CV
entry point does. ``--mesh clients=C,model=M`` runs C*M ranks: 2-D
clients x model federation, GPT2 tensor-parallel on each model group of
M ranks (``parallel/tp.py``), the flat state stored in coordinate blocks
(``federated/api.py``):

    python -m commefficient_tpu_torch.training.gpt2 --device cpu \
        --mesh clients=2,model=2 --model gpt2-tiny --mode sketch ...

``--client_state_offload``, ``--server_mode buffered`` and
``--grad_buckets`` run on the model axis too. ``--mesh clients=C,seq=S``
runs C*S ranks: each client shard's workers on S blocks of the
sequence, ring attention over each seq group (``parallel/seq.py``), on
the fused round only (the reference's ValueErrors otherwise);
``--attn_impl full`` switches to ring there, ``blockwise`` is refused:

    python -m commefficient_tpu_torch.training.gpt2 --device cpu \
        --mesh clients=2,seq=2 --attn_impl ring --model gpt2-tiny \
        --mode uncompressed --error_type none --max_seq_len 32 ...

``--mesh clients=C,stage=S --mc_coef 0`` runs C*S ranks: each client
shard's workers through a GPipe pipeline of S stages of contiguous
blocks in ``--pp_microbatches`` microbatches (0: S), the LM loss on the
last stage (``parallel/pp.py``); the fused round, ``--mc_coef 0``,
``--fused_ce`` auto/off and ``--dropout_impl xla`` are demanded with the
reference's ValueErrors, and validation runs the plain forward:

    python -m commefficient_tpu_torch.training.gpt2 --device cpu \
        --mesh clients=2,stage=2 --mc_coef 0 --model gpt2-tiny \
        --mode uncompressed --error_type none --max_seq_len 32 ...

``--mesh clients=C,expert=E --moe_experts X`` runs C*E ranks: each
client shard's workers on E ranks, rank e computing the experts ``[e X/E,
(e+1) X/E)`` of every MoE block and the rest replicated
(``parallel/ep.py``), on the fused round only (the reference's
ValueErrors otherwise); ``--moe_experts`` also runs on a model axis,
each MoE block whole on every model rank:

    python -m commefficient_tpu_torch.training.gpt2 --device cpu \
        --mesh clients=2,expert=2 --moe_experts 4 --model gpt2-tiny \
        --mode sketch --max_seq_len 32 ...

On any clients axis the fused round's MoE blocks route the whole batch
(every rank's tokens) as the reference's one loss call does.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

from commefficient_tpu_torch.data import FedBatcher, val_batches
from commefficient_tpu_torch.data.prefetch import (device_prefetch,
                                                   with_lookahead)
from commefficient_tpu_torch.data.persona import (FedPERSONA,
                                                  SyntheticPersona)
from commefficient_tpu_torch.data.tokenizer import (HFTokenizerWrapper,
                                                    get_tokenizer)
from commefficient_tpu_torch.federated.losses import (make_gpt2_train_loss,
                                                      make_gpt2_val_loss)
from commefficient_tpu_torch.federated.round import fused_clients_eligible
from commefficient_tpu_torch.models import GPT2_CONFIGS, GPT2DoubleHeads
from commefficient_tpu_torch.models.gpt2_import import try_load_hf_pretrained
from commefficient_tpu_torch.ops import cuda_lib
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.online.swap import learner_params
from commefficient_tpu_torch.parallel.mesh import (expert_size, main_first,
                                                   make_mesh, model_size,
                                                   padded_num_clients,
                                                   seq_size, stage_size)
from commefficient_tpu_torch.parallel.pp import make_gpt2_train_loss_pp
from commefficient_tpu_torch.parallel.seq import (make_gpt2_train_loss_seq,
                                                  make_gpt2_val_loss_seq)
from commefficient_tpu_torch.training.args import (add_gpt2_flags,
                                                   args_to_config,
                                                   build_parser,
                                                   learner_factory,
                                                   mesh_inner_axes,
                                                   mesh_ranks, parse_mesh,
                                                   refuse_buffered_scan,
                                                   resolve_fused_ce,
                                                   round_up_workers_for_mesh,
                                                   scan_rounds)
from commefficient_tpu_torch.training.loop import (FeedClock, RoundAborted,
                                                   RoundFeed, end_aborted,
                                                   finish_run, raise_on_abort)
from commefficient_tpu_torch.training.preempt import TrainCheckpointer
from commefficient_tpu_torch.utils.checkpoint import save_checkpoint
from commefficient_tpu_torch.utils.device import resolve_device
from commefficient_tpu_torch.utils.logging import (ScalarWriter, TableLogger,
                                                   Timer, make_logdir,
                                                   profile_ctx)
from commefficient_tpu_torch.utils.schedules import gpt2_lr_schedule


def _refuse_moe_combinations(args):
    """The reference's own errors for MoE (``training/gpt2.py:146-160``):
    an expert axis without experts, and MoE with the seq (ring) or stage
    losses, which do not collect the load-balancing term."""
    axes = mesh_inner_axes(args.mesh)
    if axes.get("expert", 1) > 1 and args.moe_experts <= 0:
        raise ValueError("--mesh expert=E shards MoE expert weights; "
                         "pass --moe_experts > 0 (got 0)")
    if args.moe_experts > 0 and (axes.get("seq", 1) > 1
                                 or axes.get("stage", 1) > 1
                                 or args.attn_impl == "ring"):
        raise ValueError(
            "--moe_experts composes with --mesh clients=/expert=/model= "
            "federation; the seq (ring) and stage (GPipe) losses do not "
            "collect the Switch load-balancing aux loss")


def _refuse_unported(args):
    _refuse_moe_combinations(args)
    refuse_buffered_scan(args)
    if args.model not in GPT2_CONFIGS:
        raise ValueError(f"--model {args.model!r} is not a GPT2 model; "
                         f"choices: {sorted(GPT2_CONFIGS)}")
    if args.dataset_name not in ("SyntheticPersona", "PERSONA"):
        raise ValueError(f"--dataset_name {args.dataset_name!r}: the GPT2 "
                         "entry point reads SyntheticPersona or PERSONA")
    args_to_config(args).validate()


def _require_fused_round(args, which: str) -> None:
    """The reference's check that an inner mesh axis (``which``, as
    ``seq=S``) runs on the fused federated round, with its message."""
    cfg = args_to_config(args)
    if not fused_clients_eligible(cfg):
        raise ValueError(
            f"--mesh {which} requires the fused federated round "
            "(mode uncompressed/sketch/true_topk; no local momentum/"
            "error, DP, grad clip, topk_down, or microbatching) — "
            f"this config has mode={cfg.mode}, error_type="
            f"{cfg.error_type}, local_momentum={cfg.local_momentum}, "
            f"microbatch_size={cfg.microbatch_size}")


def seq_gate(args, mesh, log: bool = False) -> str:
    """The reference's checks of the seq axis (``training/gpt2.py:104-119``
    and ``:162-181``) on ``mesh`` (a joined mesh or a ``MeshSpec``; None
    for one process), with its messages; returns the attention to build:
    ``full`` switches to ``ring`` on a seq axis."""
    seq_n = seq_size(mesh)
    attn = args.attn_impl
    if seq_n > 1:
        if attn == "blockwise":
            raise ValueError("--attn_impl blockwise cannot shard the "
                             "sequence; use --attn_impl ring with "
                             "--mesh seq=N")
        if attn != "ring":
            if log:
                print(f"--mesh seq={seq_n}: enabling ring attention")
            attn = "ring"
        if args.max_seq_len % seq_n:
            raise ValueError(f"--max_seq_len {args.max_seq_len} must be "
                             f"divisible by the seq axis ({seq_n})")
        _require_fused_round(args, f"seq={seq_n}")
    elif attn == "ring":
        raise ValueError("--attn_impl ring requires --mesh ...,seq=N>1")
    return attn


def stage_gate(args, mesh, log: bool = False) -> int:
    """The reference's checks of the stage axis (``training/gpt2.py:
    162-210``) on ``mesh`` (a joined mesh or a ``MeshSpec``; None for one
    process), in its order, with its messages; returns the pipeline's
    microbatches (``--pp_microbatches``, 0 meaning the stage count), 0
    without a stage axis."""
    stage_n = stage_size(mesh)
    if stage_n == 1:
        return 0
    _require_fused_round(args, f"stage={stage_n}")
    if args.mc_coef != 0:
        raise ValueError(
            "--mesh stage=S runs the client loss through the GPipe "
            "pipeline, which is LM-only (no MC head, parallel/pp.py); "
            "pass --mc_coef 0 to acknowledge, or use --mesh seq=/"
            "model= for double-heads parallelism")
    if resolve_fused_ce(args, mesh):
        raise ValueError(
            "--fused_ce on is not plumbed through the GPipe loss "
            "(make_gpt2_train_loss_pp materializes logits via its own "
            "head einsum); use --fused_ce auto/off for --mesh stage=S")
    impl = getattr(args, "dropout_impl", "xla")
    if impl != "xla":
        raise ValueError(
            "--dropout_impl {} is not plumbed through the pipeline's "
            "blocks (parallel/pp.py uses the portable xla path); drop "
            "the flag for --mesh stage=S".format(impl))
    if args.pp_microbatches < 0:
        raise ValueError("--pp_microbatches must be >= 0 "
                         f"(got {args.pp_microbatches})")
    n_micro = args.pp_microbatches or stage_n
    if log:
        print(f"--mesh stage={stage_n}: GPipe pipeline inside the "
              f"federated round ({n_micro} microbatches, LM-only)")
    return n_micro


def expert_gate(args, mesh, log: bool = False) -> None:
    """The reference's check of the expert axis (``training/gpt2.py:
    162-184``, after the MoE checks of ``_refuse_moe_combinations``) on
    ``mesh`` (a joined mesh or a ``MeshSpec``; None for one process),
    with its message."""
    expert_n = expert_size(mesh)
    if expert_n > 1:
        _require_fused_round(args, f"expert={expert_n}")
        if log:
            print(f"--mesh expert={expert_n}: EP-sharding the "
                  f"{args.moe_experts}-expert MoE weights inside the "
                  "federated round")


def save_pretrained(log_dir: str, learner, gpt2_config,
                    tokenizer) -> None:
    """Export the weights and state (``gpt2.npz``), the model config and
    the tokenizer's identity under ``log_dir``, as the reference does."""
    os.makedirs(log_dir, exist_ok=True)
    save_checkpoint(log_dir, learner, "gpt2")
    if not distributed.is_main():
        return
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        json.dump({k: getattr(gpt2_config, k)
                   for k in ("vocab_size", "n_positions", "n_embd",
                             "n_layer", "n_head", "dropout")}, f)
    with open(os.path.join(log_dir, "tokenizer.json"), "w") as f:
        json.dump({"type": type(tokenizer).__name__,
                   "vocab_size": tokenizer.vocab_size}, f)


def make_persona(args, tokenizer, train: bool):
    kw = dict(tokenizer=tokenizer, num_candidates=args.num_candidates,
              max_history=args.max_history, max_seq_len=args.max_seq_len,
              personality_permutations=args.personality_permutations,
              do_iid=args.do_iid, num_clients=args.num_clients, train=train,
              dataset_dir=args.dataset_dir, seed=args.seed)
    if args.dataset_name == "PERSONA":
        return FedPERSONA(**kw)
    kw.update(num_clients_gen=args.synthetic_personas,
              dialogs_per_client=args.synthetic_dialogs)
    return SyntheticPersona(**kw)


def gpt2_config(args, vocab_size: int, mesh=None, attn_impl=None):
    """The model config the reference builds from the flags (on ``mesh``,
    with the attention ``seq_gate`` chose)."""
    gcfg = GPT2_CONFIGS[args.model](vocab_size=vocab_size)
    if args.vocab_pad_to:
        gcfg.vocab_size = max(gcfg.vocab_size, args.vocab_pad_to)
    gcfg.n_positions = max(gcfg.n_positions, args.max_seq_len)
    gcfg.attn_impl = attn_impl or args.attn_impl
    gcfg.dtype = args.compute_dtype
    # no CLI value selects "tpu_bits" (as in the reference): a caller sets
    # it on the parsed namespace, and it reaches every FusedDropout site
    gcfg.dropout_impl = getattr(args, "dropout_impl", "xla")
    gcfg.attn_dropout = args.attn_dropout
    gcfg.fused_lm_head = resolve_fused_ce(args, mesh)
    gcfg.moe_experts = args.moe_experts
    gcfg.moe_capacity_factor = args.moe_capacity_factor
    return gcfg


def train(args, mesh=None, max_rounds=None, log=True):
    """Train per ``args``; returns ``(learner, last epoch's row)``. Beside
    the epoch's metrics the row carries every finalized round's metrics in
    order with its ``round_s`` (``"rounds"``), the kernel launch counters
    as they stood when the epoch's rounds ended
    (``"launches_after_rounds"``), the number of validation batches
    (``"val_batches"``), the last round's ``(client_ids, batch, mask)``
    (``"last_batch"``, the batch and mask on the device) and the data
    feed's host seconds and batches (``"feed_s"``, ``"feed_batches"``).
    On a ``mesh`` (a ``DeviceMesh`` this rank has joined) the client rows
    are padded to a multiple of its ``clients`` axis and only rank 0
    logs; every rank returns the global rounds' metrics."""
    _refuse_unported(args)
    log = log and distributed.is_main()
    attn = seq_gate(args, mesh, log)
    n_micro = stage_gate(args, mesh, log)
    expert_gate(args, mesh, log)
    device = resolve_device(args.device)
    # the tokenizer only reads (a local cache or none), so every rank
    # loads it at once; the persona cache is written on first use
    tokenizer = get_tokenizer(args.model_checkpoint, verbose=log)
    with main_first(mesh):
        train_set = make_persona(args, tokenizer, train=True)
        val_set = make_persona(args, tokenizer, train=False)
    args.num_clients = train_set.num_clients

    # the init draws no forward, so a ring model initializes as it is (the
    # reference goes through a full-attention twin: the same parameters)
    model = GPT2DoubleHeads(gpt2_config(args, tokenizer.vocab_size, mesh,
                                        attn))
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    if args.model in ("gpt2", "openai-gpt") and isinstance(
            tokenizer, HFTokenizerWrapper):
        # finetune from the HF weights when they are cached locally; the
        # byte tokenizer's rows would not line up with them
        imported = try_load_hf_pretrained(
            dict(model.named_parameters()), args.model_checkpoint,
            verbose=log, arch=model.config.arch)
        if imported is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(imported[name])
    batcher = FedBatcher(train_set, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    spe = batcher.steps_per_epoch()
    sched = gpt2_lr_schedule(args.lr_scale,
                             max(1, int(args.num_epochs * spe)))
    num_clients = padded_num_clients(args.num_clients, mesh)
    cls, extra = learner_factory(args, num_clients)
    if attn == "ring":
        loss_tr = make_gpt2_train_loss_seq(model, args.lm_coef, args.mc_coef)
        loss_val = make_gpt2_val_loss_seq(model)
    elif n_micro:
        # validation runs the plain forward, as the reference's does
        loss_tr = make_gpt2_train_loss_pp(mesh, model, n_micro, args.lm_coef)
        loss_val = make_gpt2_val_loss(model)
    else:
        loss_tr = make_gpt2_train_loss(model, args.lm_coef, args.mc_coef,
                                       args.moe_aux_weight)
        loss_val = make_gpt2_val_loss(model)
    learner = cls(model, args_to_config(args, num_clients=num_clients),
                  loss_tr, loss_val, lr_schedule=sched, device=device,
                  seed=args.seed, mesh=mesh, **extra)
    if log:
        print(f"gpt2: d = {learner.cfg.grad_size}, vocab "
              f"{model.config.vocab_size}, attn_impl "
              f"{model.config.attn_impl}, fused LM head "
              f"{model.config.fused_lm_head}, device {device}", flush=True)
    # this entry point draws no probe round: the restored cursor is the
    # only thing that moves the sampler before the loop
    ckpt = TrainCheckpointer(args, learner, batcher, entry="gpt2", log=log)
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
    total_rounds = cursor["total_rounds"] if cursor else 0
    n_epochs = int(math.ceil(args.num_epochs))
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
            nll0 = _token_nll(val0)
            if log:
                print(f"eval before start: nll={nll0:.4f} "
                      f"ppl={float(np.exp(min(nll0, 20.0))):.2f}")
            if writer:
                writer.add_scalar("nll", nll0, 0)
        for epoch in range(start_epoch, n_epochs):
            skip = skip0 if epoch == start_epoch else 0
            rounds_in_epoch = skip
            epoch_metrics = []
            # the one-round pipeline (or a K-round window; see
            # training/cv.py): an abort is seen one round (or window) late
            rounds = RoundFeed(learner, scan_k)

            def record(outs):
                for out in outs:
                    epoch_metrics.append(out)
                    history.append(out)
                    if log:
                        print(f"round {len(history)}: loss={out['loss']:.6f} "
                              f"up={out['upload_bytes']:.0f}B "
                              f"time={out['round_s'] * 1e3:.1f}ms",
                              flush=True)
                raise_on_abort(outs)

            # the next rounds' batches copy to the device while this one
            # computes; the lookahead feeds the offload pipeline's
            # gather-ahead
            for (ids, cols, mask), nxt in with_lookahead(device_prefetch(
                    feed.wrap(batcher.epoch(skip=skip)),
                    device=learner.device, workers=learner.worker_slice,
                    seq_cut=learner.seq_cut)):
                # the schedule decays per round: lr_at(total rounds so far)
                record(rounds.push(
                    ids, cols, mask, total_rounds,
                    next_client_ids=None if nxt is None else nxt[0]))
                last_batch = (ids, cols, mask)
                total_rounds += 1
                rounds_in_epoch += 1
                at_boundary = (args.do_test or nxt is None
                               or (max_rounds and total_rounds >= max_rounds))
                if ckpt.after_round(epoch, rounds_in_epoch, total_rounds,
                                    at_boundary,
                                    lambda: record(rounds.flush())):
                    return learner, {"preempted": True, "epoch": epoch + 1,
                                     "rounds": history}
                if args.do_test or (max_rounds and total_rounds >= max_rounds):
                    break
            # epoch boundary: pending writebacks land in the host rows, a
            # gather-ahead for a round that never ran is dropped, and the
            # last round (or window) is read
            learner.flush_offload()
            record(rounds.flush())
            train_time = timer()
            launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            val = learner.evaluate(val_batches(val_set,
                                               args.valid_batch_size))
            nll = _token_nll(val)
            row = {
                "epoch": epoch + 1,
                "lr": epoch_metrics[-1]["lr"],
                "train_loss": float(np.mean([m["loss"]
                                             for m in epoch_metrics])),
                "nll": nll,
                "ppl": float(np.exp(min(nll, 20.0))),
                "vocab": tokenizer.vocab_size,
                "mc_acc": float(val["metrics"][0]),
                "train_time": train_time,
                "test_time": timer(),
                "down (MiB)": learner.total_download_bytes / 2**20,
                "up (MiB)": learner.total_upload_bytes / 2**20,
                "total_time": timer.total_time,
            }
            if table:
                table.append(row)
            if writer:
                for tag in ("train_loss", "nll", "ppl", "mc_acc", "lr"):
                    writer.add_scalar(tag, row[tag], epoch + 1)
            row.update(rounds=history, launches_after_rounds=launches,
                       val_batches=val["num_batches"], last_batch=last_batch,
                       feed_s=feed.seconds, feed_batches=feed.batches)
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
    if not args.do_test:
        # every rank: on a model axis the weights are joined over it
        params = learner_params(learner)
        if log:
            _print_sample(args, model, params, tokenizer, val_set)
    if args.do_checkpoint:
        save_pretrained(args.checkpoint_path, learner, model.config,
                        tokenizer)
    return learner, row


def _print_sample(args, model, params, tokenizer, val_set):
    """A greedy reply to the first validation dialog's last utterance
    (the reference's qualitative sample), from ``params`` (every weight
    whole)."""
    import copy

    from commefficient_tpu_torch.data.persona import tokenize_tree
    from commefficient_tpu_torch.models.gpt2_generate import sample_reply
    try:
        gen_model = model
        cfg = model.config
        if cfg.fused_lm_head or any(
                c is not None for c in (cfg.tp, cfg.seq, cfg.ep)):
            # generation needs the logits, on this rank alone: the same
            # params through a twin without the fused head or the mesh's
            # inner axis (ring attention becomes full attention)
            cfg = copy.copy(cfg)
            cfg.fused_lm_head = False
            cfg.tp = cfg.seq = cfg.ep = None
            if cfg.attn_impl == "ring":
                cfg.attn_impl = "full"
            gen_model = GPT2DoubleHeads(cfg)
        raw = val_set._raw_dialogs()
        d = raw.get("valid", raw.get("train"))[0]
        utt = d["utterances"][0]
        persona = tokenize_tree(d["personality"], tokenizer)
        history = tokenize_tree(
            utt["history"][-(2 * args.max_history + 1):], tokenizer)
        reply = sample_reply(gen_model, params, tokenizer,
                             persona, history, max_seq_len=args.max_seq_len)
        print("context:", " / ".join(utt["history"][-2:]))
        print("sample reply:", tokenizer.decode(reply))
    except Exception as e:  # a qualitative sample must not end the run
        print(f"generation sample skipped ({type(e).__name__}: {e})")


def _token_nll(val) -> float:
    """The token-weighted nll of a validation pass (the reference's flat
    ``CrossEntropyLoss(ignore_index=-1)``); an empty split's placeholder
    metrics fall back to the dialog-weighted loss."""
    if np.size(val["metrics"]) >= 3:
        return float(val["metrics"][1]) / max(float(val["metrics"][2]), 1e-9)
    return float(val["loss"])


def build_gpt2_parser():
    """The CV flags with the reference's GPT2 defaults, plus the GPT2
    flags."""
    parser = add_gpt2_flags(build_parser(default_lr=4e-2))
    for a in parser._actions:
        if a.dest == "dataset_name":
            a.choices = sorted(set(a.choices) | {"SyntheticPersona"})
    parser.set_defaults(dataset_name="SyntheticPersona", model="gpt2-tiny",
                        local_batch_size=4, valid_batch_size=4,
                        num_workers=2, dataset_dir="./dataset/syn_persona")
    return parser


def _print_final(final: dict) -> None:
    for key in ("rounds", "launches_after_rounds", "val_batches",
                "last_batch", "feed_s", "feed_batches"):
        final.pop(key, None)
    print("final:", {k: round(v, 4) if isinstance(v, float) else v
                     for k, v in final.items()})


def mesh_rank_main(args, n_ranks: int, model: int = 1) -> None:
    """One rank of a ``--mesh`` run (the launcher's target); a seq, stage
    or expert axis is read from ``args.mesh``."""
    np.random.seed(args.seed)
    inner = mesh_inner_axes(args.mesh)
    mesh = make_mesh(n_ranks, model=model, seq=inner.get("seq", 1),
                     stage=inner.get("stage", 1),
                     expert=inner.get("expert", 1),
                     device_type=torch.device(args.device).type)
    main_rank = distributed.is_main()
    with profile_ctx(args.profile if main_rank else None):
        _, final = train(args, mesh=mesh)
    if main_rank:
        _print_final(final)


def main(argv=None):
    args = build_gpt2_parser().parse_args(argv)
    if args.do_test:
        args.num_epochs = 1
        args.k = min(args.k, 10)
        args.num_cols = min(args.num_cols, 100)
        args.num_rows = min(args.num_rows, 1)
    mesh = parse_mesh(args.mesh)
    round_up_workers_for_mesh(args, mesh)
    np.random.seed(args.seed)
    if args.serve_online:
        # train-while-serve: serve persona traffic, train on it through the
        # buffered event loop, hot-swap the new weights into the server
        # (one device: a mesh raises the reference's ValueError)
        from commefficient_tpu_torch.online import run_online
        if mesh is None:
            _refuse_unported(args)
        with profile_ctx(args.profile):
            _, _, results = run_online(args, mesh=mesh)
        print("final:", {k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in results.items()
                         if not isinstance(v, (list, dict))})
        return 0
    if mesh is not None:
        _refuse_unported(args)
        seq_gate(args, mesh)
        stage_gate(args, mesh)
        expert_gate(args, mesh)
        n = mesh_ranks(mesh)
        distributed.run(mesh_rank_main, n, (args, n, model_size(mesh)),
                        device_type=torch.device(args.device).type)
        return 0
    with profile_ctx(args.profile):
        _, final = train(args)
    _print_final(final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
