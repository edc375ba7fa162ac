"""CLI flags of the ported slices (subset of
``commefficient_tpu/training/args.py``, same names and defaults) plus
``--device``; ``add_gpt2_flags`` adds the GPT2 entry point's. Flags for
what the port does not run yet parse, and the config or entry point
refuses them naming the ROADMAP item. ``learner_factory`` picks the
learner of ``--server_mode`` with its ``--fault_*`` schedule."""

from __future__ import annotations

import argparse
import math
import os

from commefficient_tpu_torch.config import (DP_MODES, ERROR_TYPES, MODES,
                                            FedConfig)


def build_parser(default_lr: float = 0.4) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a CUDA device) or "
                        "'cpu' (the kernels' plain PyTorch versions)")
    # meta
    p.add_argument("--test", action="store_true", dest="do_test")
    p.add_argument("--mode", choices=MODES, default="sketch")
    p.add_argument("--seed", type=int, default=21)
    p.add_argument("--tensorboard", dest="use_tensorboard",
                   action="store_true",
                   help="export the epoch scalars under runs/ "
                        "(utils/logging.py ScalarWriter)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the "
                        "training loop to DIR/trace.json")
    # model/data
    p.add_argument("--model", default="ResNet9")
    p.add_argument("--dataset_name", default="Synthetic",
                   choices=["CIFAR10", "CIFAR100", "EMNIST", "ImageNet",
                            "Synthetic", "PERSONA", "Digits", "Patches32"])
    p.add_argument("--dataset_dir", default="./dataset")
    p.add_argument("--batchnorm", action="store_true", dest="do_batchnorm")
    p.add_argument("--nan_threshold", type=float, default=999)
    p.add_argument("--eval_before_start", action="store_true",
                   help="run a validation pass before training")
    p.add_argument("--checkpoint", action="store_true", dest="do_checkpoint",
                   help="export the final state to --checkpoint_path")
    p.add_argument("--checkpoint_path", default="./checkpoint")
    p.add_argument("--checkpoint_every_rounds", type=int, default=0,
                   help="write a crash-consistent step checkpoint every N "
                        "rounds (0 = off) under --checkpoint_path, with a "
                        ".latest pointer and bounded retention; also arms "
                        "the SIGTERM/SIGINT finish-round-save-exit handler")
    p.add_argument("--resume", default=None, metavar="auto|PATH",
                   help="resume training from a checkpoint: 'auto' picks "
                        "the newest valid checkpoint under "
                        "--checkpoint_path (fresh start if none), a path "
                        "names a file or directory. Restores learner "
                        "state, data-order cursor, and LR-schedule step; "
                        "a config-fingerprint mismatch fails loudly")
    p.add_argument("--finetune", action="store_true", dest="do_finetune",
                   help="start from the weights of --finetune_path (a "
                        "checkpoint file or directory) with a fresh "
                        "classifier head, the rest frozen")
    p.add_argument("--finetune_path", default="./finetune")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="model compute dtype (params stay float32); the CV "
                        "entry point takes bfloat16 for ResNet9 alone")
    # compression
    p.add_argument("--k", type=int, default=50000)
    p.add_argument("--num_cols", type=int, default=500000)
    p.add_argument("--num_rows", type=int, default=5)
    # the reference's CSVec memory knob, which its sketch ignores; parsed so
    # that checkpoint fingerprints agree between the two packages
    p.add_argument("--num_blocks", type=int, default=20)
    p.add_argument("--sketch_scheme", choices=("tiled", "global"),
                   default="tiled")
    p.add_argument("--grad_buckets", type=int, default=1)
    p.add_argument("--topk_down", action="store_true", dest="do_topk_down")
    p.add_argument("--topk_approx_recall", type=float, default=0.0)
    p.add_argument("--server_fused", choices=("auto", "off"),
                   default="auto",
                   help="'auto' = the servers' exact top-k runs the fused "
                        "kernels; 'off' = the estimates kernel and a "
                        "stable sort (the same bits)")
    # optimization
    p.add_argument("--local_momentum", type=float, default=0.0)
    p.add_argument("--virtual_momentum", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--num_epochs", type=float, default=24)
    p.add_argument("--num_fedavg_epochs", type=int, default=1)
    p.add_argument("--fedavg_batch_size", type=int, default=-1)
    p.add_argument("--fedavg_lr_decay", type=float, default=1.0)
    p.add_argument("--error_type", choices=ERROR_TYPES, default="none")
    p.add_argument("--lr_scale", type=float, default=default_lr)
    p.add_argument("--pivot_epoch", type=float, default=5)
    p.add_argument("--max_grad_norm", type=float, default=None)
    p.add_argument("--scalar_lr_factor", type=float, default=None,
                   help="LR multiplier of the size-1 parameters (Fixup's "
                        "scalar biases and scales); None = 0.1 for Fixup* "
                        "models, 1.0 otherwise")
    # federated dimensions
    p.add_argument("--num_clients", type=int, default=None,
                   help="None = the dataset's natural partition count")
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--local_batch_size", type=int, default=8)
    p.add_argument("--valid_batch_size", type=int, default=8)
    p.add_argument("--microbatch_size", type=int, default=-1)
    p.add_argument("--iid", action="store_true", dest="do_iid")
    p.add_argument("--client_state", choices=("dense", "sparse", "sketched"),
                   default="dense")
    p.add_argument("--client_sketch_rows", type=int, default=3)
    p.add_argument("--client_sketch_cols", type=int, default=128)
    p.add_argument("--client_state_offload", action="store_true",
                   help="keep the client rows in host memory and move only "
                        "the sampled ones to the device each round")
    p.add_argument("--offload_pipeline_depth", type=int, default=2,
                   help="rounds of output rows that wait on the device "
                        "before they are written back to the host")
    p.add_argument("--client_k_dist", type=str, default="",
                   help="per-client transmit budgets under local_topk, "
                        "'uniform:lo,hi' fractions of --k")
    # DP
    p.add_argument("--dp", action="store_true", dest="do_dp")
    p.add_argument("--dp_mode", choices=DP_MODES, default="worker")
    p.add_argument("--l2_norm_clip", type=float, default=1.0)
    p.add_argument("--noise_multiplier", type=float, default=0.0)
    p.add_argument("--scan_rounds", type=int, default=1,
                   help="rounds a window (FedLearner.train_rounds_scan): "
                        "the same trajectory, one host read of the metrics "
                        "a window; below 1 means 1")
    # the buffered server and the fault model (federated/{buffer,faults}.py)
    p.add_argument("--server_mode", choices=("sync", "buffered"),
                   default="sync",
                   help="'buffered' = FedBuff-style asynchronous server: "
                        "contributions land in a --buffer_m slot buffer "
                        "as they arrive (per --fault_* schedule) and the "
                        "server applies whenever it fills, scaling each "
                        "by staleness 1/(1+tau)^alpha. With no --fault_"
                        "seed it runs lock-step and matches sync "
                        "bit-for-bit at alpha=0")
    p.add_argument("--buffer_m", type=int, default=0,
                   help="buffered server's apply threshold M; 0 = "
                        "num_workers")
    p.add_argument("--staleness_alpha", type=float, default=0.0,
                   help="staleness-discount exponent alpha in "
                        "s(tau)=1/(1+tau)^alpha (0 = no discounting)")
    p.add_argument("--client_quarantine", action="store_true",
                   help="per-client NaN quarantine: a non-finite client "
                        "contribution is excluded from the aggregate "
                        "(instead of aborting the run) and its client "
                        "benched for --quarantine_rounds applied rounds; "
                        "only a post-exclusion server-side breach trips "
                        "the sticky abort")
    p.add_argument("--quarantine_rounds", type=int, default=5,
                   help="bench duration for a client whose update came "
                        "back non-finite")
    p.add_argument("--fault_seed", type=int, default=None,
                   help="enable the seeded client fault model "
                        "(federated/faults.py): per-(round, client) "
                        "dropout/crash/latency draws, replayable from "
                        "this seed. None = no faults (lock-step)")
    p.add_argument("--fault_dropout_prob", type=float, default=0.0,
                   help="per-(round, client) probability the client never "
                        "starts")
    p.add_argument("--fault_crash_prob", type=float, default=0.0,
                   help="probability a started client crashes mid-round "
                        "(pulls weights, never uploads)")
    p.add_argument("--straggler_frac", type=float, default=0.0,
                   help="fraction of clients that are CHRONIC stragglers "
                        "under this fault seed (a per-client property)")
    p.add_argument("--straggler_mult", type=float, default=10.0,
                   help="latency multiplier for chronic stragglers")
    p.add_argument("--base_latency", type=float, default=1.0,
                   help="median client round-trip in simulated time units")
    p.add_argument("--latency_sigma", type=float, default=0.25,
                   help="log-normal spread of client latency")
    p.add_argument("--dispatch_interval", type=float, default=None,
                   help="simulated time between cohort dispatches "
                        "(buffered server); None = base_latency")
    # serving and train-while-serve (serving/, online/)
    p.add_argument("--serve_personalized", action="store_true",
                   help="serve per-user weight deltas from the sparse "
                        "client rows (serving/personalize.py): a request's "
                        "row is added to the served params at admission and "
                        "taken out at eviction; needs --client_state sparse")
    p.add_argument("--serve_sample", choices=("greedy", "topk"),
                   default="greedy",
                   help="serving-time sampling of the decode engine")
    p.add_argument("--speculate_k", type=int, default=0,
                   help="speculative decoding draft length (serving/"
                        "speculative.py); greedy replies are unchanged, "
                        "topk keeps its distribution. 0 disables")
    p.add_argument("--kv_quant", choices=("none", "int8", "int4"),
                   default="none",
                   help="codec of the paged KV pools (ops/kv_quant.py): "
                        "int8 or nibble-packed int4 pages with per-page, "
                        "per-head float32 scales")
    p.add_argument("--serve_tp", type=int, default=1,
                   help="tensor-parallel serving degree (parallel/tp.py "
                        "+ serving/decode.py): the KV pools shard their "
                        "heads along the mesh's 'model' axis; requires "
                        "--mesh with model=<this value>. 1 = one device")
    p.add_argument("--serve_slots", type=int, default=8,
                   help="continuous-batching slots (the decode batch)")
    p.add_argument("--serve_disagg", action="store_true",
                   help="step the decode pool first and admit at most a "
                        "quarter of the slots' prefills a step (needs the "
                        "paged cache and >= 2 slots)")
    p.add_argument("--serve_online", action="store_true",
                   help="train-while-serve (online/): serve persona "
                        "traffic, train the buffered cohorts on it and "
                        "hot-swap the new base weights into the server; "
                        "needs --server_mode buffered and "
                        "--serve_personalized")
    p.add_argument("--online_train_every", type=int, default=4,
                   help="--serve_online: one buffered cohort every this "
                        "many served interactions")
    p.add_argument("--online_swap_every", type=int, default=2,
                   help="--serve_online: a hot swap every this many "
                        "buffered applies")
    # accepted so that a reference command line parses; refused by train()
    p.add_argument("--mesh", type=str, default="")
    return p


# --fused_ce auto turns the fused LM-head loss on at T >= this (the
# reference's threshold): there the (B*C*T, vocab) logits would dominate
# the round's memory
FUSED_CE_AUTO_T = 512


def add_gpt2_flags(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The GPT2/PersonaChat flags (``build_gpt2_parser`` of the reference's
    ``training/gpt2.py`` and its ``args.py``), same names and defaults."""
    p.add_argument("--model_checkpoint", type=str, default="gpt2",
                   help="tokenizer name; read from a local cache only, "
                        "else the byte-level tokenizer")
    p.add_argument("--max_seq_len", type=int, default=256)
    p.add_argument("--attn_impl", choices=("full", "blockwise", "ring"),
                   default="full",
                   help="full = materialized (T, T) scores; blockwise = "
                        "the flash kernels on CUDA (the online-softmax "
                        "loop elsewhere); ring = sequence-parallel over "
                        "the --mesh seq axis (parallel/seq.py)")
    p.add_argument("--vocab_pad_to", type=int, default=None,
                   help="pad the vocab (embedding rows) to at least this "
                        "size: 50262 gives GPT2-small's d with the byte "
                        "tokenizer")
    p.add_argument("--num_candidates", type=int, default=2)
    p.add_argument("--max_history", type=int, default=2)
    p.add_argument("--lm_coef", type=float, default=1.0)
    p.add_argument("--mc_coef", type=float, default=1.0)
    p.add_argument("--personality_permutations", type=int, default=1)
    p.add_argument("--dropout_impl", choices=("xla", "xla_rbg"),
                   default="xla",
                   help="dropout bit source; both are the same seeded "
                        "torch.Generator path in the port (\"tpu_bits\", "
                        "the hardware-RNG kernel, is set on the parsed "
                        "namespace, as in the reference)")
    p.add_argument("--attn_dropout", choices=("auto", "output", "kernel"),
                   default="auto",
                   help="--attn_impl blockwise: 'auto' drops attention "
                        "probabilities inside the flash kernels when they "
                        "run and the output otherwise; 'output' always "
                        "the output; 'kernel' requires the kernels")
    p.add_argument("--fused_ce", choices=("auto", "on", "off"),
                   default="auto",
                   help="vocab-chunked fused LM-head loss "
                        "(ops/fused_ce.py): 'auto' means on at "
                        f"--max_seq_len >= {FUSED_CE_AUTO_T} (off under "
                        "ring attention)")
    p.add_argument("--fused_lm_head", action="store_true",
                   help="legacy alias for --fused_ce on")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per pipeline shard for "
                        "--mesh ...,stage=S (parallel/pp.py); 0 = the "
                        "stage count (a full pipeline with the classic "
                        "1-(S-1)/(n+S-1) bubble)")
    p.add_argument("--synthetic_personas", type=int, default=8,
                   help="SyntheticPersona: generated personas (= natural "
                        "clients)")
    p.add_argument("--synthetic_dialogs", type=int, default=4,
                   help="SyntheticPersona: dialogs per persona")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="Switch-MoE FFN blocks with this many experts "
                        "(ops/moe.py); 0 = dense MLP")
    p.add_argument("--moe_capacity_factor", type=float, default=1.25)
    p.add_argument("--moe_aux_weight", type=float, default=1e-2,
                   help="weight of the Switch load-balancing aux loss "
                        "added to the training objective")
    return p


def resolve_fused_ce(args, mesh=None) -> bool:
    """``--fused_ce`` (and the legacy ``--fused_lm_head``, which means
    'on' and conflicts with 'off') -> whether the model returns hidden
    states for the fused LM-head loss (the reference's
    ``training/args.py:376-394``): 'auto' is off under ring attention or
    a seq/stage mesh axis (``mesh``: a joined mesh or a ``MeshSpec``),
    an explicit 'on' passes through (and the model refuses it with
    ring)."""
    choice = args.fused_ce
    if args.fused_lm_head:
        if choice == "off":
            raise ValueError("--fused_lm_head (legacy alias for "
                             "--fused_ce on) conflicts with --fused_ce off")
        choice = "on"
    if choice != "auto":
        return choice == "on"
    if args.attn_impl == "ring":
        return False
    from commefficient_tpu_torch.parallel.mesh import inner_size
    if any(inner_size(mesh, axis) > 1 for axis in ("seq", "stage")):
        return False
    return args.max_seq_len >= FUSED_CE_AUTO_T


def _mesh_kv(spec: str) -> dict:
    kv = {}
    for part in spec.split(","):
        key, sep, val = part.partition("=")
        if not sep:
            raise ValueError(f"--mesh: expected key=value, got {part!r}")
        kv[key.strip()] = val.strip()
    unknown = set(kv) - {"clients", "seq", "model", "stage", "expert"}
    if unknown:
        raise ValueError(f"--mesh: unknown axes {sorted(unknown)} "
                         f"(supported: clients=N[,seq=M | ,model=M | "
                         f",stage=S | ,expert=E])")
    return kv


def mesh_inner_axes(spec: str) -> dict:
    """``--mesh``'s inner axis sizes (``seq``, ``model``, ``stage``,
    ``expert``; 1 where absent), checked as ``parse_mesh`` checks them."""
    if not spec:
        return {}
    kv = _mesh_kv(spec)
    inner = {}
    for name in ("seq", "model", "stage", "expert"):
        inner[name] = int(kv.get(name, 1))
        if inner[name] <= 0:
            raise ValueError(f"--mesh: {name} must be positive, "
                             f"got {inner[name]}")
    return inner


def parse_mesh(spec: str):
    """``--mesh`` string -> a ``parallel.mesh.MeshSpec`` (None for no
    mesh), in the reference's grammar and messages (``training/args.py:
    441-487``): ``clients=N[,seq=M | ,model=M | ,stage=S | ,expert=E]``,
    the inner axes mutually exclusive. ``clients=all`` (or ``auto``)
    means ``WORLD_SIZE`` under ``torchrun``, else every CUDA device (one
    rank without one). The ranks build the mesh itself
    (``parallel.mesh.make_mesh``) once they have joined."""
    if not spec:
        return None
    from commefficient_tpu_torch.parallel.mesh import MeshSpec
    kv = _mesh_kv(spec)
    inner = mesh_inner_axes(spec)

    def spec_of(n):
        # the reference's make_mesh check, after the sizes
        if sum(s > 1 for s in inner.values()) > 1:
            raise ValueError("choose ONE inner axis: seq (ring attention), "
                             "model (tensor parallelism), stage (GPipe "
                             "pipeline), or expert (MoE expert "
                             "parallelism)")
        return MeshSpec(clients=n, inner=inner)
    clients = kv.get("clients", "all")
    if clients in ("all", "auto"):
        if "WORLD_SIZE" in os.environ:
            n = int(os.environ["WORLD_SIZE"])
        else:
            import torch
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 1
        return spec_of(max(1, n // math.prod(inner.values())))
    n = int(clients)
    if n <= 0:
        raise ValueError(f"--mesh: clients must be positive, got {n}")
    return spec_of(n)


def round_up_workers_for_mesh(args, mesh) -> int:
    """Number of mesh shards along ``clients``; loudly rounds
    ``args.num_workers`` up to a multiple of it (the batch worker axis is
    split over that mesh axis, so its width must divide evenly — the
    reference instead silently DROPS the tail chunk when procs don't divide
    clients, fed_aggregator.py:230-237, a quirk SURVEY.md says not to keep)."""
    if mesh is None:
        return 1
    from commefficient_tpu_torch.parallel.mesh import clients_size
    from commefficient_tpu_torch.utils.params import round_up
    n_shards = clients_size(mesh)
    if args.num_workers % n_shards:
        padded = round_up(args.num_workers, n_shards)
        if os.environ.get("RANK", "0") == "0":   # torchrun's other ranks
            print(f"--mesh: rounding num_workers {args.num_workers} -> "
                  f"{padded} (must be a multiple of the {n_shards}-way "
                  f"'clients' axis)")
        args.num_workers = padded
    return n_shards


def make_fault_model(args, num_clients: int):
    """``--fault_*`` flags -> a seeded ``FaultModel``, or None without
    ``--fault_seed`` (lock-step)."""
    if getattr(args, "fault_seed", None) is None:
        return None
    from commefficient_tpu_torch.federated.faults import FaultModel
    return FaultModel(
        args.fault_seed, num_clients,
        base_latency=args.base_latency,
        latency_sigma=args.latency_sigma,
        straggler_frac=args.straggler_frac,
        straggler_mult=args.straggler_mult,
        dropout_prob=args.fault_dropout_prob,
        crash_prob=args.fault_crash_prob)


def learner_factory(args, num_clients: int):
    """(learner class, extra constructor kwargs) for ``--server_mode``.
    The buffered server takes the fault flags on its host event loop; the
    sync server has no fault model, so ``--fault_seed`` with it raises
    instead of doing nothing."""
    if getattr(args, "server_mode", "sync") != "buffered":
        if getattr(args, "fault_seed", None) is not None:
            raise ValueError(
                "--fault_seed needs --server_mode buffered (the sync "
                "fault baseline is driven by results.py --straggler)")
        from commefficient_tpu_torch.federated.api import FedLearner
        return FedLearner, {}
    from commefficient_tpu_torch.federated.buffer import BufferedFedLearner
    return BufferedFedLearner, {
        "fault_model": make_fault_model(args, num_clients),
        "dispatch_interval": getattr(args, "dispatch_interval", None),
    }


def refuse_buffered_scan(args) -> None:
    """The buffered server's refusal of ``--scan_rounds`` > 1."""
    if (scan_rounds(args) > 1
            and getattr(args, "server_mode", "sync") != "sync"):
        raise ValueError("--scan_rounds > 1 is a sync-mode optimization; "
                         "the buffered server dispatches cohorts through "
                         "a host event loop")


def scan_rounds(args) -> int:
    """``--scan_rounds``, at least 1."""
    return max(1, int(getattr(args, "scan_rounds", 1) or 1))


def args_to_config(args, **overrides) -> FedConfig:
    """The ``FedConfig`` of the parsed flags; a ``--mesh`` with a
    ``model`` axis sets the config's mesh shape, so that its checks
    (``--serve_tp``, the model axis's refusals) see it."""
    fields = set(FedConfig.__dataclass_fields__)
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    mesh = parse_mesh(getattr(args, "mesh", "") or "")
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        kwargs.update(mesh_shape=tuple(mesh.shape.values()),
                      mesh_axis_names=mesh.axis_names)
    kwargs.update(overrides)
    return FedConfig(**kwargs)


def mesh_ranks(mesh) -> int:
    """The ranks a parsed ``--mesh`` launches: clients x the inner axis
    (model, seq, stage or expert)."""
    from commefficient_tpu_torch.parallel.mesh import clients_size, inner_size
    return clients_size(mesh) * math.prod(
        inner_size(mesh, axis) for axis in ("model", "seq", "stage",
                                            "expert"))
