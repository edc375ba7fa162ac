"""CLI flags of the ported slices (subset of
``commefficient_tpu/training/args.py``, same names and defaults) plus
``--device``; ``add_gpt2_flags`` adds the GPT2 entry point's. Flags for
what the port does not run yet parse, and the config or entry point
refuses them naming the ROADMAP item."""

from __future__ import annotations

import argparse

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
    # model/data
    p.add_argument("--model", default="ResNet9")
    p.add_argument("--dataset_name", default="Synthetic",
                   choices=["CIFAR10", "CIFAR100", "EMNIST", "ImageNet",
                            "Synthetic", "PERSONA", "Digits", "Patches32"])
    p.add_argument("--dataset_dir", default="./dataset")
    p.add_argument("--batchnorm", action="store_true", dest="do_batchnorm")
    p.add_argument("--nan_threshold", type=float, default=999)
    # compression
    p.add_argument("--k", type=int, default=50000)
    p.add_argument("--num_cols", type=int, default=500000)
    p.add_argument("--num_rows", type=int, default=5)
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
    p.add_argument("--client_k_dist", type=str, default="")
    # DP
    p.add_argument("--dp", action="store_true", dest="do_dp")
    p.add_argument("--dp_mode", choices=DP_MODES, default="worker")
    p.add_argument("--l2_norm_clip", type=float, default=1.0)
    p.add_argument("--noise_multiplier", type=float, default=0.0)
    # accepted so that a reference command line parses; refused by train()
    p.add_argument("--mesh", type=str, default="")
    p.add_argument("--client_state_offload", action="store_true")
    p.add_argument("--scan_rounds", type=int, default=1)
    return p


# --fused_ce auto turns the fused LM-head loss on at T >= this (the
# reference's threshold); the port refuses it there (ROADMAP.md A8)
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
                        "loop elsewhere); ring is not ported (A12)")
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
                        "torch.Generator path in the port")
    p.add_argument("--attn_dropout", choices=("auto", "output", "kernel"),
                   default="auto",
                   help="--attn_impl blockwise: 'auto' drops attention "
                        "probabilities inside the flash kernels when they "
                        "run and the output otherwise; 'output' always "
                        "the output; 'kernel' requires the kernels")
    p.add_argument("--fused_ce", choices=("auto", "on", "off"),
                   default="auto",
                   help="vocab-chunked fused LM-head loss: 'auto' means on "
                        f"at --max_seq_len >= {FUSED_CE_AUTO_T}; not "
                        "ported (A8), so 'on' and auto above the threshold "
                        "are refused")
    p.add_argument("--synthetic_personas", type=int, default=8,
                   help="SyntheticPersona: generated personas (= natural "
                        "clients)")
    p.add_argument("--synthetic_dialogs", type=int, default=4,
                   help="SyntheticPersona: dialogs per persona")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="model compute dtype (params stay float32)")
    # accepted so that a reference command line parses; refused by train()
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--serve_online", action="store_true")
    return p


def resolve_fused_ce(args) -> bool:
    """``--fused_ce`` -> whether the reference would run the fused
    LM-head loss."""
    if args.fused_ce != "auto":
        return args.fused_ce == "on"
    return args.attn_impl != "ring" and args.max_seq_len >= FUSED_CE_AUTO_T


def refuse_unported(args, extra=()):
    """Raise NotImplementedError naming its ROADMAP.md item for the first
    flag set that the port does not run: ``--mesh``,
    ``--client_state_offload``, ``--scan_rounds > 1``, then the entry
    point's own ``extra`` ``(flag, is_set, item)`` triples."""
    for flag, on, item in (
            ("--mesh", bool(args.mesh), "A12"),
            ("--client_state_offload", args.client_state_offload, "A9"),
            ("--scan_rounds > 1", args.scan_rounds > 1, "A7"),
            *extra):
        if on:
            raise NotImplementedError(f"{flag} is not ported to PyTorch "
                                      f"yet (ROADMAP.md {item})")


def args_to_config(args) -> FedConfig:
    fields = set(FedConfig.__dataclass_fields__)
    return FedConfig(**{k: v for k, v in vars(args).items() if k in fields})
