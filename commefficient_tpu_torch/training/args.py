"""CLI flags of the ported slice (subset of
``commefficient_tpu/training/args.py``, same names and defaults) plus
``--device``. Flags for what the port does not run yet parse, and the
config or entry point refuses them naming the ROADMAP item."""

from __future__ import annotations

import argparse

from commefficient_tpu_torch.config import ERROR_TYPES, MODES, FedConfig


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
    p.add_argument("--dp", action="store_true", dest="do_dp")
    p.add_argument("--client_state", choices=("dense", "sparse", "sketched"),
                   default="dense")
    p.add_argument("--client_k_dist", type=str, default="")
    # accepted so that a reference command line parses; refused by train()
    p.add_argument("--mesh", type=str, default="")
    p.add_argument("--client_state_offload", action="store_true")
    p.add_argument("--scan_rounds", type=int, default=1)
    return p


def args_to_config(args) -> FedConfig:
    fields = set(FedConfig.__dataclass_fields__)
    return FedConfig(**{k: v for k, v in vars(args).items() if k in fields})
