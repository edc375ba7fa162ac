"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A CUDA
request on a machine without a CUDA device raises: nothing falls back to
the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, checked to exist.

    On CUDA this also turns TF32 off for cuDNN convolutions and cuBLAS
    matmuls: the reference trains in full float32, and cuDNN's float32
    convolutions default to TF32 (about three decimal digits). And it
    makes cuDNN choose deterministic algorithms, without autotuning: the
    reference's trajectories are bitwise reproducible, and cuDNN's
    default backward algorithms add with atomics in an order that
    changes from run to run."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass --device cpu (device='cpu') to run on "
                "the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
