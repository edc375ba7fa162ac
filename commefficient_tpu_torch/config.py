"""Frozen run configuration (port of ``commefficient_tpu/config.py``).

Same field names, ``finalize``, ``grad_dim``, ``sketch_cols``,
``transmit_shape`` and ``upload_floats_per_client`` as the reference, cut
to the FetchSGD sketch-mode round this slice ports. ``validate`` keeps the
reference's checks that apply here and refuses, with NotImplementedError
naming the ROADMAP item, every mode and feature the port does not run yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from commefficient_tpu_torch.ops.countsketch import pad_cols

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")


def _todo(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


@dataclass(frozen=True)
class FedConfig:
    """The knobs of a federated run that the ported round reads (the
    data, model and schedule flags stay on the CLI's ``args``)."""

    mode: str = "sketch"
    do_batchnorm: bool = False
    nan_threshold: float = 999.0

    # compression
    k: int = 50_000
    num_cols: int = 500_000
    num_rows: int = 5
    sketch_scheme: str = "tiled"
    grad_buckets: int = 1

    # optimization
    local_momentum: float = 0.0
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    error_type: str = "none"
    lr_scale: float = 0.4
    max_grad_norm: Optional[float] = None

    # federated dimensions
    num_clients: int = 10
    num_workers: int = 1
    microbatch_size: int = -1

    # differential privacy
    do_dp: bool = False

    # derived (set by finalize): the flat-vector length
    grad_size: int = 0

    def finalize(self, grad_size: int) -> "FedConfig":
        """Return a copy with derived fields filled in and invariants checked."""
        cfg = dataclasses.replace(self, grad_size=int(grad_size))
        cfg.validate()
        return cfg

    @property
    def grad_dim(self) -> int:
        """Flat-vector length; the reference pads it for a model-axis mesh,
        which the port does not have (ROADMAP.md A12)."""
        return self.grad_size

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.error_type not in ERROR_TYPES:
            raise ValueError(f"error_type must be one of {ERROR_TYPES}, "
                             f"got {self.error_type!r}")
        if self.sketch_scheme not in ("tiled", "global"):
            raise ValueError("sketch_scheme must be 'tiled' or 'global', "
                             f"got {self.sketch_scheme!r}")
        if self.grad_buckets < 1:
            raise ValueError("grad_buckets must be >= 1, got "
                             f"{self.grad_buckets}")
        # the reference's math-level invariants (fed_worker.py:221-228)
        if self.error_type == "local" and self.mode in ("sketch",
                                                        "uncompressed"):
            raise ValueError(
                "local error accumulation is undefined for mode "
                f"{self.mode!r} (no support to zero)")
        if self.mode == "sketch" and self.local_momentum != 0:
            raise ValueError("momentum factor masking is impossible in "
                             "sketch space; local_momentum must be 0")
        # what slice 1 does not run yet
        if self.mode != "sketch":
            _todo(f"mode {self.mode!r}", "A4/A5")
        if self.sketch_scheme != "tiled":
            _todo("--sketch_scheme global", "A1")
        if self.do_dp:
            _todo("differential privacy (--dp)", "A5")
        if self.max_grad_norm is not None:
            _todo("--max_grad_norm", "A5")
        if self.local_momentum != 0 or self.error_type == "local":
            _todo("local momentum/error", "A5")
        if self.microbatch_size != -1:
            _todo("--microbatch_size", "A5")
        if self.grad_buckets > 1:
            _todo("--grad_buckets", "A9")
        if self.do_batchnorm:
            _todo("--batchnorm", "A6")

    # --- shapes -----------------------------------------------------------
    @property
    def sketch_cols(self) -> int:
        """Physical sketch columns: the tiled scheme pads num_cols up to a
        multiple of the 128-lane block (500_000 -> 500_096)."""
        if self.sketch_scheme == "tiled":
            return pad_cols(self.num_cols)
        return self.num_cols

    @property
    def transmit_shape(self) -> Tuple[int, ...]:
        if self.mode == "sketch":
            return (self.num_rows, self.sketch_cols)
        return (self.grad_dim,)

    @property
    def upload_floats_per_client(self) -> int:
        """Floats uploaded per client per round; sketch mode charges the
        physical (padded) table."""
        if self.mode == "sketch":
            return self.num_rows * self.sketch_cols
        if self.mode == "local_topk":
            return self.k
        return self.grad_size
