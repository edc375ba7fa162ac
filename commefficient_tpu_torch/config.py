"""Frozen run configuration (port of ``commefficient_tpu/config.py``).

Same field names, ``finalize``, ``grad_dim``, ``sketch_cols``,
``transmit_shape``, ``upload_floats_per_client`` and client-state
predicates as the reference, cut to the CV round's five modes.
``validate`` keeps the reference's checks that apply here and refuses,
with NotImplementedError naming the ROADMAP item, every feature the port
does not run yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from commefficient_tpu_torch.ops.countsketch import pad_cols

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")
CLIENT_STATE_REPS = ("dense", "sparse", "sketched")
DP_MODES = ("worker", "server")


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
    do_topk_down: bool = False
    client_k_dist: str = ""
    topk_approx_recall: float = 0.0
    # 'auto': the servers' exact top-k runs the fused kernels (true_topk's
    # resid epilogue, sketch's unsketch + select); 'off': the reference's
    # incumbent chain (estimates kernel, then a stable sort). Both give
    # the same bits: a speed switch, not a semantics switch.
    server_fused: str = "auto"

    # optimization
    local_momentum: float = 0.0
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    num_fedavg_epochs: int = 1
    fedavg_batch_size: int = -1
    fedavg_lr_decay: float = 1.0
    error_type: str = "none"
    lr_scale: float = 0.4
    max_grad_norm: Optional[float] = None

    # federated dimensions
    num_clients: int = 10
    num_workers: int = 1
    local_batch_size: int = 8  # -1 => each client's whole dataset per round
    microbatch_size: int = -1
    client_state: str = "dense"

    # differential privacy: each client's gradient is clipped to
    # l2_norm_clip; 'worker' adds noise_multiplier * sqrt(W) * N(0, 1) on
    # every client, 'server' noise_multiplier * N(0, 1) to the
    # uncompressed server's update
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0

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
        if self.dp_mode not in DP_MODES:
            raise ValueError(f"dp_mode must be one of {DP_MODES}")
        if not 0.0 <= self.topk_approx_recall <= 1.0:
            raise ValueError("topk_approx_recall must be in [0, 1] "
                             "(0 = exact top-k)")
        if self.server_fused not in ("auto", "off"):
            raise ValueError("server_fused must be 'auto' or 'off', "
                             f"got {self.server_fused!r}")
        if self.sketch_scheme not in ("tiled", "global"):
            raise ValueError("sketch_scheme must be 'tiled' or 'global', "
                             f"got {self.sketch_scheme!r}")
        if self.client_state not in CLIENT_STATE_REPS:
            raise ValueError(f"client_state must be one of "
                             f"{CLIENT_STATE_REPS}, got {self.client_state!r}")
        if self.grad_buckets < 1:
            raise ValueError("grad_buckets must be >= 1, got "
                             f"{self.grad_buckets}")
        if self.client_k_dist and self.mode != "local_topk":
            raise ValueError(
                "--client_k_dist draws a per-client transmit budget k_i <= "
                f"k, which only mode='local_topk' spends (got mode="
                f"{self.mode!r})")
        # parse-time invariants, reference utils.py:225-228
        if self.mode == "fedavg":
            if self.local_batch_size != -1:
                raise ValueError("fedavg requires local_batch_size == -1")
            if self.local_momentum != 0:
                raise ValueError("fedavg requires local_momentum == 0")
            if self.error_type != "none":
                raise ValueError("fedavg requires error_type == 'none'")
        # math-level invariants, reference fed_worker.py:221-228 and
        # fed_aggregator.py:572-576
        if self.error_type == "local" and self.mode in ("sketch",
                                                        "uncompressed"):
            raise ValueError(
                "local error accumulation is undefined for mode "
                f"{self.mode!r} (no support to zero)")
        if self.mode == "sketch" and self.local_momentum != 0:
            raise ValueError("momentum factor masking is impossible in "
                             "sketch space; local_momentum must be 0")
        if self.mode == "local_topk" and self.error_type == "virtual":
            raise ValueError("local_topk supports error_type in {none, local}")
        if self.mode == "true_topk" and self.error_type != "virtual":
            raise ValueError("true_topk requires error_type == 'virtual'")
        # what the port does not run yet
        for what, on, item in (
                ("--microbatch_size", self.microbatch_size != -1, "A5"),
                ("--topk_down", self.do_topk_down, "A5"),
                ("--client_k_dist", bool(self.client_k_dist), "A9"),
                ("--topk_approx_recall", self.topk_approx_recall > 0, "A2"),
                (f"--client_state {self.client_state}",
                 self.client_state != "dense", "A9"),
                ("--grad_buckets", self.grad_buckets > 1, "A9"),
                ("--batchnorm", self.do_batchnorm, "A6"),
                ("--sketch_scheme global", self.sketch_scheme != "tiled",
                 "A1")):
            if on:
                _todo(what, item)

    # --- per-client state -------------------------------------------------
    @property
    def needs_velocity_state(self) -> bool:
        return self.local_momentum > 0 and self.mode != "sketch"

    @property
    def needs_error_state(self) -> bool:
        return self.error_type == "local"

    @property
    def has_client_state(self) -> bool:
        """Whether the mode keeps per-client rows (``--topk_down``'s stale
        weights are refused, so only velocities and errors)."""
        return self.needs_velocity_state or self.needs_error_state

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
