"""Frozen run configuration (port of ``commefficient_tpu/config.py``).

Same field names, ``finalize``, ``grad_dim``, ``sketch_cols``,
``transmit_shape``, ``upload_floats_per_client`` and client-state
predicates as the reference, cut to the fields the ported round reads.
``validate`` keeps the reference's checks that apply here, with its
messages. ``--topk_approx_recall`` runs the exact top-k: the reference's
``lax.approx_max_k`` is intentionally inexact, and exact selection meets
any recall target.
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
SERVER_MODES = ("sync", "buffered")


#: head counts of the checkpoint families the serving stack loads: what
#: --serve_tp must divide for the per-head KV (and kv_quant scale row)
#: sharding to split cleanly. Unknown checkpoints defer to the
#: DecodeEngine's n_head check at engine construction.
_KNOWN_N_HEAD = {"gpt2": 12, "gpt2-medium": 16, "gpt2-large": 20,
                 "gpt2-xl": 25, "openai-gpt": 12}


@dataclass(frozen=True)
class FedConfig:
    """The knobs of a federated run that the ported round reads (the
    data, model and schedule flags stay on the CLI's ``args``)."""

    mode: str = "sketch"
    # seeds the --client_k_dist budgets and the sketched client codec's
    # hashes (the reference's ``FedConfig.seed``)
    seed: int = 21
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
    # the reference's approximate top-k recall target; the port selects
    # exactly at any value (exact selection meets every recall target)
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
    # per-client rows in host arenas, only the W sampled rows on the
    # device a round (federated/client_store.HostArenaStore,
    # api.HostOffloadPipeline)
    client_state_offload: bool = False
    # the rows' representation: dense (d,), sparse (cap = k index/value
    # pairs) or sketched (a per-client (r, c) global CountSketch)
    client_state: str = "dense"
    client_sketch_rows: int = 3
    client_sketch_cols: int = 128
    # rounds of output rows the offload pipeline keeps pending before it
    # writes them back to the arenas (2 = double buffering)
    offload_pipeline_depth: int = 2

    # differential privacy: each client's gradient is clipped to
    # l2_norm_clip; 'worker' adds noise_multiplier * sqrt(W) * N(0, 1) on
    # every client, 'server' noise_multiplier * N(0, 1) to the
    # uncompressed server's update
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0

    # the server's aggregation: 'sync' applies every round's cohort;
    # 'buffered' (federated/buffer.py, FedBuff) lands contributions in a
    # buffer of buffer_m slots (0 = num_workers) and applies when it
    # fills, each scaled by 1/(1+tau)^staleness_alpha. With no fault
    # model and alpha 0 it is the sync round bitwise.
    server_mode: str = "sync"
    buffer_m: int = 0
    staleness_alpha: float = 0.0
    # per-client NaN quarantine: a non-finite contribution is excluded
    # from the aggregate and its client benched for quarantine_rounds
    # applied rounds; only a post-exclusion breach trips the sticky abort
    client_quarantine: bool = False
    quarantine_rounds: int = 5

    # serving and train-while-serve (serving/, online/)
    serve_personalized: bool = False
    serve_sample: str = "greedy"
    speculate_k: int = 0
    kv_quant: str = "none"
    serve_tp: int = 1
    serve_slots: int = 8
    serve_disagg: bool = False
    serve_online: bool = False
    online_train_every: int = 4
    online_swap_every: int = 2

    # the mesh the run shards over (the learner sets it from its mesh)
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("clients",)
    model_checkpoint: str = "gpt2"
    # GPT2's static sequence length: a seq mesh axis cuts it into blocks
    max_seq_len: int = 256

    # derived (set by finalize). grad_size is the LOGICAL model dimension
    # (what the byte accounting charges); grad_size_pad the PHYSICAL
    # flat-vector length, rounded up so a 'model' mesh axis can split it
    # evenly (pad coordinates stay zero: no gradient, decay or update)
    grad_size: int = 0
    grad_size_pad: int = 0

    def finalize(self, grad_size: int, pad_to: int = 1) -> "FedConfig":
        """Return a copy with derived fields filled in and invariants checked."""
        from commefficient_tpu_torch.utils.params import round_up
        cfg = dataclasses.replace(self, grad_size=int(grad_size),
                                  grad_size_pad=round_up(grad_size, pad_to))
        cfg.validate()
        return cfg

    @property
    def grad_dim(self) -> int:
        """Physical flat-vector length (grad_size for configs built without
        finalize)."""
        return self.grad_size_pad or self.grad_size

    @property
    def model_axis(self) -> int:
        """The mesh's ``model`` axis size (1 without one)."""
        if "model" not in self.mesh_axis_names:
            return 1
        return int(self.mesh_shape[self.mesh_axis_names.index("model")])

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
        if self.offload_pipeline_depth < 1:
            raise ValueError("offload_pipeline_depth must be >= 1, got "
                             f"{self.offload_pipeline_depth}")
        # reference config.py:301-320, 394-433, 450-459
        if self.client_state not in CLIENT_STATE_REPS:
            raise ValueError(f"client_state must be one of "
                             f"{CLIENT_STATE_REPS}, got {self.client_state!r}")
        if self.client_state == "sparse":
            if self.mode != "local_topk":
                raise ValueError(
                    "client_state='sparse' stores local_topk residual rows "
                    "as (k,) index/value pairs; mode "
                    f"{self.mode!r} keeps no k-sparse client rows")
            if self.do_topk_down:
                raise ValueError(
                    "client_state='sparse' cannot represent topk_down "
                    "stale-weight rows (dense by construction); drop "
                    "--topk_down or use client_state='dense'")
        if self.serve_personalized and self.client_state != "sparse":
            raise ValueError(
                "--serve_personalized applies per-user O(k) idx/val "
                "weight deltas at serving time, which only the sparse "
                "client-state rows provide; got client_state="
                f"{self.client_state!r} — add --client_state sparse")
        if self.serve_sample not in ("greedy", "topk"):
            raise ValueError(f"serve_sample must be 'greedy' or 'topk', "
                             f"got {self.serve_sample!r}")
        if self.speculate_k < 0:
            raise ValueError(
                f"--speculate_k must be >= 0, got {self.speculate_k}: "
                f"use a draft length >= 1 to speculate, or 0 to serve "
                f"non-speculatively")
        if self.kv_quant not in ("none", "int8", "int4"):
            raise ValueError(
                f"--kv_quant must be 'none', 'int8' or 'int4', got "
                f"{self.kv_quant!r}")
        if self.serve_tp < 1:
            raise ValueError(f"--serve_tp must be >= 1, got "
                             f"{self.serve_tp}")
        if self.serve_slots < 1:
            raise ValueError(f"--serve_slots must be >= 1, got "
                             f"{self.serve_slots}")
        if self.serve_tp > 1:
            if "model" not in self.mesh_axis_names:
                raise ValueError(
                    f"--serve_tp {self.serve_tp} shards the served "
                    f"params and KV heads along a 'model' mesh axis, "
                    f"but the mesh has axes "
                    f"{self.mesh_axis_names} — add model="
                    f"{self.serve_tp} to --mesh")
            msize = self.mesh_shape[
                self.mesh_axis_names.index("model")]
            if msize != self.serve_tp:
                raise ValueError(
                    f"--serve_tp {self.serve_tp} does not match the "
                    f"mesh's model axis size {msize}; the decode step "
                    f"shards across exactly the model axis")
            if self.kv_quant != "none":
                # quantized pools carry (num_pages, n_head) f32 scale
                # rows that shard per head with the pools; the split
                # must be exact or a head's scale would straddle shards
                n_head = _KNOWN_N_HEAD.get(self.model_checkpoint)
                if n_head is not None and n_head % self.serve_tp:
                    raise ValueError(
                        f"--kv_quant {self.kv_quant} per-head scale "
                        f"rows cannot shard cleanly: "
                        f"{self.model_checkpoint!r} has {n_head} heads, "
                        f"not divisible by --serve_tp {self.serve_tp}")
        if self.serve_disagg and self.serve_slots < 2:
            raise ValueError(
                f"--serve_disagg splits serving into prefill and decode "
                f"slot pools; --serve_slots {self.serve_slots} < 2 "
                f"cannot hold both pools")
        if self.serve_online:
            if self.server_mode != "buffered":
                raise ValueError(
                    "--serve_online interleaves federated cohorts with "
                    "decode steps on the buffered host event loop "
                    "(federated/buffer.py pump_events); run with "
                    "--server_mode buffered")
            if not self.serve_personalized:
                raise ValueError(
                    "--serve_online trains the sparse client rows the "
                    "server reads as per-user deltas — without "
                    "--serve_personalized (and --client_state sparse) "
                    "there is nothing for live traffic to personalize")
        if self.online_train_every < 1 or self.online_swap_every < 1:
            raise ValueError(
                f"online cadences must be >= 1, got online_train_every="
                f"{self.online_train_every}, online_swap_every="
                f"{self.online_swap_every}")
        if self.client_state == "sketched":
            if self.error_type != "local":
                raise ValueError(
                    "client_state='sketched' sketches per-client error "
                    f"rows; error_type {self.error_type!r} keeps no "
                    "per-client error state")
            if self.local_momentum > 0 and self.mode != "sketch":
                raise ValueError(
                    "client_state='sketched' cannot carry local momentum "
                    "rows (momentum factor masking needs the exact "
                    "support); set local_momentum 0 or use "
                    "client_state='dense'")
            if self.do_topk_down:
                raise ValueError(
                    "client_state='sketched' cannot represent topk_down "
                    "stale-weight rows; drop --topk_down or use "
                    "client_state='dense'")
            if self.client_sketch_rows < 1 or self.client_sketch_cols < 1:
                raise ValueError(
                    "client_state='sketched' needs client_sketch_rows >= 1 "
                    "and client_sketch_cols >= 1, got "
                    f"({self.client_sketch_rows}, {self.client_sketch_cols})")
        if self.grad_buckets < 1:
            raise ValueError("grad_buckets must be >= 1, got "
                             f"{self.grad_buckets}")
        if self.grad_buckets > 1:
            if self.server_mode == "buffered":
                raise ValueError(
                    "grad_buckets > 1 is incompatible with "
                    "server_mode='buffered' (the contribution buffer "
                    "deposits whole transmits; bucketing only restructures "
                    "the lock-step reduce)")
            if self.mode == "sketch" and (
                    self.do_dp or self.max_grad_norm is not None):
                raise ValueError(
                    "grad_buckets > 1 requires a dense transmit; with "
                    "mode='sketch' under DP or gradient clipping each "
                    "worker transmits an already-compressed (r, c) table, "
                    "so there is nothing left to bucket")
        if self.server_mode not in SERVER_MODES:
            raise ValueError(f"server_mode must be one of {SERVER_MODES}, "
                             f"got {self.server_mode!r}")
        if self.staleness_alpha < 0:
            raise ValueError("staleness_alpha must be >= 0")
        if self.quarantine_rounds < 1:
            raise ValueError("quarantine_rounds must be >= 1")
        if self.server_mode == "buffered" and self.effective_buffer_m < 1:
            raise ValueError("buffered server_mode needs buffer_m >= 1")
        if self.client_k_dist:
            if self.mode != "local_topk":
                raise ValueError(
                    "--client_k_dist draws a per-client transmit budget "
                    "k_i <= k, which only mode='local_topk' spends (got "
                    f"mode={self.mode!r}); sketch capacity heterogeneity "
                    "is a different axis and is not implemented")
            # fail at validate() time, not first-round time
            from commefficient_tpu_torch.federated.faults import \
                parse_k_dist
            parse_k_dist(self.client_k_dist)
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

    # --- per-client state -------------------------------------------------
    @property
    def needs_velocity_state(self) -> bool:
        return self.local_momentum > 0 and self.mode != "sketch"

    @property
    def needs_error_state(self) -> bool:
        return self.error_type == "local"

    @property
    def needs_client_weights(self) -> bool:
        """``--topk_down``: each client keeps the stale weights it last
        reconstructed."""
        return self.do_topk_down

    @property
    def effective_buffer_m(self) -> int:
        """Buffer slots M of the buffered server (0 => num_workers, the
        lock-step default)."""
        return self.buffer_m if self.buffer_m > 0 else self.num_workers

    @property
    def client_k_active(self) -> bool:
        """Whether the round takes per-client budgets (validate()
        guarantees local_topk when set)."""
        return bool(self.client_k_dist)

    @property
    def has_client_state(self) -> bool:
        """Whether the mode keeps per-client rows: velocities, errors or
        ``--topk_down``'s stale weights."""
        return (self.needs_velocity_state or self.needs_error_state
                or self.needs_client_weights)

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
