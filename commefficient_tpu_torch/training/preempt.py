"""Preemption tolerance of the entry points (port of
``commefficient_tpu/training/preempt.py``).

* ``PreemptionGuard``: latches SIGTERM/SIGINT. The first signal sets
  ``triggered``: the loop finishes the round in flight, saves and exits
  0; a second signal raises at once.
* ``config_fingerprint``: the trajectory-relevant flags, stored in every
  periodic checkpoint and compared on resume, so a resume under another
  config fails loudly. It leaves out what does not change the
  trajectory: ``--scan_rounds``, ``--client_state_offload``, ``--device``,
  and the logging and checkpoint flags.
* ``TrainCheckpointer``: ``--checkpoint_every_rounds`` and ``--resume``,
  and the save policy both entry points' loops follow (``after_round``,
  ``at_epoch_end``). ``save`` writes a step checkpoint whose cursor
  holds the epoch and round, the batcher's data-order cursor, for the
  buffered server the event loop's cursor and, under ``--serve_online``,
  the online loop's (``online=``: traffic position, cadences, swaps and
  the collector's pending interactions; the online entry point has no
  batcher); ``resume`` finds the newest
  valid checkpoint (past a torn or corrupt one), restores the learner
  and the cursors, and returns where to continue.

A killed run resumed with ``--resume auto`` ends bitwise where the
uninterrupted run ends: the learner's generator, the sampler's and the
transforms' generators and the event cursor are all in the checkpoint.
"""

from __future__ import annotations

import os
import signal

from commefficient_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                                      load_checkpoint,
                                                      save_checkpoint)

#: the flags that steer the trajectory; a flag an entry point lacks
#: fingerprints as None
_FINGERPRINT_FIELDS = (
    # task / model / data
    "seed", "mode", "model", "dataset_name", "do_iid", "num_clients",
    "num_workers", "local_batch_size", "valid_batch_size",
    "microbatch_size", "do_batchnorm", "compute_dtype", "do_test",
    "num_epochs", "do_finetune",
    # optimizer / schedule
    "lr_scale", "pivot_epoch", "scalar_lr_factor", "local_momentum",
    "virtual_momentum", "weight_decay", "max_grad_norm", "nan_threshold",
    "num_fedavg_epochs", "fedavg_batch_size", "fedavg_lr_decay",
    # compression
    "k", "num_cols", "num_rows", "num_blocks", "sketch_scheme",
    "grad_buckets", "error_type", "do_topk_down", "topk_approx_recall",
    # server / faults / quarantine
    "server_mode", "buffer_m", "staleness_alpha", "client_quarantine",
    "quarantine_rounds", "fault_seed", "fault_dropout_prob",
    "fault_crash_prob", "straggler_frac", "straggler_mult", "base_latency",
    "latency_sigma", "dispatch_interval",
    # train-while-serve
    "serve_online", "online_train_every", "online_swap_every",
    # DP
    "do_dp", "dp_mode", "l2_norm_clip", "noise_multiplier",
    # gpt2 only (None for cv runs)
    "model_checkpoint", "num_candidates", "max_history", "lm_coef",
    "mc_coef", "personality_permutations", "dropout_impl", "attn_dropout",
)


def config_fingerprint(args, entry: str) -> dict:
    fp = {"entry": entry}
    for f in _FINGERPRINT_FIELDS:
        v = getattr(args, f, None)
        fp[f] = v if (v is None or isinstance(v, (bool, int, float, str))
                      ) else str(v)
    # the client-state representation changes the stored rows; emitted
    # only when not dense, so a dense run's fingerprint has no such key
    cs = getattr(args, "client_state", "dense")
    if cs != "dense":
        fp["client_state"] = cs
        if cs == "sketched":
            fp["client_sketch_rows"] = getattr(args, "client_sketch_rows",
                                               None)
            fp["client_sketch_cols"] = getattr(args, "client_sketch_cols",
                                               None)
    return fp


class PreemptionGuard:
    """Latch SIGTERM/SIGINT so the loop can finish the round in flight,
    save and exit. Installed only with periodic checkpoints; the previous
    handlers come back on exit."""

    def __init__(self, enabled: bool = True, log: bool = True):
        self.enabled = enabled
        self.log = log
        self.triggered = False
        self._old = {}

    def __enter__(self):
        if self.enabled:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._old[sig] = signal.signal(sig, self._handle)
                except ValueError:
                    # not the main thread
                    pass
        return self

    def _handle(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt(f"second signal {signum} during "
                                    f"graceful preemption shutdown")
        self.triggered = True
        if self.log:
            print(f"signal {signum}: finishing in-flight round, "
                  f"checkpointing, exiting", flush=True)

    def __exit__(self, *exc):
        for sig, h in self._old.items():
            signal.signal(sig, h)
        self._old = {}
        return False


class TrainCheckpointer:
    """Periodic and preemption checkpoints, and the resume, of one run.
    ``guard`` is the run's ``PreemptionGuard``, installed only with
    periodic checkpoints."""

    def __init__(self, args, learner, batcher, entry: str, meta: dict = None,
                 log: bool = True, online=None):
        self.every = int(getattr(args, "checkpoint_every_rounds", 0) or 0)
        self.resume_spec = getattr(args, "resume", None)
        self.path = args.checkpoint_path
        self.name = args.model
        self.learner = learner
        self.batcher = batcher
        self.entry = entry
        self.online = online
        self.meta = meta
        self.log = log
        self.fingerprint = config_fingerprint(args, entry)
        self.guard = PreemptionGuard(enabled=self.active, log=log)
        # a save due at an epoch's last round, waiting for its end
        self._deferred = False

    @property
    def active(self) -> bool:
        return self.every > 0

    def due(self, total_rounds: int) -> bool:
        return self.active and total_rounds % self.every == 0

    def _signalled(self) -> bool:
        """Whether a signal reached this process, or on a mesh any rank:
        every rank must take the same branch, since a save gathers the
        rows of all of them (one small ``all_reduce`` a round)."""
        mesh = getattr(self.learner, "mesh", None)
        if mesh is not None and self.active:
            from commefficient_tpu_torch.parallel.mesh import any_rank
            if any_rank(self.guard.triggered, mesh):
                self.guard.triggered = True
        return self.guard.triggered

    def after_round(self, epoch: int, rounds_in_epoch: int,
                    total_rounds: int, at_boundary: bool, flush) -> bool:
        """The save policy after each round the loop has counted. A save
        is due every ``--checkpoint_every_rounds`` rounds, and at once on
        a signal. At an epoch's last round (``at_boundary``) it waits for
        ``at_epoch_end``: a cursor saved before the epoch's flush would
        lose the lookahead's draws. Otherwise ``flush()`` reads the rounds
        in flight first (``rounds_done`` and the byte totals advance as
        they are read), then the step file is written. Returns True when
        a signal's save is written: the loop returns, preempted."""
        if not (self._signalled() or self.due(total_rounds)):
            return False
        if at_boundary:
            self._deferred = True
            return False
        flush()
        self.save(epoch, rounds_in_epoch, total_rounds, in_epoch=True)
        return self.guard.triggered

    def at_epoch_end(self, epoch: int, n_epochs: int, total_rounds: int,
                     stop: bool) -> bool:
        """After the epoch's flush and validation: the save deferred from
        its last round, or a signal's, with the cursor at the next epoch's
        start (every generator past this epoch's draws). Nothing is saved
        when no epoch follows: the run ends. Returns True when a signal's
        save is written: the loop returns, preempted."""
        deferred, self._deferred = self._deferred, False
        if (not (self._signalled() or deferred)
                or epoch + 1 >= n_epochs or stop):
            return False
        self.save(epoch + 1, 0, total_rounds, in_epoch=False)
        return self.guard.triggered

    def save(self, epoch: int, rounds_in_epoch: int, total_rounds: int,
             in_epoch: bool) -> str:
        """The caller has read the rounds in flight first (``rounds_done``
        and the byte totals advance in ``finalize_round_metrics``);
        ``save_checkpoint`` drains the offload pipeline."""
        cursor = {"entry": self.entry, "epoch": epoch,
                  "rounds_in_epoch": rounds_in_epoch,
                  "total_rounds": total_rounds, "in_epoch": in_epoch,
                  "data": (self.batcher.cursor(in_epoch)
                           if self.batcher is not None else None)}
        if hasattr(self.learner, "event_cursor"):
            cursor["buffered"] = self.learner.event_cursor()
        if self.online is not None:
            cursor["online"] = self.online.cursor()
        fn = save_checkpoint(self.path, self.learner, self.name,
                             meta=self.meta, step=total_rounds,
                             cursor=cursor, fingerprint=self.fingerprint)
        if self.log:
            print(f"checkpoint: {fn} (round {total_rounds})", flush=True)
        return fn

    def resume(self):
        """Restore from ``--resume`` and return the cursor, or None for a
        fresh start. ``--resume auto`` with no checkpoint on disk starts
        fresh (the first launch of a restarting job); an explicit path
        that does not resolve raises."""
        spec = self.resume_spec
        if not spec:
            return None
        if spec == "auto":
            fn = find_latest_checkpoint(self.path, self.name)
            if fn is None:
                if self.log:
                    print(f"--resume auto: no valid checkpoint under "
                          f"{self.path!r}; starting fresh", flush=True)
                return None
        elif os.path.isdir(spec):
            fn = find_latest_checkpoint(spec, self.name)
            if fn is None:
                raise ValueError(f"--resume {spec!r}: no valid checkpoint "
                                 f"found in directory")
        else:
            if not os.path.isfile(spec):
                raise ValueError(f"--resume {spec!r}: no such file")
            fn = spec
        info = load_checkpoint(fn, self.learner,
                               expect_fingerprint=self.fingerprint)
        cursor = info["cursor"]
        if cursor is None:
            raise ValueError(
                f"--resume {fn!r}: checkpoint has no training cursor (a "
                f"pre-v3 or end-of-training export) — it can seed "
                f"--finetune but cannot bitwise-resume a training run")
        if cursor.get("entry") != self.entry:
            raise ValueError(
                f"--resume {fn!r}: checkpoint was written by the "
                f"{cursor.get('entry')!r} entrypoint, this is {self.entry!r}")
        if self.batcher is not None and cursor.get("data") is not None:
            self.batcher.restore_cursor(cursor["data"], cursor["in_epoch"])
        if "buffered" in cursor and hasattr(self.learner,
                                            "restore_event_cursor"):
            self.learner.restore_event_cursor(cursor["buffered"])
        if self.online is not None and "online" in cursor:
            self.online.restore_cursor(cursor["online"])
        if self.log:
            print(f"resumed from {fn}: epoch {cursor['epoch']}, "
                  f"round {cursor['total_rounds']}", flush=True)
        return cursor
