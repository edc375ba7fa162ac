"""Hot swap of new base weights into a live server (port of
``commefficient_tpu/online/swap.py``).

``HotSwapCoordinator`` runs the one safe sequence:

    fingerprint gate -> drain -> swap_base_params -> resubmit leftovers

The gate runs first, so a refusal (weights trained under another config
than the server serves) leaves the server serving, untouched; its
comparison is the checkpoint resume's set-union key diff. The drain
finishes every admitted request under its admission-time weights and
evicts every per-user delta through the bitwise base restore. The swap
copies the new tensors onto the old ones' devices and dtypes and rebases
the personalization index. The resubmit queues the drained leftovers
again verbatim.

``force=True`` skips the drain and swaps under active slots: the
deliberate contract violation, counted as a dirty swap.
"""

from __future__ import annotations

from typing import Optional

import torch


def learner_params(learner):
    """The learner's current weights as a ``{torch name: tensor}`` dict of
    contiguous copies (the learner goes on updating its flat vector); on
    a model mesh axis every rank must call it (the blocks are joined)."""
    return {name: t.detach().clone(memory_format=torch.contiguous_format)
            for name, t in learner.unflatten(learner.full_weights()).items()}


class HotSwapCoordinator:
    """Drain -> gate -> swap -> resubmit for one server (+ counters).

    ``learner`` (optional) is the weight source when ``swap`` is called
    without explicit params. ``expect_fingerprint`` is what the SERVER
    is serving (the run's config_fingerprint); ``source_fingerprint`` is
    attached to incoming weights by default — in-process training passes
    the same dict for both (trivially matching), while weights restored
    from a checkpoint carry that checkpoint's fingerprint and can
    mismatch. ``resubmit=False`` hands the leftovers back to the caller
    instead (online/loop.py re-registers its per-request metadata and
    resubmits them itself).
    """

    def __init__(self, server, learner=None, *,
                 expect_fingerprint: Optional[dict] = None,
                 source_fingerprint: Optional[dict] = None,
                 resubmit: bool = True, log: bool = False):
        self.server = server
        self.learner = learner
        self.expect_fingerprint = expect_fingerprint
        self.source_fingerprint = source_fingerprint
        self.resubmit = bool(resubmit)
        self.log = bool(log)
        self.swaps_done = 0
        self.refused = 0

    def check_fingerprint(self, fingerprint: Optional[dict]) -> None:
        """Refuse weights whose config fingerprint disagrees with the
        serving run's (same set-union comparison as checkpoint resume,
        utils/checkpoint.py). ``None`` on either side skips the gate —
        an ungated in-process swap, the caller's explicit choice."""
        if self.expect_fingerprint is None or fingerprint is None:
            return
        bad = sorted(
            k for k in set(fingerprint) | set(self.expect_fingerprint)
            if fingerprint.get(k) != self.expect_fingerprint.get(k))
        if bad:
            self.refused += 1
            detail = ", ".join(
                f"{k}: incoming={fingerprint.get(k)!r} "
                f"serving={self.expect_fingerprint.get(k)!r}" for k in bad)
            raise ValueError(
                f"hot swap refused: incoming weights were trained under "
                f"a different config than this server serves — the "
                f"server keeps serving its current weights untouched. "
                f"Mismatched: {detail}")

    def swap(self, new_params=None, *, fingerprint=None,
             force: bool = False):
        """Run the full sequence; returns ``(replies, leftovers)`` —
        the drained in-flight replies (rid -> tokens) and the
        never-admitted queue entries (already re-submitted under fresh
        rids when ``self.resubmit``; submission order preserved).

        The gate runs BEFORE the drain: a ValueError here means the
        server was never touched. ``force=True`` skips the drain and
        swaps under whatever is active (a dirty swap)."""
        fp = fingerprint if fingerprint is not None \
            else self.source_fingerprint
        self.check_fingerprint(fp)
        if new_params is None:
            if self.learner is None:
                raise ValueError("swap needs new_params or a learner "
                                 "to pull them from")
            new_params = learner_params(self.learner)
        if force:
            replies, leftovers = {}, []
        else:
            replies, leftovers = self.server.drain()
        self.server.swap_base_params(new_params, force=force)
        if self.resubmit and not force:
            for left in leftovers:
                self.server.submit(*left)
        self.swaps_done += 1
        if self.log:
            print(f"hot swap {self.swaps_done}: {len(replies)} drained, "
                  f"{len(leftovers)} resubmitted"
                  + (" [FORCED under active slots]" if force else ""),
                  flush=True)
        return replies, leftovers
