"""Interaction collection: served traffic -> federated training examples
(port of ``commefficient_tpu/online/collector.py``).

* ``InteractionCollector`` turns each finished (prompt, reply) pair of
  the server into a per-client PersonaChat training example with
  ``data/persona.py``'s conventions (the prompt labeled IGNORE, the reply
  positions labeled with their ids, tail truncation, ``mc_token_ids`` at
  the last real position), so the examples feed the same round the gpt2
  entry point trains with. Examples wait in per-client FIFO pools.
* ``LearnerClientStore`` gives a learner's device-resident encoded
  client rows the client store's surface (``codec``, ``_arenas``,
  ``owner``, ``row``, shard counters), so ``PersonalizationIndex`` reads
  the rows the buffered cohorts are training: an apply that rewrites
  client u's row changes the delta of u's next admission.

``record`` trains on the served reply unless ``label_ids`` gives the gold
continuation (``run_online`` replays the persona corpus and passes
it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.data.persona import IGNORE, PAD_ID
from commefficient_tpu_torch.federated.state import CLIENT_STATE_FIELDS


class InteractionCollector:
    """Per-client FIFO pools of served interactions, sampled as cohorts.

    ``store`` (optional, any object with ``owner(cid)``/``num_shards``)
    pins the shard layout; without one everything lives on shard 0.
    ``num_candidates`` sets the example's candidate axis C — online
    traffic has no distractor candidates, so rows ``j < C-1`` duplicate
    the sequence with all-IGNORE labels and the MC head sees a
    degenerate (but shape-compatible) choice task; C=1 skips it.
    ``max_per_user`` caps each client's pool FIFO (oldest interaction
    evicted first), bounding collector memory at
    O(num_active_users * max_per_user * T) ints.
    """

    def __init__(self, num_clients: int, max_seq_len: int, *, store=None,
                 num_candidates: int = 1, eos_id: Optional[int] = None,
                 max_per_user: int = 64):
        if num_candidates < 1:
            raise ValueError(f"num_candidates must be >= 1, "
                             f"got {num_candidates}")
        if max_per_user < 1:
            raise ValueError(f"max_per_user must be >= 1, "
                             f"got {max_per_user}")
        self.num_clients = int(num_clients)
        self.max_seq_len = int(max_seq_len)
        self.store = store
        self.C = int(num_candidates)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.max_per_user = int(max_per_user)
        #: cid -> FIFO of (prompt_ids, prompt_types, label_ids, reply_type)
        self.pending: Dict[int, List[Tuple[list, list, list, int]]] = {}
        self.collected = 0
        self.dropped = 0
        self.evicted = 0
        self.round_idx = 0

    # ---- shard routing (mirrors HostArenaStore) ----------------------

    @property
    def num_shards(self) -> int:
        return int(getattr(self.store, "num_shards", 1) or 1)

    def owner(self, cid: int) -> int:
        """The shard owning client ``cid``'s pool — BY CONSTRUCTION the
        store's own ``owner``, so collected interactions always live
        where the client's state row lives."""
        if self.store is not None:
            return int(self.store.owner(int(cid)))
        return 0

    def pending_per_shard(self) -> List[int]:
        out = [0] * self.num_shards
        for cid, lst in self.pending.items():
            out[self.owner(cid)] += len(lst)
        return out

    # ---- example construction (data/persona.py conventions) ----------

    def build_example(self, prompt_ids, prompt_types, reply_ids,
                      reply_type: int):
        """One (prompt, reply) pair -> fixed-shape MODEL_INPUTS arrays
        ((C, T), (C,), (C, T), (), (C, T)), matching
        persona.utterance_to_arrays: the prompt (context + speaker
        token) is IGNORE-labeled, reply positions are labeled with their
        own ids, eos is appended (and labeled) when the reply does not
        already end with it, and overlong sequences keep their TAIL so
        the labeled reply always survives."""
        seq = [int(t) for t in prompt_ids] + [int(t) for t in reply_ids]
        types = ([int(t) for t in prompt_types]
                 + [int(reply_type)] * len(reply_ids))
        labels = [IGNORE] * len(prompt_ids) + [int(t) for t in reply_ids]
        if self.eos_id is not None and (not reply_ids
                                        or int(reply_ids[-1]) != self.eos_id):
            seq.append(self.eos_id)
            types.append(int(reply_type))
            labels.append(self.eos_id)
        T = self.max_seq_len
        if len(seq) > T:
            seq, types, labels = seq[-T:], types[-T:], labels[-T:]
        C, L = self.C, len(seq)
        input_ids = np.full((C, T), PAD_ID, np.int32)
        token_type = np.full((C, T), PAD_ID, np.int32)
        lm_labels = np.full((C, T), IGNORE, np.int32)
        mc_token_ids = np.zeros((C,), np.int32)
        for j in range(C):
            input_ids[j, :L] = seq
            token_type[j, :L] = types
            mc_token_ids[j] = L - 1
        lm_labels[C - 1, :L] = labels          # only the last candidate
        mc_label = np.int32(C - 1)
        return (input_ids, mc_token_ids, lm_labels, mc_label, token_type)

    # ---- collection ---------------------------------------------------

    def record(self, user_id: int, prompt_ids, prompt_types, reply_ids,
               reply_type: int, label_ids=None) -> bool:
        """Record one served interaction for ``user_id``. ``label_ids``
        overrides the training target (the gold continuation when the
        traffic source knows it); default is the served reply itself
        (self-distillation — see the module docstring). Empty targets
        are dropped (an immediate-eos reply carries no LM signal)."""
        cid = int(user_id)
        if not 0 <= cid < self.num_clients:
            raise IndexError(f"user_id {cid} out of range "
                             f"[0, {self.num_clients})")
        lab = ([int(t) for t in label_ids] if label_ids is not None
               else [int(t) for t in reply_ids])
        if not lab:
            self.dropped += 1
            return False
        lst = self.pending.setdefault(cid, [])
        lst.append(([int(t) for t in prompt_ids],
                    [int(t) for t in prompt_types], lab, int(reply_type)))
        if len(lst) > self.max_per_user:
            lst.pop(0)
            self.evicted += 1
        self.collected += 1
        return True

    def has_work(self) -> bool:
        return any(lst for lst in self.pending.values())

    def num_pending(self) -> int:
        return sum(len(lst) for lst in self.pending.values())

    # ---- cohort sampling ---------------------------------------------

    def sample_round(self, num_workers: int, batch_size: int):
        """One cohort's (ids (W,), cols 5-tuple (W, B, ...), mask (W, B))
        in the exact layout FedBatcher.epoch yields, so
        ``train_round_async`` consumes it unchanged. Deterministic: the
        W clients with the most pending interactions (ties by cid) are
        picked, and each contributes B examples starting at a
        round-rotated offset into its FIFO — examples are NOT consumed,
        so a client's pool is revisited across cohorts (the federated
        local-epochs regime) until FIFO eviction ages it out. Padded
        worker slots carry id 0 with an all-zero mask, matching the
        batcher's epoch-tail convention."""
        W, B, C, T = int(num_workers), int(batch_size), self.C, \
            self.max_seq_len
        elig = sorted(((cid, lst) for cid, lst in self.pending.items()
                       if lst), key=lambda kv: (-len(kv[1]), kv[0]))[:W]
        ids = np.zeros(W, np.int32)
        mask = np.zeros((W, B), np.float32)
        input_ids = np.full((W, B, C, T), PAD_ID, np.int32)
        mc_token_ids = np.zeros((W, B, C), np.int32)
        lm_labels = np.full((W, B, C, T), IGNORE, np.int32)
        mc_labels = np.full((W, B), C - 1, np.int32)
        token_type = np.full((W, B, C, T), PAD_ID, np.int32)
        for w, (cid, lst) in enumerate(elig):
            ids[w] = cid
            start = (self.round_idx * B) % len(lst)
            for b in range(min(B, len(lst))):
                ex = lst[(start + b) % len(lst)]
                e0, e1, e2, e3, e4 = self.build_example(*ex)
                input_ids[w, b] = e0
                mc_token_ids[w, b] = e1
                lm_labels[w, b] = e2
                mc_labels[w, b] = e3
                token_type[w, b] = e4
                mask[w, b] = 1.0
        self.round_idx += 1
        return ids, (input_ids, mc_token_ids, lm_labels, mc_labels,
                     token_type), mask

    def sample_batch(self):
        """All-padding arrays at the per-example shapes ((1, C, T) etc.)
        — the learner-init sample (shape source only, like gpt2.py's
        ``train_set.get_flat_batch(np.arange(1))``)."""
        C, T = self.C, self.max_seq_len
        return (np.full((1, C, T), PAD_ID, np.int32),
                np.zeros((1, C), np.int32),
                np.full((1, C, T), IGNORE, np.int32),
                np.full((1,), C - 1, np.int32),
                np.full((1, C, T), PAD_ID, np.int32))

    # ---- preemption cursor (training/preempt.py) ---------------------

    def cursor(self) -> dict:
        """JSON-able snapshot: collected-but-untrained interactions
        survive a kill (the loop cursor's contract — a resume continues
        WITHOUT re-serving the traffic that produced them)."""
        return {"round_idx": self.round_idx, "collected": self.collected,
                "dropped": self.dropped, "evicted": self.evicted,
                "pending": [[int(cid), [[p, t, r, y] for p, t, r, y in lst]]
                            for cid, lst in sorted(self.pending.items())]}

    def restore_cursor(self, cur: dict) -> None:
        self.round_idx = int(cur["round_idx"])
        self.collected = int(cur["collected"])
        self.dropped = int(cur["dropped"])
        self.evicted = int(cur.get("evicted", 0))
        self.pending = {
            int(cid): [([int(x) for x in p], [int(x) for x in t],
                        [int(x) for x in r], int(y)) for p, t, r, y in lst]
            for cid, lst in cur["pending"]}


class LearnerClientStore:
    """HostArenaStore-shaped view over a learner's DEVICE client state.

    serving/personalize.PersonalizationIndex (and the server's
    owner-affinity routing) talk to a store through ``codec`` /
    ``_arenas`` / ``owner`` / ``row`` / per-shard counters. The offline
    serving path binds those to host arenas restored from a checkpoint;
    the ONLINE path needs the store to be the learner's LIVE state —
    every buffered apply that scatters client u's new sparse row must be
    visible to u's next admission. ``_arenas`` is therefore a property
    over ``learner.state.clients`` (never a snapshot), and ``row`` pulls
    the single requested encoded row to host per call: O(cap) bytes, the
    same budget as a HostArenaStore row read, with no
    ``(num_clients, d)`` densification anywhere.
    """

    def __init__(self, learner, num_shards: int = 1):
        n = int(learner.cfg.num_clients)
        if num_shards < 1 or n % num_shards:
            raise ValueError(
                f"num_clients ({n}) must be divisible by num_shards "
                f"({num_shards})")
        self.learner = learner
        self.codec = learner.codec
        self.num_rows = n
        self.num_shards = int(num_shards)
        self.rows_per_shard = n // self.num_shards
        self.shard_reads = np.zeros(self.num_shards, np.int64)
        self.shard_writes = np.zeros(self.num_shards, np.int64)

    @property
    def _arenas(self):
        c = self.learner.state.clients
        return {f: getattr(c, f) for f in CLIENT_STATE_FIELDS}

    def owner(self, cid: int) -> int:
        return int(cid) // self.rows_per_shard

    def row(self, field: str, cid: int):
        cid = int(cid)
        if not 0 <= cid < self.num_rows:
            raise IndexError(f"client id {cid} out of range "
                             f"[0, {self.num_rows})")
        storage = self._arenas[field]
        if storage is None:
            raise ValueError(f"learner keeps no {field!r} client state "
                             f"under this config")
        self.shard_reads[self.owner(cid)] += 1
        if isinstance(storage, dict):
            return {key: a[cid].cpu().numpy() for key, a in storage.items()}
        return storage[cid].cpu().numpy()
