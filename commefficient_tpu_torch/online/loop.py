"""Train-while-serve: one host loop interleaving serving and training (port
of ``commefficient_tpu/online/loop.py``).

    server.step() --finished replies--> InteractionCollector
         ^                                    | every train_every
         |                                    v interactions
    swap_base_params <--applies--  BufferedFedLearner cohorts
    (HotSwapCoordinator,            (pump_events delivers arrivals
     every swap_every applies)       between decode steps)

Each ``step()`` runs one decode round, then the training that is due:
a buffered cohort every ``online_train_every`` served interactions, a
swap attempt every ``online_swap_every`` applies. Personalization needs
no swap: cohorts rewrite the sparse client rows in
``learner.state.clients``, which the server's ``PersonalizationIndex``
reads through ``LearnerClientStore`` at the next admission. The swap
carries the base weights, through ``HotSwapCoordinator``'s drain, gate,
swap and resubmit; the loop registers the drained leftovers' metadata
again under their new request ids.

Resume (``training/preempt.py``, ``online=``): the loop's cursor (traffic
position, cadence counters, swap count, the collector's pools) goes into
every checkpoint beside the learner's event cursor. A hard kill loses the
in-flight requests; collected but untrained interactions survive.

``run_online`` is the gpt2 entry point's ``--serve_online`` runner: it
replays persona-corpus traffic through the server, evaluates held-out
per-user perplexity at every swap and checkpoints there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from commefficient_tpu_torch.data.persona import IGNORE
from commefficient_tpu_torch.online.collector import (InteractionCollector,
                                                      LearnerClientStore)
from commefficient_tpu_torch.online.swap import (HotSwapCoordinator,
                                                 learner_params)


class OnlineLoop:
    """The interleaved serve/collect/train/swap loop of one server.

    ``train_every`` / ``swap_every`` are the config cadences. The loop
    owns per-request metadata (user, prompt, gold labels) keyed by rid —
    ``submit`` registers it, finished replies consume it into the
    collector, and a swap's drained leftovers are re-registered under
    their fresh rids.
    """

    def __init__(self, server, collector: InteractionCollector, learner,
                 coordinator: HotSwapCoordinator, *, train_every: int = 4,
                 swap_every: int = 2, num_workers: int = 2,
                 local_batch_size: int = 2, max_new: int = 16,
                 log: bool = False):
        if not hasattr(learner, "pump_events"):
            raise ValueError(
                "OnlineLoop drives the buffered event loop between decode "
                "steps (pump_events); use BufferedFedLearner "
                "(--server_mode buffered)")
        if coordinator.resubmit:
            raise ValueError(
                "OnlineLoop resubmits drained leftovers itself (it must "
                "re-register per-request metadata under the fresh rids); "
                "build the HotSwapCoordinator with resubmit=False")
        self.server = server
        self.collector = collector
        self.learner = learner
        self.coordinator = coordinator
        self.train_every = int(train_every)
        self.swap_every = int(swap_every)
        self.num_workers = int(num_workers)
        self.local_batch_size = max(1, int(local_batch_size))
        self.max_new = int(max_new)
        self.log = bool(log)
        #: rid -> (user_id, ids, types, reply_type, max_new, label_ids)
        self._inflight: Dict[int, tuple] = {}
        self.replies: Dict[int, List[int]] = {}
        self.steps = 0
        self.interactions = 0
        self._interactions_trained = 0
        self.rounds_done = 0
        self.traffic_pos = 0
        self.swaps = 0
        self._applies_at_last_swap = int(learner.applies_done)
        self.losses: List[float] = []

    # ---- request lifecycle -------------------------------------------

    def submit(self, ids, types, reply_type: int, max_new: int = None,
               user_id=None, label_ids=None) -> int:
        """server.submit + metadata registration (what turns the reply
        into a training example when it finishes)."""
        mx = int(max_new if max_new is not None else self.max_new)
        rid = self.server.submit(ids, types, reply_type, mx,
                                 user_id=user_id)
        self._inflight[rid] = (user_id, list(ids), list(types),
                               int(reply_type), mx, label_ids)
        return rid

    def inflight(self) -> int:
        return len(self._inflight)

    def _record_finished(self, finished) -> None:
        for rid, toks in finished:
            meta = self._inflight.pop(rid, None)
            self.replies[rid] = list(toks)
            if meta is None:
                continue
            user_id, ids, types, reply_type, _mx, label_ids = meta
            if user_id is None:
                continue                 # anonymous traffic trains nobody
            self.collector.record(user_id, ids, types, toks, reply_type,
                                  label_ids=label_ids)
            self.interactions += 1

    # ---- the interleaved step ----------------------------------------

    def step(self):
        """One host-loop turn: a decode round, then due training work.
        Returns the requests finished this turn (including any drained
        by a swap) as (rid, reply_tokens)."""
        finished = self.server.step()
        self._record_finished(finished)
        out = list(finished)
        while (self.collector.has_work()
               and (self.interactions - self._interactions_trained)
               >= self.train_every):
            self._train_one_cohort()
        # deliver buffered arrivals due at the current dispatch clock —
        # applies land at their sim times even while the loop serves
        self.learner.pump_events()
        if (int(self.learner.applies_done) - self._applies_at_last_swap
                >= self.swap_every):
            out.extend(self.try_swap())
        self.steps += 1
        return out

    def _train_one_cohort(self) -> Optional[dict]:
        ids, cols, mask = self.collector.sample_round(
            self.num_workers, self.local_batch_size)
        if not mask.any():
            self._interactions_trained = self.interactions
            return None
        raw = self.learner.train_round_async(ids, cols, mask,
                                             epoch_frac=self.rounds_done)
        out = self.learner.finalize_round_metrics(raw)
        self.rounds_done += 1
        self._interactions_trained += self.train_every
        self.losses.append(float(out["loss"]))
        if self.log:
            print(f"online cohort {self.rounds_done}: "
                  f"loss={out['loss']:.4f} "
                  f"applies={int(self.learner.applies_done)}", flush=True)
        return out

    def try_swap(self):
        """Drain -> gate -> swap via the coordinator, then re-register
        and resubmit the drained leftovers: after the drain, the
        still-inflight rids (ascending) correspond 1:1 to the sorted
        leftovers the server handed back, so metadata carries over to
        the fresh rids. Returns the drained replies."""
        replies, leftovers = self.coordinator.swap(
            learner_params(self.learner))
        self._record_finished(sorted(replies.items()))
        waiting = sorted(self._inflight)
        assert len(waiting) == len(leftovers), \
            f"{len(waiting)} tracked vs {len(leftovers)} drained leftovers"
        metas = [self._inflight.pop(r) for r in waiting]
        for user_id, ids, types, reply_type, mx, label_ids in metas:
            self.submit(ids, types, reply_type, max_new=mx,
                        user_id=user_id, label_ids=label_ids)
        self._applies_at_last_swap = int(self.learner.applies_done)
        self.swaps += 1
        if self.log:
            st = self.server.stats()
            drift = st.get("acceptance_rate_since_swap")
            print(f"swap {self.swaps}: {len(replies)} drained, "
                  f"{len(leftovers)} resubmitted, drift_accept="
                  f"{'n/a' if drift is None else f'{drift:.3f}'}",
                  flush=True)
        return sorted(replies.items())

    # ---- preemption cursor (training/preempt.py ``online=``) ---------

    def cursor(self) -> dict:
        return {"steps": self.steps, "interactions": self.interactions,
                "interactions_trained": self._interactions_trained,
                "rounds_done": self.rounds_done,
                "traffic_pos": self.traffic_pos,
                "applies_at_last_swap": self._applies_at_last_swap,
                "swaps": self.swaps,
                "server_swaps": int(self.server.swaps_done),
                "collector": self.collector.cursor()}

    def restore_cursor(self, cur: dict) -> None:
        self.steps = int(cur["steps"])
        self.interactions = int(cur["interactions"])
        self._interactions_trained = int(cur["interactions_trained"])
        self.rounds_done = int(cur["rounds_done"])
        self.traffic_pos = int(cur["traffic_pos"])
        self._applies_at_last_swap = int(cur["applies_at_last_swap"])
        self.swaps = int(cur["swaps"])
        self.server.swaps_done = int(cur["server_swaps"])
        self.collector.restore_cursor(cur["collector"])
        # in-flight requests at the kill are lost by contract (the same
        # transient-state rule as the buffered arrival heap); the
        # collector's pending pools above are what survives
        self._inflight = {}


# ----------------------------------------------------------------------
# Traffic from the persona corpus
# ----------------------------------------------------------------------

def extract_interaction(train_set, flat_idx: int):
    """One cached train example -> a servable (prompt, gold) interaction.

    The row's last candidate is the gold one: its first labeled position
    p0 is where the reply starts, so ``ids[:p0]`` (context and the reply's
    speaker token) is the prompt and ``ids[p0:mc+1]`` (the reply and eos)
    the gold continuation. None for rows with no labeled position."""
    cols = train_set.get_flat_batch(np.asarray([int(flat_idx)]))
    ids = np.asarray(cols[0][0][-1])
    mc = int(np.asarray(cols[1][0][-1]))
    labels = np.asarray(cols[2][0][-1])
    types = np.asarray(cols[4][0][-1])
    lab_pos = np.nonzero(labels != IGNORE)[0]
    if lab_pos.size == 0:
        return None
    p0 = int(lab_pos[0])
    if p0 == 0 or mc < p0:
        return None
    return {"prompt": ids[:p0].tolist(), "types": types[:p0].tolist(),
            "gold": ids[p0:mc + 1].tolist(),
            "reply_type": int(types[p0])}


def build_traffic(train_set, max_per_user: int = None):
    """Replayable traffic and a held-out split: each client's flat range is
    split alternately, even positions served, odd positions held out
    (never served, never trained). Traffic visits the users round-robin.
    Returns ``(traffic, heldout)``: interaction dicts (with ``user``) and
    ``{user: [flat_idx, ...]}``."""
    per_user_items: Dict[int, list] = {}
    heldout: Dict[int, List[int]] = {}
    for u, (start, end) in enumerate(train_set.client_slices()):
        idxs = list(range(start, end))
        serve_idxs = idxs[0::2] or idxs[:1]
        hold_idxs = idxs[1::2] or idxs[:1]
        if max_per_user:
            serve_idxs = serve_idxs[:max_per_user]
            hold_idxs = hold_idxs[:max_per_user]
        items = []
        for fi in serve_idxs:
            it = extract_interaction(train_set, fi)
            if it is not None:
                it["user"] = u
                items.append(it)
        if items:
            per_user_items[u] = items
            heldout[u] = hold_idxs
    traffic = []
    depth = max((len(v) for v in per_user_items.values()), default=0)
    for i in range(depth):
        for u in sorted(per_user_items):
            items = per_user_items[u]
            traffic.append(items[i % len(items)])
    return traffic, heldout


def build_heldout_batches(train_set, heldout: Dict[int, List[int]],
                          batch_cap: int = 8):
    """Per-user evaluation batches, every user's held-out rows padded to
    one batch size."""
    E = min(batch_cap, max((len(v) for v in heldout.values()), default=1))
    out = []
    for u in sorted(heldout):
        idxs = np.asarray(heldout[u][:E])
        data = train_set.get_flat_batch(idxs)
        b = len(idxs)
        mask = np.zeros(E, np.float32)
        mask[:b] = 1.0
        cols = []
        for d in data:
            pad = np.zeros((E,) + d.shape[1:], d.dtype)
            pad[:b] = d
            cols.append(pad)
        out.append((u, tuple(cols), mask))
    return out


def eval_heldout(learner, store, heldout_batches, scale: float = 1.0):
    """Held-out per-user nll under base + that user's current delta: each
    user's sparse errors row made dense one at a time (one (d,) vector,
    never a (num_clients, d) table), added to the weights, and evaluated
    on the user's batch. The learner's generator is put back after the
    sweep, so evaluation never moves the training trajectory."""
    gen_state = learner.generator.get_state()
    base_state = learner.state
    w = base_state.weights
    d = int(w.shape[0])
    per_user: Dict[int, float] = {}
    try:
        for u, cols, mask in heldout_batches:
            row = store.row("errors", u)
            idx = np.asarray(row["idx"], np.int64)
            val = np.asarray(row["val"], np.float32)
            live = val != 0.0
            # the reference's np.add.at on the device: the live
            # coordinates of a row are distinct
            dense = torch.zeros_like(w)
            dense.index_put_(
                (torch.as_tensor(np.minimum(idx[live], d - 1),
                                 device=w.device),),
                torch.as_tensor(np.float32(scale) * val[live],
                                device=w.device), accumulate=True)
            learner.state = dataclasses.replace(base_state,
                                                weights=w + dense)
            out = learner.evaluate([(cols, mask)])
            m = np.asarray(out["metrics"])
            if m.size >= 3 and float(m[2]) > 0:
                nll = float(m[1]) / float(m[2])
            else:
                nll = float(out["loss"])
            per_user[u] = nll
    finally:
        learner.state = base_state
        learner.generator.set_state(gen_state)
    mean = (float(np.mean(list(per_user.values()))) if per_user
            else float("nan"))
    return {"per_user": per_user, "mean_nll": mean,
            "mean_ppl": float(np.exp(min(mean, 20.0)))
            if per_user else float("nan")}


# ----------------------------------------------------------------------
# The --serve_online runner
# ----------------------------------------------------------------------

def run_online(args, mesh=None, log: bool = True,
               target_swaps: int = 2, max_steps: int = 5000,
               eval_every_swap: bool = True):
    """Serve persona traffic, train on it, hot-swap, measure.

    Builds the stack (tokenizer and dataset, the buffered learner over
    ``training.gpt2.gpt2_config``'s model, a ``DecodeEngine`` and a paged
    personalized server over the learner's live client rows, a
    ``HotSwapCoordinator`` gated on this run's config fingerprint), then
    drives ``OnlineLoop`` until ``target_swaps`` swaps have landed,
    evaluating held-out per-user perplexity at every swap and
    checkpointing there under ``--checkpoint_every_rounds``. Returns
    ``(learner, loop, results)``. One device: a mesh raises."""
    if mesh is not None:
        raise ValueError(
            "--serve_online interleaves the buffered event loop with the "
            "decode server on ONE host/chip; drop the mesh")
    from commefficient_tpu_torch.data.tokenizer import get_tokenizer
    from commefficient_tpu_torch.federated.losses import (
        make_gpt2_train_loss, make_gpt2_val_loss)
    from commefficient_tpu_torch.models.gpt2 import GPT2DoubleHeads
    from commefficient_tpu_torch.serving.decode import DecodeEngine
    from commefficient_tpu_torch.serving.personalize import \
        PersonalizationIndex
    from commefficient_tpu_torch.serving.server import \
        ContinuousBatchingServer
    from commefficient_tpu_torch.training.args import (args_to_config,
                                                       learner_factory)
    from commefficient_tpu_torch.training.gpt2 import (gpt2_config,
                                                       make_persona)
    from commefficient_tpu_torch.training.preempt import (
        TrainCheckpointer, config_fingerprint)
    from commefficient_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    tokenizer = get_tokenizer(args.model_checkpoint, verbose=log)
    train_set = make_persona(args, tokenizer, train=True)
    args.num_clients = train_set.num_clients
    num_clients = train_set.num_clients
    eos = tokenizer.convert_tokens_to_ids("<eos>")

    model = GPT2DoubleHeads(gpt2_config(args, tokenizer.vocab_size))
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    cfg = args_to_config(args)
    if not cfg.serve_online:
        raise ValueError("run_online needs --serve_online (with "
                         "--server_mode buffered --serve_personalized "
                         "--client_state sparse)")

    # online interactions carry no distractor candidates: C = 1
    collector = InteractionCollector(num_clients, args.max_seq_len,
                                     num_candidates=1, eos_id=eos)
    learner_cls, learner_extra = learner_factory(args, num_clients)
    learner = learner_cls(model, cfg,
                          make_gpt2_train_loss(model, args.lm_coef,
                                               args.mc_coef,
                                               args.moe_aux_weight),
                          make_gpt2_val_loss(model), lr_schedule=None,
                          device=device, seed=args.seed, **learner_extra)
    store = LearnerClientStore(learner)
    collector.store = store

    engine = DecodeEngine(learner.model, learner_params(learner),
                          eos_id=eos, max_len=args.max_seq_len,
                          method=args.serve_sample)
    personalize = PersonalizationIndex(engine.params, store)
    server = ContinuousBatchingServer(
        engine, slots=args.serve_slots, prefill_len=args.max_seq_len,
        kv_cache="paged", personalize=personalize,
        speculate_k=args.speculate_k, kv_quant=args.kv_quant,
        disaggregate=args.serve_disagg)

    fp = config_fingerprint(args, "gpt2_online")
    coordinator = HotSwapCoordinator(server, learner,
                                     expect_fingerprint=fp,
                                     source_fingerprint=fp,
                                     resubmit=False, log=log)
    loop = OnlineLoop(server, collector, learner, coordinator,
                      train_every=args.online_train_every,
                      swap_every=args.online_swap_every,
                      num_workers=args.num_workers,
                      local_batch_size=args.local_batch_size,
                      max_new=min(24, args.max_seq_len // 4), log=log)

    ckpt = TrainCheckpointer(args, learner, None, entry="gpt2_online",
                             online=loop, log=log)
    ckpt.resume()

    traffic, heldout = build_traffic(train_set)
    if not traffic:
        raise ValueError("persona corpus produced no servable traffic")
    heldout_batches = build_heldout_batches(train_set, heldout)

    scale = personalize.scale

    def eval_point():
        # base + delta (what a personalized user gets) and base alone at
        # every swap: the gap is what the per-user deltas buy
        pt = dict(eval_heldout(learner, store, heldout_batches,
                               scale=scale), swaps=loop.swaps)
        base = eval_heldout(learner, store, heldout_batches, scale=0.0)
        pt["mean_nll_base"] = base["mean_nll"]
        pt["mean_ppl_base"] = base["mean_ppl"]
        return pt

    trajectory = [eval_point()]
    if log:
        print(f"online: {len(traffic)} traffic items over "
              f"{len(heldout_batches)} users; baseline heldout "
              f"ppl={trajectory[0]['mean_ppl']:.2f}", flush=True)

    guard = ckpt.guard
    preempted = False
    with guard:
        while loop.swaps < target_swaps and loop.steps < max_steps:
            while loop.inflight() < server.slots:
                item = traffic[loop.traffic_pos % len(traffic)]
                loop.submit(item["prompt"], item["types"],
                            item["reply_type"],
                            max_new=max(1, len(item["gold"])),
                            user_id=item["user"], label_ids=item["gold"])
                loop.traffic_pos += 1
            before = loop.swaps
            loop.step()
            if loop.swaps > before:
                if eval_every_swap:
                    trajectory.append(eval_point())
                if ckpt.active:
                    ckpt.save(epoch=loop.swaps, rounds_in_epoch=0,
                              total_rounds=loop.rounds_done,
                              in_epoch=False)
            if guard.triggered:
                preempted = True
                if ckpt.active:
                    ckpt.save(epoch=loop.swaps, rounds_in_epoch=0,
                              total_rounds=loop.rounds_done,
                              in_epoch=False)
                break

    learner.flush_faults()
    final = eval_point()
    if final["mean_nll"] != trajectory[-1]["mean_nll"]:
        trajectory.append(final)
    first, last = trajectory[0]["mean_nll"], trajectory[-1]["mean_nll"]
    results = {
        "swaps": loop.swaps,
        "dirty_swaps": int(server.dirty_swaps),
        "refused_swaps": int(coordinator.refused),
        "steps": loop.steps,
        "interactions": loop.interactions,
        "rounds": loop.rounds_done,
        "applies": int(learner.applies_done),
        "collected": collector.collected,
        "train_losses": loop.losses,
        "heldout_trajectory": [
            {"swaps": t["swaps"], "mean_nll": t["mean_nll"],
             "mean_ppl": t["mean_ppl"],
             "mean_nll_base": t.get("mean_nll_base"),
             "mean_ppl_base": t.get("mean_ppl_base")}
            for t in trajectory],
        "heldout_nll_first": first,
        "heldout_nll_last": last,
        "heldout_improved": bool(last < first),
        "preempted": preempted,
        "server_stats": {k: v for k, v in server.stats().items()
                         if not isinstance(v, (list, dict))},
    }
    if log:
        verdict = "improved" if results["heldout_improved"] else "NOT improved"
        print(f"online done: swaps={loop.swaps} "
              f"interactions={loop.interactions} rounds="
              f"{loop.rounds_done} heldout nll {first:.4f} -> {last:.4f} "
              f"({verdict})", flush=True)
    return learner, loop, results
