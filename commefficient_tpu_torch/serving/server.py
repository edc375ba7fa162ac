"""Continuous-batching server over a ``DecodeEngine`` (port of
``commefficient_tpu/serving/server.py``). A tensor-parallel engine
(``DecodeEngine(mesh=)``) is served by one server a rank, each running
the same bookkeeping on the same requests and holding its heads of the
pools; ``stats()["tp"]`` is its degree.

A fixed slot array (the decode batch) serves a stream of requests:

* ``submit`` queues a request (prompt ids and types, the reply's token
  type, a token budget, optionally a ``user_id``);
* each ``step`` admits queued requests into free slots (a B = 1 prefill
  fills a one-row cache, which is copied into the slot's rows, and the
  first token is sampled), advances every slot one token, and retires the
  finished slots (eos sampled, or the budget spent) on the host;
* ``run`` steps until the queue and the slots are empty.

Free and finished lanes ride along with ``done`` set, so the step has one
shape for the server's lifetime. Host work happens between steps, with
one device-to-host copy a step. Rows decode independently, so a served
reply equals what ``DecodeEngine.generate`` gives the request alone.

``kv_cache="paged"`` replaces the dense slab with the pools of
``serving/paged_cache.py``: admission packs the prefilled row into pool
pages, the step runs ``engine.paged_step`` through the page table, and
retirement returns the pages. ``personalize=`` (a
``PersonalizationIndex``) adds a user's sparse weight delta at admission
and removes it at retirement. ``speculate_k=γ`` makes each step a
speculative round (``serving/speculative.py``). ``kv_quant`` stores the
paged pools as int8 or int4 (``ops/kv_quant.py``).

Owner-affine routing: with a store of ``num_shards`` shards the slots
split into contiguous per-shard pools; a user's request is admitted only
into the pool of the shard owning the user's row (it waits when that pool
is full), anonymous requests spill into any free slot (counted per shard).
``disaggregate=True`` steps the decode pool first and then admits at most
``prefill_slots`` requests, so a burst of prefills cannot stall the
resident rows; the handoff is a page-table row, hence the paged cache.

``swap_base_params`` promotes new base weights into a drained server (the
online loop's hot swap, ``online/swap.py``).

The reference's slot surgery programs (insert, set row, release, set
previous token) are in-place writes of the slot's rows on the device.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclass
class _Request:
    rid: int
    ids: Sequence[int]
    types: Sequence[int]
    reply_type: int
    max_new: int
    user_id: object = None
    out: List[int] = field(default_factory=list)


class ContinuousBatchingServer:
    def __init__(self, engine, *, slots: int = 8, prefill_len: int = 64,
                 seed: int = 0, kv_cache: str = "fixed",
                 page_size: int = 16, num_pages: int = None,
                 share_prefix: bool = True, personalize=None,
                 speculate_k: int = 0, drafter_model=None,
                 drafter_params=None, kv_quant: str = "none",
                 disaggregate: bool = False, prefill_slots: int = None):
        from commefficient_tpu_torch.ops import kv_quant as kvq
        if prefill_len > engine.max_len:
            raise ValueError(f"prefill_len {prefill_len} exceeds cache "
                             f"capacity {engine.max_len}")
        if kv_cache not in ("fixed", "paged"):
            raise ValueError(f"kv_cache must be 'fixed' or 'paged', "
                             f"got {kv_cache!r}")
        kvq.validate_mode(kv_quant)
        if kv_quant != "none" and kv_cache != "paged":
            raise ValueError("kv_quant is a property of the paged pools "
                             "(ops/kv_quant.py) — serve with "
                             "kv_cache='paged' or kv_quant='none'")
        if kv_quant != "none" and engine.tp > 1 \
                and engine.model.config.n_head % engine.tp:
            raise ValueError(
                f"kv_quant scale rows are (num_pages, n_head) and shard "
                f"per head: n_head {engine.model.config.n_head} must "
                f"divide by tp {engine.tp}")
        self.engine = engine
        self.slots = int(slots)
        self.prefill_len = int(prefill_len)
        self.kv_cache = kv_cache
        self.kv_quant = kv_quant
        self.personalize = personalize
        # ---- prefill/decode disaggregation ---------------------------
        # With ``disaggregate=True`` admission (the compute-bound B=1
        # prefill program) and decode (the bandwidth-bound step program)
        # run as separate pools inside each ``step()``: the decode pool
        # steps FIRST, every step, and at most ``prefill_slots``
        # admissions follow it — so a prefill burst (a deep queue) can
        # never insert more than prefill_slots prefill dispatches
        # between consecutive decode steps, and admitted decode slots
        # see flat latency. The handoff between the pools is the paged
        # KV page table: the prefill pool packs its B=1 row into pool
        # pages (pager.admit -> paged_insert) and writes one page-table
        # row + slot row, after which the decode pool's unchanged step
        # program serves the request — which is why disaggregation
        # requires kv_cache='paged'.
        self.disaggregate = bool(disaggregate)
        if self.disaggregate:
            if kv_cache != "paged":
                raise ValueError(
                    "disaggregated prefill hands off KV state through "
                    "the paged page table — serve with kv_cache='paged'")
            if self.slots < 2:
                raise ValueError(
                    f"disaggregation splits prefill and decode into two "
                    f"pools; slots {self.slots} < 2 cannot hold both")
            self.prefill_slots = int(prefill_slots) if prefill_slots \
                else max(1, self.slots // 4)
            if not 1 <= self.prefill_slots < self.slots:
                raise ValueError(
                    f"prefill_slots {self.prefill_slots} must be in "
                    f"[1, slots) so the decode pool is never empty")
        else:
            self.prefill_slots = None
        B = self.slots
        if kv_cache == "paged":
            from commefficient_tpu_torch.serving.paged_cache import \
                PagedKVCache

            # per-user weight deltas make page content user-dependent, so
            # cross-user prefix sharing is off under personalization
            self.pager = PagedKVCache(
                slots=B, max_len=engine.max_len, prefill_len=prefill_len,
                page_size=page_size, num_pages=num_pages,
                share_prefix=share_prefix and personalize is None)
            self.cache = engine.init_paged_pools(self.pager.num_pages,
                                                 page_size,
                                                 kv_quant=kv_quant)
        else:
            self.pager = None
            self.cache = engine.init_cache(B)
        dev = engine.device
        self.tok = torch.full((B,), engine.pad_id, dtype=torch.int32,
                              device=dev)
        self.typ = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.done = torch.ones((B,), dtype=torch.bool, device=dev)
        self.rng = engine.new_generator(seed)   # free lanes stay latched
        # ---- owner-affinity routing ----------------------------------
        # The personalization store is sharded (HostArenaStore
        # num_shards): user cid's row lives on shard owner(cid) =
        # cid // rows_per_shard. Slots partition into the same number of
        # contiguous per-shard pools, and a personalized request is only
        # ever admitted into its OWNER's pool — its O(k) row read/write
        # and its weight-delta residency stay on one shard. Anonymous
        # requests queue on the shared ``_queue`` and SPILL (work-steal)
        # into whichever shard has a free slot, so affinity never idles
        # capacity.
        self.num_shards = int(getattr(getattr(personalize, "store", None),
                                      "num_shards", 1) or 1)
        if B % self.num_shards:
            raise ValueError(
                f"slots {B} must divide evenly across the store's "
                f"{self.num_shards} shards (contiguous per-shard slot "
                f"pools)")
        self.slots_per_shard = B // self.num_shards
        self._queue: deque = deque()            # anonymous / shared
        self._shard_queue = [deque() for _ in range(self.num_shards)]
        self._free_slots = [
            list(range(s * self.slots_per_shard,
                       (s + 1) * self.slots_per_shard))
            for s in range(self.num_shards)]
        self._admitted_per_shard = np.zeros((self.num_shards,), np.int64)
        self._spilled_per_shard = np.zeros((self.num_shards,), np.int64)
        self._slot_req: List[_Request] = [None] * B
        self._next_rid = 0
        self.swaps_done = 0
        self.dirty_swaps = 0
        self.spec = None
        if speculate_k:
            from commefficient_tpu_torch.serving.speculative import \
                SpeculativeDecoder

            # constructed BEFORE any personalized admission, so the
            # default (self-drafting) drafter snapshots pristine base
            # params — the free personalized drafter. The snapshot is
            # also deliberately NOT refreshed by swap_base_params: as
            # online training advances the target, the stale drafter's
            # acceptance rate becomes the live drift metric.
            self.spec = SpeculativeDecoder(
                engine, gamma=speculate_k, slots=B,
                drafter_model=drafter_model, drafter_params=drafter_params)
            self.prev_tok = torch.full((B,), engine.pad_id,
                                       dtype=torch.int32, device=dev)
            self.prev_typ = torch.zeros((B,), dtype=torch.int32, device=dev)
            self._drafted = np.zeros((B,), np.int64)
            self._accepted = np.zeros((B,), np.int64)
            self._spec_totals = {"drafted": 0, "accepted": 0,
                                 "corrected": 0, "rounds": 0}
            self._spec_swap_mark = dict(self._spec_totals)

    # ---- slot surgery: in-place writes of one slot's rows -------------

    @staticmethod
    def _insert(cache, row_cache, slot: int):
        """Copy a B = 1 cache row into ``slot`` of a per-layer cache."""
        for c, r in zip(cache, row_cache):
            for key in c:
                c[key][slot] = r[key][0].to(c[key].dtype)
        return cache

    # ---- request lifecycle -------------------------------------------

    def submit(self, ids: Sequence[int], types: Sequence[int],
               reply_type: int, max_new: int, user_id=None) -> int:
        """Queue a request. A ``user_id`` routes it to the slot pool of
        the shard OWNING that user's personalization row
        (HostArenaStore.owner); anonymous requests join the shared queue
        and spill into any free slot."""
        if len(ids) > self.prefill_len:
            raise ValueError(f"prompt length {len(ids)} exceeds "
                             f"prefill_len {self.prefill_len}")
        if user_id is not None and self.personalize is None:
            raise ValueError("submit got a user_id but the server has no "
                             "personalization index attached")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, list(ids), list(types), int(reply_type),
                       int(max_new), user_id)
        if user_id is not None:
            self._shard_queue[self._owner_shard(user_id)].append(req)
        else:
            self._queue.append(req)
        return rid

    def _owner_shard(self, user_id) -> int:
        return int(self.personalize.store.owner(int(user_id)))

    def _shard_of_slot(self, slot: int) -> int:
        return int(slot) // self.slots_per_shard

    def _queued(self) -> bool:
        return bool(self._queue) or any(bool(q) for q in self._shard_queue)

    def _params_for(self, req: _Request):
        """Admission-time served params: base, or base + the user's
        sparse delta applied in place on device (O(k) per admission).
        The delta stays applied until _retire evicts it, so the shared
        decode step serves every active user's personalized weights at
        once — rows are independent only because each user's touched
        coordinates compose additively (serving/personalize.py)."""
        if self.personalize is not None and req.user_id is not None:
            self.engine.params = self.personalize.admit(
                self.engine.params, req.user_id)
        return self.engine.params

    def _evict_user(self, req: _Request) -> None:
        if self.personalize is not None and req.user_id is not None:
            self.engine.params = self.personalize.evict(
                self.engine.params, req.user_id)

    def _admit(self, budget: int = None) -> List[Tuple[int, List[int]]]:
        """Admit queued requests into free slots, owner-affine: shard
        s's slot pool serves shard s's queue first, then steals from the
        shared anonymous queue. A personalized request whose owner pool
        is full WAITS (its row never crosses shards) — the next release
        in that pool admits it before any anonymous spill. ``budget``
        (disaggregated servers) caps admissions — i.e. prefill
        dispatches — per call."""
        finished = []
        admitted, progress = 0, True
        while progress and (budget is None or admitted < budget):
            progress = False
            for s in range(self.num_shards):
                if budget is not None and admitted >= budget:
                    break
                if not self._free_slots[s]:
                    continue
                if self._shard_queue[s]:
                    req, spilled = self._shard_queue[s].popleft(), False
                elif self._queue:
                    req, spilled = self._queue.popleft(), \
                        self.num_shards > 1
                else:
                    continue
                slot = self._free_slots[s].pop()
                self._admitted_per_shard[s] += 1
                if spilled:
                    self._spilled_per_shard[s] += 1
                self._admit_one(req, slot, finished)
                admitted += 1
                progress = True
        return finished

    def _admit_one(self, req: _Request, slot: int, finished) -> None:
        """Prefill ``req`` and graft it into ``slot`` (the B=1 prefill
        program + page-table/slot-row handoff)."""
        eng = self.engine
        P, L = self.prefill_len, len(req.ids)
        ids = np.full((1, P), eng.pad_id, np.int32)
        typ = np.full((1, P), eng.pad_id, np.int32)
        ids[0, :L] = req.ids
        typ[0, :L] = req.types
        ids = torch.from_numpy(ids).to(eng.device)
        typ = torch.from_numpy(typ).to(eng.device)
        last = torch.tensor([L - 1], dtype=torch.int32, device=eng.device)
        params = self._params_for(req)
        logits, row_cache = eng.prefill(params, eng.init_cache(1), ids, typ,
                                        last)
        first, self.rng = eng.sample(logits, self.rng)
        t = int(first[0])                   # admission-time sync
        if t == eng.eos_id or req.max_new <= 0:
            finished.append((req.rid, []))
            self._free_slots[self._shard_of_slot(slot)].append(slot)
            self._evict_user(req)
            return
        req.out.append(t)
        if req.max_new == 1 or L >= eng.max_len:
            finished.append((req.rid, list(req.out)))
            self._free_slots[self._shard_of_slot(slot)].append(slot)
            self._evict_user(req)
            return
        if self.pager is not None:
            dst = self.pager.admit(slot, req.ids, req.types,
                                   shareable=req.user_id is None)
            self.cache = eng.paged_insert(
                self.cache, row_cache,
                torch.from_numpy(dst).to(eng.device))
        else:
            self.cache = self._insert(self.cache, row_cache, slot)
        self.tok[slot] = t
        self.typ[slot] = req.reply_type
        self.pos[slot] = L
        self.done[slot] = False
        if self.spec is not None:
            # the drafter's prefill, always with the base params
            drow = self.spec.dprefill(self.spec.dparams,
                                      self.spec.init_drafter_row(), ids, typ,
                                      last)
            self.spec.dcache = self._insert(self.spec.dcache, drow, slot)
            # the next catch-up rewrites the last prompt token at L - 1
            self.prev_tok[slot] = int(req.ids[-1])
            self.prev_typ[slot] = int(req.types[-1])
            self._drafted[slot] = 0
            self._accepted[slot] = 0
        self._slot_req[slot] = req

    def _retire(self, slot: int, finished) -> None:
        req = self._slot_req[slot]
        finished.append((req.rid, list(req.out)))
        self._slot_req[slot] = None
        self._free_slots[self._shard_of_slot(slot)].append(slot)
        self.done[slot] = True
        if self.pager is not None:
            self.pager.release(slot)
        self._evict_user(req)

    def step(self) -> List[Tuple[int, List[int]]]:
        """Advance the server one step; returns the requests finished
        this step as (rid, reply_tokens).

        Unified (default): admit everything that fits, then advance
        every slot one token and retire. Disaggregated: the DECODE pool
        steps first — its cadence never waits on the queue — then at
        most ``prefill_slots`` admissions run their prefills (the
        handoff into the decode pool is a page-table row write)."""
        if self.disaggregate:
            finished = self._decode_round([])
            finished.extend(self._admit(budget=self.prefill_slots))
            return finished
        return self._decode_round(self._admit())

    def _decode_round(self, finished) -> List[Tuple[int, List[int]]]:
        """One decode step over the active slots (+ retirement)."""
        active = [s for s, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return finished
        if self.spec is not None:
            return self._speculative_round(active, finished)
        if self.pager is not None:
            for slot in active:
                self.pager.ensure_frontier(slot)
            pt = self.pager.device_table(self.engine.device)
            (self.cache, self.tok, self.pos, self.rng,
             self.done) = self.engine.paged_step(
                self.engine.params, self.cache, pt, self.tok, self.typ,
                self.pos, self.rng, self.done)
            for slot in active:
                self.pager.advance(slot)
        else:
            (self.cache, self.tok, self.pos, self.rng,
             self.done) = self.engine.step(self.engine.params, self.cache,
                                           self.tok, self.typ, self.pos,
                                           self.rng, self.done)
        toks = self.tok.cpu().numpy()           # one host read a step
        for slot in active:
            req = self._slot_req[slot]
            t = int(toks[slot])
            if t == self.engine.eos_id:
                self._retire(slot, finished)
                continue
            req.out.append(t)
            if len(req.out) >= req.max_new:
                self._retire(slot, finished)
        return finished

    def _speculative_round(self, active, finished):
        """One draft + verify round over the whole slot array: up to
        γ+1 tokens per active slot, same two programs every round."""
        spec, eng = self.spec, self.engine
        if spec.stochastic:
            # the stochastic draft/verify programs thread the server's
            # rng (drafter sampling, acceptance uniforms, residual and
            # bonus draws all come from the one carried key chain)
            spec.dcache, drafts, dprobs, self.rng = spec.draft(
                spec.dparams, spec.dcache, self.prev_tok, self.prev_typ,
                self.tok, self.typ, self.pos, self.rng)
        else:
            spec.dcache, drafts = spec.draft(
                spec.dparams, spec.dcache, self.prev_tok, self.prev_typ,
                self.tok, self.typ, self.pos)
        if self.pager is not None:
            for slot in active:
                # pages covering the whole verify window [pos, pos+γ];
                # writes past logical capacity route to the garbage page
                self.pager.ensure_range(
                    slot, int(self.pager.pos[slot]) + spec.gamma)
            pt = self.pager.device_table(eng.device)
            if spec.stochastic:
                (self.cache, emitted, acc, self.tok, self.prev_tok,
                 self.pos, self.done, self.rng) = spec.paged_verify(
                    eng.params, self.cache, pt, self.tok, self.typ,
                    self.pos, drafts, dprobs, self.done, self.rng)
            else:
                (self.cache, emitted, acc, self.tok, self.prev_tok,
                 self.pos, self.done) = spec.paged_verify(
                    eng.params, self.cache, pt, self.tok, self.typ,
                    self.pos, drafts, self.done)
        elif spec.stochastic:
            (self.cache, emitted, acc, self.tok, self.prev_tok,
             self.pos, self.done, self.rng) = spec.verify(
                eng.params, self.cache, self.tok, self.typ, self.pos,
                drafts, dprobs, self.done, self.rng)
        else:
            (self.cache, emitted, acc, self.tok, self.prev_tok,
             self.pos, self.done) = spec.verify(
                eng.params, self.cache, self.tok, self.typ, self.pos,
                drafts, self.done)
        # every verified token came out of the TARGET's argmax stream,
        # so the verify round leaves prev pointing at a reply-typed token
        self.prev_typ = self.typ.clone()     # written per slot in place
        em, ac, ph = (t.cpu().numpy() for t in (emitted, acc, self.pos))
        for slot in active:
            req = self._slot_req[slot]
            a = int(ac[slot])
            self._spec_totals["rounds"] += 1
            self._spec_totals["drafted"] += spec.gamma
            self._spec_totals["accepted"] += max(a - 1, 0)
            self._spec_totals["corrected"] += min(a, 1)
            self._drafted[slot] += spec.gamma
            self._accepted[slot] += max(a - 1, 0)
            if a == 0:
                # the row latched done in an EARLIER round (capacity):
                # the non-speculative server would emit eos now — retire
                self._retire(slot, finished)
                continue
            retired = False
            for t in em[slot, :a]:
                t = int(t)
                if t == eng.eos_id:
                    self._retire(slot, finished)
                    retired = True
                    break
                req.out.append(t)
                if len(req.out) >= req.max_new:
                    self._retire(slot, finished)
                    retired = True
                    break
            if not retired and self.pager is not None:
                # roll rejected speculative pages back to the accepted
                # frontier — host bookkeeping only
                self.pager.truncate(slot, int(ph[slot]))
        return finished

    def swap_base_params(self, new_params, *, force: bool = False):
        """Promote new BASE weights into the server (the online loop's hot
        swap). Call it with no active slots (``drain()`` first), so every
        per-user delta has been evicted through the bitwise base restore
        and every in-flight reply finished under the weights it was
        admitted with; ``force=True`` swaps under active slots anyway
        (counted in ``dirty_swaps``). Each new tensor is copied onto the
        old one's device and dtype; the personalization index is rebased
        on them. The speculative drafter keeps its snapshot, so its
        acceptance rate since the swap measures the drift."""
        old = self.personalize.base if self.personalize is not None \
            else self.engine.params
        if sorted(new_params) != sorted(old):
            raise ValueError(
                "swap_base_params: incoming params tree does not match "
                "the serving tree — wrong model/config")
        for i, name in enumerate(sorted(old)):
            o, n = old[name], new_params[name]
            if tuple(o.shape) != tuple(n.shape):
                raise ValueError(
                    f"swap_base_params: leaf {i} has shape "
                    f"{tuple(n.shape)}, serving expects {tuple(o.shape)} — "
                    f"wrong model/config")
        active = [s for s, r in enumerate(self._slot_req)
                  if r is not None]
        if active and not force:
            raise RuntimeError(
                f"swap_base_params with {len(active)} active slot(s) — "
                f"drain() first so per-user deltas evict (bitwise base "
                f"restore) and in-flight replies finish under their "
                f"admission-time weights, or pass force=True to break "
                f"parity knowingly")
        placed = {name: new_params[name].detach().to(
            device=old[name].device, dtype=old[name].dtype).clone(
            memory_format=torch.contiguous_format) for name in old}
        self.engine.params = placed
        if self.personalize is not None:
            self.personalize.rebase(placed, force=force)
        self.swaps_done += 1
        if active:
            self.dirty_swaps += 1
        if self.spec is not None:
            # reset the since-swap window; spec.dparams keeps its snapshot
            self._spec_swap_mark = dict(self._spec_totals)
        return placed

    def stats(self) -> Dict[str, object]:
        """Speculation counters: drafted/accepted/corrected totals, the
        aggregate acceptance rate (accepted drafts / drafted), and the
        per-slot acceptance rate over each slot's CURRENT occupancy
        (None for slots that have not drafted since admission). Paged
        servers also report the KV pools' memory: the ``kv_quant`` mode,
        the pool bytes (k, v and scale arrays, all layers) and the
        capacity multiplier against float32 pools of the same page count
        (``ops/kv_quant.py``). Then the swap counters and the slot
        routing: admitted and spilled requests per shard pool, and the
        store's per-shard row reads and writes under personalization."""
        if self.spec is None:
            s: Dict[str, object] = {"speculate_k": 0}
        else:
            s = dict(self._spec_totals)
            s["speculate_k"] = self.spec.gamma
            s["acceptance_rate"] = (s["accepted"] / s["drafted"]
                                    if s["drafted"] else None)
            s["per_slot_acceptance"] = [
                (float(self._accepted[i] / self._drafted[i])
                 if self._drafted[i] else None)
                for i in range(self.slots)]
            # windowed on the last swap_base_params: with the drafter
            # pinned to its pre-swap snapshot, a falling value here IS
            # the personalization-drift signal (how far online training
            # has moved the target since the drafter last saw it)
            dsw = s["drafted"] - self._spec_swap_mark["drafted"]
            asw = s["accepted"] - self._spec_swap_mark["accepted"]
            s["drafted_since_swap"] = dsw
            s["accepted_since_swap"] = asw
            s["acceptance_rate_since_swap"] = (asw / dsw) if dsw else None
        if self.pager is not None:
            from commefficient_tpu_torch.ops import kv_quant as kvq
            cfg = self.engine.model.config
            hd = cfg.n_embd // cfg.n_head
            args = (self.pager.num_pages, self.pager.page_size,
                    cfg.n_head, hd, cfg.n_layer)
            s["kv_quant"] = self.kv_quant
            s["kv_pool_bytes"] = kvq.pool_bytes(
                *args, self.kv_quant,
                base_dtype=cfg.torch_dtype)
            s["kv_capacity_multiplier_vs_f32"] = \
                kvq.capacity_multiplier_vs_f32(*args, self.kv_quant)
        # multi-host axes: TP degree, prefill/decode split, and per-shard
        # routing — admitted/spilled per slot pool, plus the store's own
        # shard read/write counters when a personalization index is
        # attached, so bench rows can report routing skew directly
        s["swaps_done"] = self.swaps_done
        s["dirty_swaps"] = self.dirty_swaps
        s["tp"] = self.engine.tp
        s["disaggregated"] = self.disaggregate
        if self.disaggregate:
            s["prefill_slots"] = self.prefill_slots
        s["num_shards"] = self.num_shards
        s["slots_per_shard"] = self.slots_per_shard
        s["admitted_per_shard"] = [int(x) for x in
                                   self._admitted_per_shard]
        s["spilled_per_shard"] = [int(x) for x in self._spilled_per_shard]
        total_admitted = int(self._admitted_per_shard.sum())
        s["routing_skew"] = (
            float(self._admitted_per_shard.max()
                  / (total_admitted / self.num_shards))
            if total_admitted else None)
        if self.personalize is not None:
            store = self.personalize.store
            s["store_shard_reads"] = [int(x) for x in store.shard_reads]
            s["store_shard_writes"] = [int(x) for x in store.shard_writes]
        return s

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until every submitted request has a reply."""
        replies: Dict[int, List[int]] = {}
        while self._queued() or any(r is not None for r in self._slot_req):
            for rid, toks in self.step():
                replies[rid] = toks
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("serving loop exceeded max_steps")
        return replies

    def drain(self, max_steps: int = 100_000):
        """Graceful preemption shutdown: stop admissions, finish the
        in-flight slots, and hand back what never started.

        Returns ``(replies, leftovers)``: ``replies`` maps rid ->
        reply tokens for every request that had already been admitted
        (their decode completes here — admitted work is never thrown
        away); ``leftovers`` is the undispatched queue — owner-shard and
        anonymous queues merged back into submission order — as
        ``(ids, types, reply_type, max_new)`` tuples (plus a trailing
        ``user_id`` for personalized requests, so re-submission routes
        to the same owner shard) a replacement server can re-``submit``
        verbatim. Because slot rows
        decode independently and greedy sampling is deterministic,
        resubmitting a leftover on a fresh server over the same
        checkpoint yields the reply this server would have produced
        (tests/test_decode.py)."""
        queued = sorted([r for q in [self._queue] + self._shard_queue
                         for r in q], key=lambda r: r.rid)
        leftovers = [(list(r.ids), list(r.types), r.reply_type, r.max_new)
                     + ((r.user_id,) if r.user_id is not None else ())
                     for r in queued]
        self._queue.clear()
        for q in self._shard_queue:
            q.clear()
        replies: Dict[int, List[int]] = {}
        while any(r is not None for r in self._slot_req):
            for rid, toks in self.step():
                replies[rid] = toks
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("drain exceeded max_steps")
        return replies, leftovers
