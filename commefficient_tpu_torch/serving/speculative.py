"""Speculative decoding over the serving stack (port of
``commefficient_tpu/serving/speculative.py``).

A small drafter (its own dense KV cache) proposes ``gamma`` tokens per
slot; the target verifies the row's pending token and the drafts in one
multi-token forward through its cache (dense, or the paged pools through
``ops.attention.paged_verify_attention``). Greedy acceptance keeps the
longest prefix of drafts that matches the target's own argmax stream plus
one corrected or bonus token, so every emitted token is a target argmax
and the stream is the non-speculative greedy stream. Under
``--serve_sample topk`` acceptance follows the stochastic residual rule
(Leviathan et al. 2023; Chen et al. 2023): draft d_i, sampled from the
drafter's top-k distribution p_i, is accepted with probability
``min(1, q_i(d_i) / p_i(d_i))``, and a rejection emits a draw from the
normalized ``max(q_i - p_i, 0)``; each emitted token is distributed as
q_i. Acceptance is computed with masks over the whole slot array, so
variable per-slot acceptance needs no change of shape. Rejected paged
entries are rolled back on the host (``PagedKVCache.truncate``): the
masks make entries above a row's frontier unattendable until overwritten.

Each draft round first rewrites the accepted token at ``pos - 1`` into the
drafter's cache (a no-op rewrite when it is there already, the missing
write after a fully accepted round), then feeds the pending token at
``pos`` and feeds itself ``gamma - 1`` times.

The default drafter is the target itself, its params taken at
construction: with personalized serving those are the base weights, and
the verify reads the personalized ``engine.params``.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch.func import functional_call

from commefficient_tpu_torch.models.gpt2 import init_decode_cache
from commefficient_tpu_torch.serving.decode import sample_next


def drafter_fingerprint(config) -> dict:
    """The drafter-identity record a serving checkpoint carries."""
    return {"arch": config.arch, "vocab_size": int(config.vocab_size),
            "n_positions": int(config.n_positions),
            "n_embd": int(config.n_embd),
            "n_layer": int(config.n_layer),
            "n_head": int(config.n_head)}


def speculation_from_checkpoint(fingerprint: Optional[dict],
                                drafter_config, *,
                                speculate_k: int) -> int:
    """The effective ``--speculate_k`` for a checkpoint's fingerprint:
    unchanged when its ``drafter`` record matches ``drafter_config``, 0
    (non-speculative, with a warning) when the record is missing or
    differs."""
    if speculate_k < 1:
        return 0
    if fingerprint is None or "drafter" not in fingerprint:
        warnings.warn(
            "checkpoint fingerprint has no drafter record (legacy "
            "checkpoint, or trained without a drafter) — serving "
            "non-speculative; re-save the checkpoint with a drafter "
            "fingerprint to enable --speculate_k", stacklevel=2)
        return 0
    want = drafter_fingerprint(drafter_config)
    got = fingerprint["drafter"]
    if got != want:
        warnings.warn(
            f"checkpoint drafter fingerprint {got} does not match the "
            f"served drafter config {want} — serving non-speculative; "
            f"point --speculate_k at the drafter the checkpoint was "
            f"saved with", stacklevel=2)
        return 0
    return int(speculate_k)


class SpeculativeDecoder:
    """Draft and verify for one (target engine, drafter) pair: ``gamma``
    drafts a round, ``slots`` rows in the drafter's dense cache. The
    drafter defaults to the target with its params at construction."""

    def __init__(self, engine, *, gamma: int, slots: int,
                 drafter_model=None, drafter_params=None):
        if gamma < 1:
            raise ValueError(
                f"speculate_k must be >= 1 to speculate, got {gamma}; "
                f"use 0 (or omit the flag) to serve non-speculatively")
        self.stochastic = engine.method == "topk"
        self.engine = engine
        self.gamma = int(gamma)
        self.slots = int(slots)
        self.dmodel = drafter_model if drafter_model is not None \
            else engine.model
        # personalization's admit returns a new dict, so this stays the
        # base weights while engine.params carries the users' deltas
        self.dparams = drafter_params if drafter_params is not None \
            else engine.params
        dcfg = self.dmodel.config
        tcfg = engine.model.config
        if dcfg.vocab_size != tcfg.vocab_size:
            raise ValueError(
                f"drafter vocab {dcfg.vocab_size} != target vocab "
                f"{tcfg.vocab_size}: draft tokens must be target tokens")
        if dcfg.n_positions < engine.max_len:
            raise ValueError(
                f"drafter n_positions {dcfg.n_positions} < server "
                f"max_len {engine.max_len}: the drafter must cover every "
                f"position the target can decode at")
        self.dcache = init_decode_cache(dcfg, self.slots, engine.max_len,
                                        device=engine.device)
        if self.stochastic:
            self.draft = self._draft_stoch
            self.verify = self._verify_stoch
            self.paged_verify = self._paged_verify_stoch
        else:
            self.draft = self._draft
            self.verify = self._verify
            self.paged_verify = self._paged_verify

    # ---- drafter -------------------------------------------------------

    def init_drafter_row(self):
        return init_decode_cache(self.dmodel.config, 1, self.engine.max_len,
                                 device=self.engine.device)

    @torch.no_grad()
    def _dapply(self, dparams, ids2d, types2d, dcache, pos, logits_at):
        B = ids2d.shape[0]
        logits, _, dcache = functional_call(self.dmodel, dparams, (
            ids2d[:, None, :], types2d[:, None, :],
            torch.zeros((B, 1), dtype=torch.int32, device=ids2d.device)), {
            "train": False, "cache": dcache, "position": pos,
            "logits_at": logits_at})
        return logits, dcache

    def dprefill(self, dparams, dcache, ids, types, last_idx):
        """Fill a B = 1 drafter cache row from the padded prompt (its logits
        are not used: the first token comes from the target)."""
        pos0 = torch.zeros((ids.shape[0],), dtype=torch.int32,
                           device=ids.device)
        _, dcache = self._dapply(dparams, ids, types, dcache, pos0,
                                 last_idx)
        return dcache

    def _catch_up(self, dparams, dcache, prev_tok, prev_typ, pos):
        zero = torch.zeros_like(pos)
        _, dcache = self._dapply(dparams, prev_tok[:, None],
                                 prev_typ[:, None], dcache,
                                 torch.clamp(pos - 1, min=0), zero)
        return dcache

    def _draft(self, dparams, dcache, prev_tok, prev_typ, tok, type_tok,
               pos):
        """One greedy draft round: the catch-up write, then ``gamma``
        single-token drafter forwards. Returns (dcache, drafts (B,
        gamma))."""
        dcache = self._catch_up(dparams, dcache, prev_tok, prev_typ, pos)
        zero = torch.zeros_like(tok)
        drafts = []
        cur, p = tok, pos
        for _ in range(self.gamma):
            logits, dcache = self._dapply(dparams, cur[:, None],
                                          type_tok[:, None], dcache, p, zero)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(cur)
            p = p + 1
        return dcache, torch.stack(drafts, dim=1)

    def _topk_dist(self, logits):
        """Full-vocab probabilities of the engine's top-k rule on
        ``logits`` (..., V): the softmax of the temperature-scaled top-k
        scores at their vocab coordinates, zero elsewhere."""
        eng = self.engine
        vals, idxs = torch.topk(logits.float() / eng.temperature, eng.top_k,
                                dim=-1)
        p = torch.softmax(vals, dim=-1)
        return torch.zeros(logits.shape, dtype=torch.float32,
                           device=logits.device).scatter_(-1, idxs, p)

    def _draft_stoch(self, dparams, dcache, prev_tok, prev_typ, tok,
                     type_tok, pos, gen):
        """The stochastic draft round: each draft sampled from the
        drafter's top-k distribution, returned with the distributions.
        Returns (dcache, drafts (B, gamma), dprobs (B, gamma, V), gen)."""
        eng = self.engine
        dcache = self._catch_up(dparams, dcache, prev_tok, prev_typ, pos)
        zero = torch.zeros_like(tok)
        drafts, dists = [], []
        cur, p = tok, pos
        for _ in range(self.gamma):
            logits, dcache = self._dapply(dparams, cur[:, None],
                                          type_tok[:, None], dcache, p, zero)
            dists.append(self._topk_dist(logits))
            cur, gen = sample_next(logits, gen, method="topk",
                                   top_k=eng.top_k,
                                   temperature=eng.temperature)
            drafts.append(cur)
            p = p + 1
        return (dcache, torch.stack(drafts, dim=1),
                torch.stack(dists, dim=1), gen)

    # ---- target verify and acceptance -----------------------------------

    def _window(self, ids, emitted_src, alive, acc, pos, done):
        """The round's outputs from the alive mask: emitted tokens (eos
        where not alive), and each row's new token, previous token,
        position and done latch."""
        eos = self.engine.eos_id
        max_len = self.engine.max_len
        emitted = torch.where(alive, emitted_src,
                              torch.full_like(emitted_src, eos))
        last_idx = torch.clamp(acc - 1, min=0)[:, None].long()
        last = torch.gather(emitted_src, 1, last_idx)[:, 0]
        # the token now at new_pos - 1: next round's catch-up token
        new_prev = torch.gather(ids, 1, last_idx)[:, 0]
        new_done = done | (last == eos) | (pos + acc >= max_len)
        new_tok = torch.where(new_done, torch.full_like(last, eos), last)
        new_pos = torch.clamp(pos + acc, max=max_len - 1).to(pos.dtype)
        return emitted, acc, new_tok, new_prev, new_pos, new_done

    def _gates(self, match, no_eos, pos, done):
        B, G1 = match.shape
        cap = (pos[:, None] + torch.arange(G1, device=pos.device)[None, :]
               < self.engine.max_len)
        live = match & no_eos & cap & ~done[:, None]
        alive = torch.cumprod(live.to(torch.int32), dim=1).bool()
        return alive, alive.sum(dim=1).to(torch.int32)

    def _accept(self, ids, tstar, pos, done):
        """Greedy acceptance over the verified window: emission j
        (tstar[j]) is realized iff the row is live, every earlier draft
        matched the target's argmax, no earlier emission was eos and the
        capacity holds — the non-speculative step's schedule."""
        B = ids.shape[0]
        eos = self.engine.eos_id
        ones = torch.ones((B, 1), dtype=torch.bool, device=ids.device)
        match = torch.cat([ones, ids[:, 1:] == tstar[:, :-1]], 1)
        no_eos = torch.cat([ones, tstar[:, :-1] != eos], 1)
        alive, acc = self._gates(match, no_eos, pos, done)
        return self._window(ids, tstar, alive, acc, pos, done)

    @torch.no_grad()
    def _target_logits(self, params, cache, tok, type_tok, pos, drafts):
        eng = self.engine
        ids = torch.cat([tok[:, None], drafts], dim=1)
        B, G1 = ids.shape
        types = type_tok[:, None].expand(B, G1)
        lm, _, cache = functional_call(eng.model, params, (
            ids[:, None, :], types[:, None, :],
            torch.zeros((B, 1), dtype=torch.int32, device=ids.device)), {
            "train": False, "cache": cache, "position": pos,
            "verify": True, "logits_all": True})
        return cache, ids, lm                               # lm (B, G1, V)

    def _verify(self, params, cache, tok, type_tok, pos, drafts, done):
        """Verify gamma + 1 positions through the dense slot cache. Returns
        (cache, emitted (B, gamma + 1), acc (B,), new_tok, new_prev,
        new_pos, new_done)."""
        cache, ids, lm = self._target_logits(params, cache, tok, type_tok,
                                             pos, drafts)
        tstar = torch.argmax(lm, dim=-1).to(torch.int32)
        return (cache,) + self._accept(ids, tstar, pos, done)

    def _paged_verify(self, params, pools, pt, tok, type_tok, pos, drafts,
                      done):
        """``_verify`` through the pools and page table (the host allocated
        pages covering pos..pos+gamma; writes past the capacity go to the
        garbage page)."""
        cache = tuple({**p, "pt": pt} for p in pools)
        _, ids, lm = self._target_logits(params, cache, tok, type_tok, pos,
                                         drafts)
        tstar = torch.argmax(lm, dim=-1).to(torch.int32)
        return (pools,) + self._accept(ids, tstar, pos, done)

    def _accept_stoch(self, ids, qdist, dprobs, pos, done, gen):
        """Stochastic acceptance over the window: draft ids[:, i + 1] is
        accepted with probability min(1, q_i(d) / p_i(d)); the emission
        after the last accepted draft is a draw from the normalized
        residual max(q - p, 0), or from q_gamma (the bonus token) after a
        fully accepted window. The gates are ``_accept``'s, the eos gate
        reading the accepted draft."""
        B, G1 = ids.shape
        G = G1 - 1
        eos = self.engine.eos_id
        nxt = ids[:, 1:, None].long()
        q_d = torch.gather(qdist[:, :-1], -1, nxt)[..., 0]   # (B, G)
        p_d = torch.gather(dprobs, -1, nxt)[..., 0]          # (B, G)
        u = torch.rand((B, G), generator=gen, device=ids.device)
        accept = u < torch.clamp(q_d / torch.clamp(p_d, min=1e-20), max=1.0)
        ones = torch.ones((B, 1), dtype=torch.bool, device=ids.device)
        match = torch.cat([ones, accept], 1)
        no_eos = torch.cat([ones, ids[:, 1:] != eos], 1)
        alive, acc = self._gates(match, no_eos, pos, done)
        # fallback draws: the residuals after a rejection, q_gamma at the
        # window's end; an all-zero residual is never selected (its ratio
        # is 1), the uniform stand-in only keeps the draw defined
        residual = torch.clamp(qdist[:, :-1] - dprobs, min=0.0)
        rsum = residual.sum(dim=-1, keepdim=True)
        residual = torch.where(rsum > 0, residual,
                               torch.ones_like(residual))
        fall = torch.cat([residual, qdist[:, -1:]], dim=1)   # (B, G1, V)
        V = fall.shape[-1]
        fallback = torch.multinomial(fall.reshape(-1, V), 1,
                                     generator=gen).reshape(B, G1)
        fallback = fallback.to(torch.int32)
        accept_next = torch.cat(
            [accept, torch.zeros((B, 1), dtype=torch.bool,
                                 device=ids.device)], 1)
        draft_next = torch.cat([ids[:, 1:], ids[:, -1:]], 1)
        realized = torch.where(accept_next, draft_next, fallback)
        return self._window(ids, realized, alive, acc, pos, done) + (gen,)

    def _verify_stoch(self, params, cache, tok, type_tok, pos, drafts,
                      dprobs, done, gen):
        """Stochastic verify through the dense slot cache. Returns (cache,
        emitted, acc, new_tok, new_prev, new_pos, new_done, gen)."""
        cache, ids, lm = self._target_logits(params, cache, tok, type_tok,
                                             pos, drafts)
        return (cache,) + self._accept_stoch(ids, self._topk_dist(lm),
                                             dprobs, pos, done, gen)

    def _paged_verify_stoch(self, params, pools, pt, tok, type_tok, pos,
                            drafts, dprobs, done, gen):
        """The paged stochastic verify."""
        cache = tuple({**p, "pt": pt} for p in pools)
        _, ids, lm = self._target_logits(params, cache, tok, type_tok, pos,
                                         drafts)
        return (pools,) + self._accept_stoch(ids, self._topk_dist(lm),
                                             dprobs, pos, done, gen)
