"""KV-cached decode for ``GPT2DoubleHeads`` (port of
``commefficient_tpu/serving/decode.py``).

``sample_reply`` runs a full ``max_seq_len`` forward per generated token.
``DecodeEngine`` replaces it with

* ``prefill`` — one causal forward over the padded prompt window that
  fills the KV cache and returns the logits at each row's last real token
  (never the (B, T, V) tensor; under ``blockwise`` on a CUDA tensor the
  attention is the flash forward);
* ``step`` — one token for every row: single-query attention against the
  cache (``ops.attention.decode_attention``, O(S) a token) and the
  sampling, all on the device;
* ``paged_step`` / ``paged_insert`` — the same against block-paged pools
  (``serving/paged_cache.py``), and the pack of a prefilled row into pool
  pages;
* ``generate_tokens`` — prefill and ``max_new - 1`` steps with no host
  read between tokens.

Rows are independent: each carries its own write position, its own
``done`` latch (eos sampled, or the cache full) and, under the
continuous-batching server, its own request. Done rows ride along and
emit ``eos_id``.

``params`` is a ``{torch name: tensor}`` dict for
``torch.func.functional_call``, passed to every program so a caller can
serve new weights; the programs run on its device. The cache tensors are
written in place. Sampling draws from an explicit ``torch.Generator`` on
that device (the reference's key chain becomes the generator's stream):
greedy draws nothing; top-k matches the reference in distribution only.

Tensor-parallel serving (``DecodeEngine(mesh=, tp_axis="model")``, the
reference's ``--serve_tp``): every rank of the model axis runs the same
programs on the same inputs, the model tensor-parallel
(``parallel/tp.attach``: each block on the rank's H/M heads and 4C/M
hidden units, one all-reduce closing its attention and one its MLP), and
every KV cache and page pool holds the rank's H/M heads
(``parallel/tp.kv_cache_specs``; a quantized pool's scale rows with
them). The params stay whole on every rank and each product reads its
rank's piece, so a personalized or hot-swapped tree is served as it is.
The host page table and the continuous-batching bookkeeping run alike on
every rank. The logits are replicated after the last all-reduce, so
every rank samples the same token.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from commefficient_tpu_torch.models.gpt2 import init_decode_cache
from commefficient_tpu_torch.models.gpt2_generate import params_device
from commefficient_tpu_torch.parallel import tp as tp_lib


def sample_next(logits, gen, *, method: str, top_k: int,
                temperature: float):
    """Next-token ids (B,) int32 from (B, V) logits: the argmax, or a draw
    from the temperature-scaled top-k softmax with ``gen``. Returns
    ``(ids, gen)``."""
    if method == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32), gen
    vals, idxs = torch.topk(logits.float() / temperature, top_k, dim=-1)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                               generator=gen)           # (B, 1)
    return torch.gather(idxs, 1, choice)[:, 0].to(torch.int32), gen


class DecodeEngine:
    """The decode programs of one (model, params) pair. ``max_len`` is the
    cache capacity (prompt plus generated tokens), at most the model's
    position table. ``mesh`` with a ``tp_axis`` above 1: tensor-parallel
    serving (the module docstring); the engine attaches the axis to
    ``model``."""

    def __init__(self, model, params, *, eos_id: int,
                 max_len: Optional[int] = None, pad_id: int = 0,
                 method: str = "greedy", top_k: int = 8,
                 temperature: float = 0.7, mesh=None,
                 tp_axis: str = "model"):
        if method not in ("greedy", "topk"):
            raise ValueError(f"method must be 'greedy' or 'topk', "
                             f"got {method!r}")
        cfg = model.config
        self.mesh = None
        self.tp_axis = tp_axis
        self.tp = 1
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if mesh is not None and tp_axis in names \
                and mesh[tp_axis].size() > 1:
            tp = int(mesh[tp_axis].size())
            if cfg.n_head % tp:
                raise ValueError(
                    f"tensor-parallel serving shards the KV head axis: "
                    f"n_head {cfg.n_head} must be divisible by the "
                    f"'{tp_axis}' mesh axis size {tp}")
            self.mesh = mesh
            self.tp = tp
            tp_lib.attach(model, tp_lib.TPContext.from_mesh(mesh, tp_axis))
        self.model = model
        self.params = params
        self.device = params_device(params)
        self.max_len = int(max_len) if max_len else int(cfg.n_positions)
        if self.max_len > cfg.n_positions:
            raise ValueError(f"max_len {self.max_len} exceeds n_positions "
                             f"{cfg.n_positions}")
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id)
        self.method = method
        self.top_k = int(top_k)
        self.temperature = float(temperature)

    # ---- programs ----------------------------------------------------

    def new_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init_cache(self, batch_size: int):
        return init_decode_cache(self.model.config, batch_size,
                                 self.max_len, device=self.device)

    def sample(self, logits, gen):
        return sample_next(logits, gen, method=self.method, top_k=self.top_k,
                           temperature=self.temperature)

    @torch.no_grad()
    def _apply(self, params, ids2d, types2d, cache, pos, logits_at=None,
               **kw):
        B = ids2d.shape[0]
        logits, _, cache = functional_call(self.model, params, (
            ids2d[:, None, :], types2d[:, None, :],
            torch.zeros((B, 1), dtype=torch.int32, device=ids2d.device)), {
            "train": False, "cache": cache, "position": pos,
            "logits_at": logits_at, **kw})
        return logits, cache

    def prefill(self, params, cache, ids, types, last_idx):
        """Fill ``cache`` from padded prompts ``ids``/``types`` (B, P);
        returns (logits (B, V) at each row's ``last_idx``, cache)."""
        pos0 = torch.zeros((ids.shape[0],), dtype=torch.int32,
                           device=ids.device)
        return self._apply(params, ids, types, cache, pos0, last_idx)

    def _advance(self, logits, gen, pos, done):
        nxt, gen = self.sample(logits, gen)
        new_done = done | (nxt == self.eos_id) | (pos + 1 >= self.max_len)
        nxt = torch.where(done, torch.full_like(nxt, self.eos_id), nxt)
        new_pos = torch.clamp(pos + 1, max=self.max_len - 1)
        return nxt, new_pos, gen, new_done

    def step(self, params, cache, tok, type_tok, pos, gen, done):
        """Advance every row one token: ``tok`` (B,) is written to the cache
        at ``pos``. Returns (cache, next_tok, next_pos, gen, next_done);
        done rows emit ``eos_id``."""
        logits, cache = self._apply(params, tok[:, None], type_tok[:, None],
                                    cache, pos, torch.zeros_like(tok))
        nxt, new_pos, gen, new_done = self._advance(logits, gen, pos, done)
        return cache, nxt, new_pos, gen, new_done

    def init_paged_pools(self, num_pages: int, page_size: int,
                         kv_quant: str = "none"):
        """Zero per-layer page pools: one ``{"k", "v"}`` dict per layer of
        (num_pages, page_size, n_head, head_dim) in the compute dtype, or
        with ``kv_quant`` int8/int4 the quantized pools plus float32
        ``k_scale``/``v_scale`` of (num_pages, n_head)
        (``ops/kv_quant.py``). Page 0 is the garbage page. Under tensor
        parallelism the pools and scale rows hold the rank's heads."""
        from commefficient_tpu_torch.ops import kv_quant as kvq
        kvq.validate_mode(kv_quant)
        cfg = self.model.config
        hd = cfg.n_embd // cfg.n_head
        heads = tp_lib.local_heads(cfg)
        dev = self.device
        if kv_quant == "none":
            shape = (int(num_pages), int(page_size), heads, hd)
            return tuple({"k": torch.zeros(shape, dtype=cfg.torch_dtype,
                                           device=dev),
                          "v": torch.zeros(shape, dtype=cfg.torch_dtype,
                                           device=dev)}
                         for _ in range(cfg.n_layer))
        shape = (int(num_pages), int(page_size), heads,
                 kvq.packed_head_dim(hd, kv_quant))
        sshape = (int(num_pages), heads)
        dt = kvq.pool_dtype(kv_quant)
        return tuple({"k": torch.zeros(shape, dtype=dt, device=dev),
                      "v": torch.zeros(shape, dtype=dt, device=dev),
                      "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                             device=dev),
                      "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                             device=dev)}
                     for _ in range(cfg.n_layer))

    def paged_step(self, params, pools, pt, tok, type_tok, pos, gen, done):
        """``step`` against the pools and the (B, max_pages) page table
        ``pt``; the same token, position and done semantics."""
        cache = tuple({**p, "pt": pt} for p in pools)
        logits, _ = self._apply(params, tok[:, None], type_tok[:, None],
                                cache, pos, torch.zeros_like(tok))
        nxt, new_pos, gen, new_done = self._advance(logits, gen, pos, done)
        return pools, nxt, new_pos, gen, new_done

    @torch.no_grad()
    def paged_insert(self, pools, row_cache, dst):
        """Pack a B = 1 prefilled dense cache row into pool pages: ``dst``
        (prefill_len // page_size,) maps the prompt's logical pages to
        pool pages (pages past the prompt point at the garbage page).
        Quantized pools quantize at the pack, page and scale together, so
        a shared page shares its scale row too."""
        from commefficient_tpu_torch.ops import kv_quant as kvq
        n = dst.shape[0]
        dst = dst.long()
        for pool, row in zip(pools, row_cache):
            P = pool["k"].shape[1]

            def pages_of(r):
                return r[0, :n * P].reshape((n, P) + tuple(r.shape[2:]))

            if "k_scale" in pool:
                mode = kvq.infer_mode(pool["k"], row["k"].shape[-1])
                qk, sk = kvq.quantize_pages(pages_of(row["k"]), mode)
                qv, sv = kvq.quantize_pages(pages_of(row["v"]), mode)
                pool["k"][dst] = qk
                pool["v"][dst] = qv
                pool["k_scale"][dst] = sk
                pool["v_scale"][dst] = sv
            else:
                pool["k"][dst] = pages_of(row["k"]).to(pool["k"].dtype)
                pool["v"][dst] = pages_of(row["v"]).to(pool["v"].dtype)
        return pools

    def generate_tokens(self, params, ids, types, lengths, reply_type, gen,
                        *, max_new: int):
        """Prefill and ``max_new - 1`` steps: ids/types (B, P) padded
        prompts, ``lengths`` (B,), ``reply_type`` (B,) the token type of
        generated tokens. Returns (B, max_new) tokens, eos from each row's
        first eos on."""
        B = ids.shape[0]
        cache = self.init_cache(B)
        logits, cache = self.prefill(params, cache, ids, types, lengths - 1)
        first, gen = self.sample(logits, gen)
        pos = lengths.to(torch.int32)              # next write position
        full = pos >= self.max_len                 # prompt filled the cache
        done = (first == self.eos_id) | full
        first = torch.where(full, torch.full_like(first, self.eos_id), first)
        pos = torch.clamp(pos, max=self.max_len - 1)
        out = [first]
        tok = first
        for _ in range(max_new - 1):
            cache, tok, pos, gen, done = self.step(params, cache, tok,
                                                   reply_type, pos, gen, done)
            out.append(tok)
        return torch.stack(out, dim=1)

    # ---- host-side convenience ---------------------------------------

    def generate(self, prompts: Sequence[Tuple[Sequence[int],
                                               Sequence[int]]],
                 reply_types: Sequence[int], *, max_new: int,
                 seed: int = 0,
                 prefill_len: Optional[int] = None) -> List[List[int]]:
        """Decode replies for a batch of (ids, types) prompts, padded to one
        window; each row is cut at its first eos (one device-to-host copy
        for the whole decode)."""
        B = len(prompts)
        longest = max(len(ids) for ids, _ in prompts)
        P = int(prefill_len or longest)
        if longest > P:
            raise ValueError(f"prompt length {longest} exceeds prefill "
                             f"window {P}")
        if P > self.max_len:
            raise ValueError(f"prefill window {P} exceeds cache capacity "
                             f"{self.max_len}")
        ids = np.full((B, P), self.pad_id, np.int32)
        types = np.full((B, P), self.pad_id, np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, (row_ids, row_types) in enumerate(prompts):
            L = len(row_ids)
            ids[i, :L] = row_ids
            types[i, :L] = row_types
            lengths[i] = L
        dev = self.device
        toks = self.generate_tokens(
            self.params, torch.from_numpy(ids).to(dev),
            torch.from_numpy(types).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.as_tensor(np.asarray(reply_types, np.int32), device=dev),
            self.new_generator(seed), max_new=int(max_new)).cpu().numpy()
        return [self.truncate(row) for row in toks]

    def truncate(self, row) -> List[int]:
        """Tokens before the first eos (eos excluded), as python ints."""
        out: List[int] = []
        for t in row:
            if int(t) == self.eos_id:
                break
            out.append(int(t))
        return out
