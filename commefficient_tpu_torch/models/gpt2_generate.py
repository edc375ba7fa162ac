"""Reply generation for ``GPT2DoubleHeads`` (port of
``commefficient_tpu/models/gpt2_generate.py``).

``sample_reply`` is the full-recompute oracle: a whole ``max_seq_len``
forward per generated token over the PersonaChat layout built with
``build_input_from_segments(..., with_eos=False)`` (the causal mask makes
the padding tail invisible to the sampled position). ``sample_reply_cached``
decodes the same reply through the KV cache (``serving.DecodeEngine``):
one prefill, then one single-token step a token. Greedy, the two agree
token for token while prompt and reply fit in ``max_seq_len``.

``params`` is a ``{torch name: tensor}`` dict (the model's own
parameters, or a learner's ``unflatten(weights)``); the forward runs on
their device. Top-k draws come from a ``torch.Generator`` seeded with
``seed``, so they match the reference in distribution only.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.func import functional_call

from commefficient_tpu_torch.data.persona import build_input_from_segments


def params_device(params) -> torch.device:
    return next(iter(params.values())).device


@torch.no_grad()
def sample_reply(model, params, tokenizer, persona: List[List[int]],
                 history: List[List[int]], *, max_seq_len: int = 256,
                 max_reply_len: int = 24, method: str = "greedy",
                 top_k: int = 8, temperature: float = 0.7,
                 seed: int = 0) -> List[int]:
    """Decode a reply (token ids, no eos) for one persona/history context
    with a full forward per token."""
    if method not in ("greedy", "topk"):
        raise ValueError(f"method must be 'greedy' or 'topk', got {method!r}")
    eos = tokenizer.convert_tokens_to_ids("<eos>")
    dev = params_device(params)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    zero = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    reply: List[int] = []
    for _ in range(max_reply_len):
        inst = build_input_from_segments(persona, history, reply, tokenizer,
                                         lm_labels=False, with_eos=False)
        ids = inst["input_ids"][-max_seq_len:]
        types = inst["token_type_ids"][-max_seq_len:]
        L = len(ids)
        ids_arr = np.zeros((1, 1, max_seq_len), np.int32)
        types_arr = np.zeros((1, 1, max_seq_len), np.int32)
        ids_arr[0, 0, :L] = ids
        types_arr[0, 0, :L] = types
        lm, _ = functional_call(model, params, (
            torch.from_numpy(ids_arr).to(dev),
            torch.from_numpy(types_arr).to(dev), zero), {"train": False})
        logits = lm[0, 0, L - 1]
        if method == "greedy":
            nxt = int(torch.argmax(logits))
        else:
            vals, idxs = torch.topk(logits.float() / temperature, top_k)
            choice = torch.multinomial(torch.softmax(vals, -1), 1,
                                       generator=gen)
            nxt = int(idxs[choice[0]])
        if nxt == eos:
            break
        reply.append(nxt)
    return reply


def sample_reply_cached(model, params, tokenizer,
                        persona: List[List[int]],
                        history: List[List[int]], *,
                        max_seq_len: int = 256, max_reply_len: int = 24,
                        method: str = "greedy", top_k: int = 8,
                        temperature: float = 0.7, seed: int = 0,
                        engine=None) -> List[int]:
    """``sample_reply`` through the KV cache. Pass ``engine`` to reuse one
    across calls; its sampling method must be ``method``."""
    if method not in ("greedy", "topk"):
        raise ValueError(f"method must be 'greedy' or 'topk', got {method!r}")
    from commefficient_tpu_torch.serving import DecodeEngine

    inst = build_input_from_segments(persona, history, [], tokenizer,
                                     lm_labels=False, with_eos=False)
    ids = inst["input_ids"][-max_seq_len:]
    types = inst["token_type_ids"][-max_seq_len:]
    eos = tokenizer.convert_tokens_to_ids("<eos>")
    if engine is None:
        cap = min(model.config.n_positions, len(ids) + max_reply_len)
        engine = DecodeEngine(model, params, eos_id=eos, max_len=cap,
                              method=method, top_k=top_k,
                              temperature=temperature)
    elif engine.method != method:
        raise ValueError(f"engine was built for method={engine.method!r}, "
                         f"not {method!r}")
    # generated tokens continue the reply segment: the prompt's trailing
    # speaker token's type
    return engine.generate([(ids, types)], [types[-1]],
                           max_new=max_reply_len, seed=seed)[0]
