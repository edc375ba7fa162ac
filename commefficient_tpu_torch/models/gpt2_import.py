"""HF -> port GPT-2 pretrained-weight import (port of
``commefficient_tpu/models/gpt2_import.py``).

Maps a locally cached HF ``gpt2`` (or ``openai-gpt``) state dict onto
``GPT2DoubleHeads``' parameters: wte, wpe, the blocks and the final
LayerNorm copied, the multiple-choice head left at its fresh init (the
pretrained LM has none).

Layout: HF's ``Conv1D`` weights are (in, out), the reference's flax
``Dense`` kernel layout, so each goes through ``from_flax_layout`` to the
port's (out, in); the fused q|k|v projection splits in the same order on
both sides. Embedding tables may differ in row count (added special
tokens, a shorter ``n_positions``): the overlapping leading rows are
copied and the rest keep their fresh init, as the reference's
``resize_token_embeddings`` leaves them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from commefficient_tpu_torch.utils.params import (from_flax_layout,
                                                  to_flax_layout)


def _copy_rows(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Copy the overlapping leading rows of ``src`` into a copy of ``dst``."""
    if dst.shape[1:] != src.shape[1:]:
        raise ValueError(f"column shape mismatch: {dst.shape} vs {src.shape}")
    out = np.array(dst, copy=True)
    n = min(dst.shape[0], src.shape[0])
    out[:n] = src[:n]
    return out


# per block: (HF key suffix, port parameter under Block_i); ln_1/ln_2 are
# LayerNorm_0/LayerNorm_1 in both archs (post-LN reorders the calls, not
# the modules)
_BLOCK_KEYS = (
    ("ln_1.weight", "LayerNorm_0.scale"), ("ln_1.bias", "LayerNorm_0.bias"),
    ("attn.c_attn.weight", "CausalSelfAttention_0.Dense_0.weight"),
    ("attn.c_attn.bias", "CausalSelfAttention_0.Dense_0.bias"),
    ("attn.c_proj.weight", "CausalSelfAttention_0.Dense_1.weight"),
    ("attn.c_proj.bias", "CausalSelfAttention_0.Dense_1.bias"),
    ("ln_2.weight", "LayerNorm_1.scale"), ("ln_2.bias", "LayerNorm_1.bias"),
    ("mlp.c_fc.weight", "Dense_0.weight"), ("mlp.c_fc.bias", "Dense_0.bias"),
    ("mlp.c_proj.weight", "Dense_1.weight"),
    ("mlp.c_proj.bias", "Dense_1.bias"))


def import_hf_gpt2(params: Dict[str, torch.Tensor],
                   state_dict: Dict[str, np.ndarray],
                   arch: str = "gpt2") -> Dict[str, torch.Tensor]:
    """Return a copy of ``params`` with HF GPT-2/GPT-1 weights written in.

    ``params``: ``{torch name: tensor}`` of a ``GPT2DoubleHeads`` (fresh
    init), e.g. ``dict(model.named_parameters())``. ``state_dict``: the HF
    state dict as numpy arrays, with or without the ``transformer.``
    prefix. ``arch='openai-gpt'`` reads GPT-1's layout (``tokens_embed``,
    ``positions_embed``, no final LayerNorm). Raises KeyError when an HF
    tensor is missing and ValueError when a shape does not fit."""
    if arch not in ("gpt2", "openai-gpt"):
        raise ValueError(f"unknown arch {arch!r}")
    sd = {k.removeprefix("transformer."): np.asarray(v, np.float32)
          for k, v in state_dict.items()}
    if arch == "openai-gpt":
        wte_key, wpe_key = "tokens_embed.weight", "positions_embed.weight"
    else:
        wte_key, wpe_key = "wte.weight", "wpe.weight"
    p = {k: v.detach().clone() for k, v in params.items()}

    def put(value: np.ndarray, name: str):
        leaf = name.rsplit(".", 1)[-1]
        have = tuple(to_flax_layout(p[name], leaf).shape)
        if have != value.shape:
            raise ValueError(f"{name}: model has {have}, HF has "
                             f"{value.shape}")
        flax_leaf = "kernel" if leaf == "weight" else leaf
        p[name] = from_flax_layout(torch.from_numpy(value), flax_leaf
                                   ).contiguous().to(p[name])

    for name, key in (("wte.embedding", wte_key),
                      ("wpe.embedding", wpe_key)):
        p[name] = torch.from_numpy(_copy_rows(
            p[name].cpu().numpy(), sd[key])).to(p[name])
    n_layer = len({k.split(".")[0] for k in p if k.startswith("Block_")})
    for i in range(n_layer):
        for hf, port in _BLOCK_KEYS:
            put(sd[f"h.{i}.{hf}"], f"Block_{i}.{port}")
    if arch == "gpt2":
        put(sd["ln_f.weight"], "LayerNorm_0.scale")
        put(sd["ln_f.bias"], "LayerNorm_0.bias")
    return p


def load_hf_state_dict(model_checkpoint: str = "gpt2",
                       verbose: bool = True
                       ) -> Optional[Dict[str, np.ndarray]]:
    """The HF checkpoint's state dict from the local cache, or None with
    the reference's "not locally cached" message (``transformers`` is
    imported here, and nothing is fetched). ``openai-gpt`` checkpoints
    load through the GPT-1 model class."""
    try:
        if "openai-gpt" in model_checkpoint:
            from transformers import OpenAIGPTLMHeadModel as _HFModel
        else:
            from transformers import GPT2LMHeadModel as _HFModel
        hf = _HFModel.from_pretrained(model_checkpoint,
                                      local_files_only=True)
    except Exception as e:
        if verbose:
            print(f"pretrained {model_checkpoint!r} not locally cached "
                  f"({type(e).__name__}); training from scratch")
        return None
    return {k: v.detach().cpu().numpy() for k, v in hf.state_dict().items()}


def try_load_hf_pretrained(params: Dict[str, torch.Tensor],
                           model_checkpoint: str = "gpt2",
                           verbose: bool = True,
                           arch: str = "gpt2"
                           ) -> Optional[Dict[str, torch.Tensor]]:
    """``params`` with a locally cached HF checkpoint's weights written
    in, or None when there is no cache or the checkpoint does not fit the
    model (a message says which)."""
    sd = load_hf_state_dict(model_checkpoint, verbose=verbose)
    if sd is None:
        return None
    try:
        out = import_hf_gpt2(params, sd, arch=arch)
    except (KeyError, ValueError) as e:
        if verbose:
            print(f"pretrained {model_checkpoint!r} does not fit this model "
                  f"config ({e}); training from scratch")
        return None
    if verbose:
        print(f"loaded pretrained HF {model_checkpoint!r} "
              f"({sum(v.size for v in sd.values())} params)")
    return out
