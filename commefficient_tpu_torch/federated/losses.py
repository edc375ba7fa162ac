"""Loss callables (port of ``commefficient_tpu/federated/losses.py``:
``make_cv_loss``, ``make_gpt2_train_loss``, ``make_gpt2_val_loss``).

Contract: ``apply_loss(params, batch_tuple, seed, train) -> (per-example
loss (B,), per-example metrics (M, B))``, where ``params`` is a ``{torch
name: tensor}`` dict for ``torch.func.functional_call`` and ``seed`` an
int from which the model draws its dropout bits in training (the
reference's rng; None where nothing is drawn).

A GPT2 model built with ``config.fused_lm_head`` returns hidden states,
and both GPT2 losses then take the LM NLL from the vocab-chunked fused
head (``ops/fused_ce.py``) with the tied ``wte``: autograd adds the
head's part of the ``wte`` gradient to the embedding's.

With an MoE model (``config.moe_experts > 0``) the training loss adds
``moe_aux_weight`` times the blocks' Switch load-balancing term, averaged
over the layers, to every per-example entry (reference ``losses.py:
98-145``); the validation loss leaves it out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from commefficient_tpu_torch.ops.fused_ce import shifted_lm_nll


def make_cv_loss(model: torch.nn.Module):
    """Cross-entropy + top-1 correctness for image classifiers."""

    def apply_loss(params, batch, seed, train):
        images, targets = batch
        logits = functional_call(model, params, (images,))
        targets = targets.long()
        loss = F.cross_entropy(logits, targets, reduction="none")
        correct = (torch.argmax(logits, -1) == targets).to(torch.float32)
        return loss, correct[None, :]

    return apply_loss


def shift_labels(lm_labels: torch.Tensor) -> torch.Tensor:
    """Next-token targets: shifted[t] = labels[t+1], the last position -1
    (ignored)."""
    return torch.cat([lm_labels[..., 1:],
                      torch.full_like(lm_labels[..., :1], -1)], dim=-1)


def _lm_nll_sums(lm_logits, lm_labels):
    """(nll token-sum, labeled-token count) per dialog over the shifted
    positions whose label is not -1 (ref CrossEntropyLoss(ignore_index=-1),
    gpt2_train.py:77-87)."""
    labels = shift_labels(lm_labels.long())
    valid = labels != -1
    safe = torch.where(valid, labels, 0)
    V = lm_logits.shape[-1]
    nll = F.cross_entropy(lm_logits.reshape(-1, V), safe.reshape(-1),
                          reduction="none").reshape(labels.shape)
    nll = torch.where(valid, nll, 0.0)
    return (torch.sum(nll, dim=(-2, -1)),
            torch.sum(valid, dim=(-2, -1)).to(torch.float32))


def _fused_nll_sums(model, hidden, params, lm_labels):
    """(nll token-sum, labeled-token count) per dialog from the hidden
    states through the fused head (reference ``losses.py:77-100``),
    summed over the candidates as ``_lm_nll_sums`` sums; the head's
    products run in the model's compute dtype."""
    nll_sum, tokens = shifted_lm_nll(hidden, params["wte.embedding"],
                                     lm_labels,
                                     compute_dtype=model.config.torch_dtype)
    return torch.sum(nll_sum, dim=-1), torch.sum(tokens, dim=-1)


def _forward(model, params, batch, seed, train, return_aux=False):
    input_ids, mc_token_ids, _, _, token_type_ids = batch
    return functional_call(model, params,
                           (input_ids, token_type_ids, mc_token_ids),
                           {"train": train, "seed": seed,
                            "return_aux": return_aux})


def make_gpt2_train_loss(model, lm_coef: float = 1.0, mc_coef: float = 1.0,
                         moe_aux_weight: float = 1e-2):
    """LM + multiple-choice loss (reference compute_loss_train,
    gpt2_train.py:88-99): the LM NLL is the mean over each dialog's
    labeled tokens, so every dialog weighs the same in the round. An MoE
    model adds ``moe_aux_weight`` times its load-balancing term to each
    entry, so the round's datapoint-weighted mean carries exactly that."""
    fused = model.config.fused_lm_head
    moe = model.config.moe_experts > 0

    def apply_loss(params, batch, seed, train):
        lm_out, mc_logits, *aux = _forward(model, params, batch, seed, train,
                                           return_aux=moe)
        if fused:
            nll_sum, tokens = _fused_nll_sums(model, lm_out, params,
                                              batch[2])
        else:
            nll_sum, tokens = _lm_nll_sums(lm_out, batch[2])
        lm_loss = nll_sum / torch.clamp(tokens, min=1.0)
        mc_loss = F.cross_entropy(mc_logits, batch[3].long(),
                                  reduction="none")
        loss = lm_coef * lm_loss + mc_coef * mc_loss
        if moe:
            loss = loss + moe_aux_weight * aux[0]
        return loss, torch.zeros((1, loss.shape[0]), device=loss.device)

    return apply_loss


def make_gpt2_val_loss(model):
    """NLL + multiple-choice accuracy (reference compute_loss_val,
    gpt2_train.py:77-87). Metric rows: [mc accuracy, nll token-sum,
    labeled-token count]; the rollup recovers the reference's
    token-weighted nll as sum(nll_sums) / sum(token_counts)."""
    fused = model.config.fused_lm_head

    def apply_loss(params, batch, seed, train):
        lm_out, mc_logits = _forward(model, params, batch, None, False)
        if fused:
            nll_sum, tokens = _fused_nll_sums(model, lm_out, params,
                                              batch[2])
        else:
            nll_sum, tokens = _lm_nll_sums(lm_out, batch[2])
        acc = (torch.argmax(mc_logits, -1) == batch[3].long()).to(
            torch.float32)
        return (nll_sum / torch.clamp(tokens, min=1.0),
                torch.stack([acc, nll_sum, tokens]))

    return apply_loss
