"""Fused LM head and cross-entropy, chunked over the vocabulary (port of
``commefficient_tpu/ops/fused_ce.py``).

The materialized LM loss holds (N, V) float32 logits through the forward
and the backward: at GPT2's T 512 that is 64 x 512 x 50,262 floats, 6.6
GB a copy. ``lm_head_nll`` computes the same token NLL with the head's
product folded in, over 8192-column chunks of the tied ``wte``:

* forward: per chunk, ``logits_c = h @ wte_c^T`` and an online
  log-sum-exp (running max, sum of exponentials, the label's logit);
  only the (N,) log-sum-exp is kept for the backward;
* backward: each chunk's logits are recomputed and ``(softmax - onehot)
  * g`` goes straight into the two products, ``dh`` and the chunk's rows
  of ``dwte``.

The reference pads the vocabulary to a multiple of the chunk with
columns at -inf; here the last chunk is short instead, which is the same
arithmetic (a -inf column moves no max and adds exp(-inf) = 0 to the
sum) without copying ``wte``.

The products run in ``compute_dtype``, the model's, as the reference's
do: float32 for a float32 model, which is 1e-6-exact against the
materialized logits; for bfloat16 the inputs are rounded to bfloat16 and
multiplied with float32 accumulation and output (the reference's
``preferred_element_type=float32``), as products of bfloat16 values in
float32. The chunk products are plain ``torch.matmul`` calls: the
reference computes them in an XLA scan, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

CHUNK = 8192


def _rounded(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in float32, so that its
    products accumulate and come out in float32."""
    return x.to(compute_dtype).to(torch.float32)


class _LmHeadNll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, wte, labels, chunk, compute_dtype):
        V = wte.shape[0]
        N = hidden.shape[0]
        hb = _rounded(hidden, compute_dtype)
        m = torch.full((N,), -torch.inf, device=hidden.device)
        s = torch.zeros(N, device=hidden.device)
        ll = torch.zeros(N, device=hidden.device)
        for col0 in range(0, V, chunk):
            wc = _rounded(wte[col0:col0 + chunk], compute_dtype)
            logits = hb @ wc.T                               # (N, c)
            c = logits.shape[1]
            m_new = torch.maximum(m, logits.amax(dim=1))
            rel = labels - col0
            inchunk = (rel >= 0) & (rel < c)
            picked = torch.gather(logits, 1,
                                  rel.clamp(0, c - 1)[:, None])[:, 0]
            ll = ll + torch.where(inchunk, picked, 0.0)
            s = s * torch.exp(m - m_new) + torch.sum(
                logits.sub_(m_new[:, None]).exp_(), dim=1)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(hidden, wte, labels, lse)
        ctx.chunk, ctx.compute_dtype = chunk, compute_dtype
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        hidden, wte, labels, lse = ctx.saved_tensors
        chunk, dt = ctx.chunk, ctx.compute_dtype
        V = wte.shape[0]
        N = hidden.shape[0]
        hb = _rounded(hidden, dt)
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dwte = torch.empty(wte.shape, dtype=torch.float32,
                           device=wte.device)
        rows = torch.arange(N, device=hidden.device)
        for col0 in range(0, V, chunk):
            wc = _rounded(wte[col0:col0 + chunk], dt)
            dl = hb @ wc.T
            c = dl.shape[1]
            dl.sub_(lse[:, None]).exp_()                     # softmax
            rel = labels - col0
            inchunk = (rel >= 0) & (rel < c)
            # - onehot: rows whose label lies in this chunk lose 1 there
            dl.index_put_((rows, rel.clamp(0, c - 1)),
                          -inchunk.to(dl.dtype), accumulate=True)
            dl = _rounded(dl.mul_(g[:, None]), dt)
            dh.addmm_(dl, wc)
            torch.mm(dl.T, hb, out=dwte[col0:col0 + c])
        return dh.to(hidden.dtype), dwte.to(wte.dtype), None, None, None


def lm_head_nll(hidden: torch.Tensor, wte: torch.Tensor,
                labels: torch.Tensor, chunk: int = CHUNK,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Token NLL of ``softmax(hidden @ wte.T)`` at ``labels``: hidden (N,
    E), wte (V, E), labels (N,) integers in [0, V). Returns (N,) float32;
    its gradient reaches ``hidden`` and ``wte``."""
    return _LmHeadNll.apply(hidden, wte, labels.long(), chunk,
                            compute_dtype)


def shifted_lm_nll(hidden: torch.Tensor, wte: torch.Tensor,
                   lm_labels: torch.Tensor, chunk: int = CHUNK,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """The shifted LM loss on hidden states: predictions at positions
    :-1, labels at 1:, label -1 ignored. hidden (..., T, E), lm_labels
    (..., T). Returns (nll sum (...,), labeled-token count (...,))."""
    lead = hidden.shape[:-2]
    T, E = hidden.shape[-2], hidden.shape[-1]
    h = hidden[..., :-1, :].reshape(-1, E)
    labels = lm_labels[..., 1:].reshape(-1)
    valid = labels != -1
    nll = lm_head_nll(h, wte, torch.where(valid, labels, 0), chunk,
                      compute_dtype)
    nll = torch.where(valid, nll, 0.0).reshape(lead + (T - 1,))
    counts = valid.to(torch.float32).reshape(lead + (T - 1,))
    return torch.sum(nll, dim=-1), torch.sum(counts, dim=-1)
