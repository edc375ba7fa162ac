"""GPipe pipeline parallelism for GPT2 over a ``stage`` process group (port
of ``commefficient_tpu/parallel/pp.py``).

The reference stacks the blocks into one (L, ...) tree, shards contiguous
layer groups over a ``stage`` mesh axis and runs the GPipe schedule as a
``fori_loop`` of ``n_micro + S - 1`` ticks whose carry ``ppermute``s one
hop down the ring. Here rank ``c * S + s`` of a ``clients x stage`` mesh
(``parallel/mesh.py``) is stage ``s`` of client shard ``c``; it applies
the model's ``Block_{s L/S} .. Block_{(s+1) L/S - 1}`` and the schedule
is written out:

* stage 0 embeds its rows (the embedding dropout from ``fold_in(seed,
  EMBED_FOLD)``, the reference's key ``0x0e3bed``) and cuts them into
  ``n_micro`` microbatches of ``B / n_micro`` rows;
* at tick ``t`` stage ``s`` takes microbatch ``m = t - s``: stage 0 its
  own, every other stage the one stage ``s - 1`` sends; it applies its
  blocks and sends the result on to stage ``s + 1``; the last stage keeps
  it;
* a hop is an autograd Function whose backward sends the cotangent back
  (``_SendNext``, ``_RecvPrev``), so the backward is the reverse
  pipeline.

The reference's idle ticks compute only garbage: stage 0 re-feeds the last
microbatch after ``n_micro`` ticks, the other stages start from a zero
carry, ``is_done`` masks what they produce, and what is masked flows only
into other masked work. The port skips those ticks: each stage applies its
blocks ``n_micro`` times, and the logits and gradient are the same.

Order. A rank posts its hops in microbatch order in the forward and in the
reverse order in the backward, on every rank: each hop takes the previous
hop's zero ``link`` as an input, so autograd runs the chain in that order
whatever else it schedules. Each P2P work (tag ``m``) is waited exactly
once, where it is posted (over gloo a work waited twice hangs), and over
gloo CUDA tensors cross through host copies, as the ring's do
(``ops/attention.py``). Forward traffic flows only from stage ``s`` to
``s + 1`` and backward traffic only back, so no wait closes a cycle.

Shared parameters count once. The reference runs the final LayerNorm and
the tied LM head on every device after a psum of the last stage's
outputs; here the last stage alone runs them. So each parameter's
gradient lies on the rank that reads it: a stage's blocks on that stage,
``wpe`` and ``wte``'s embedding part on stage 0, ``wte``'s head part and
the final LayerNorm on the last stage, zeros elsewhere. Summed over the
stage group (the round's reduce spans both axes of the mesh) they are the
unsharded gradient, ``wte``'s two uses added.

Every stage rank still returns the same result. ``gpt2_pp_lm_apply`` has
the last stage broadcast its hidden states, and the others apply the head
to them outside autograd; ``make_gpt2_train_loss_pp`` broadcasts the
per-dialog loss. The other ranks' results carry the rank's zero ``link``,
through which its backward joins; the gradient is that of the last
stage's copy, which every rank computes bit for bit.

Dropout: the seed (folded with the client shard's position: ``dp_axis``
here, the round's ``mesh_seed`` for the loss) is folded with ``t S + s``
each tick and with the layer's index within the stage, as the reference
folds its key; the masks match the reference in distribution only
(ROADMAP.md C6). Blocks run with the model's own options: the flash
kernels under ``attn_impl="blockwise"``, post-LN blocks and no final
LayerNorm for ``arch="openai-gpt"``, ``remat`` through
``models.gpt2._remat_block``. MoE blocks route each microbatch as one
dispatch group (capacity binds per microbatch, as the reference notes);
their load-balancing terms are dropped, as the reference's pipe discards
them (the entry point refuses MoE on a stage axis).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from commefficient_tpu_torch.federated.losses import _lm_nll_sums
from commefficient_tpu_torch.models.gpt2 import _remat_block
from commefficient_tpu_torch.ops.dropout import fold_in
from commefficient_tpu_torch.parallel import mesh as mesh_lib

#: fold-in of the embedding dropout's seed (the reference's key 0x0e3bed)
EMBED_FOLD = 0x0E3BED


def stack_block_params(params: dict, n_layer: int):
    """``{Block_i.<name>: tensor}`` -> (``{<name>: (n_layer, ...) stacked
    tensor}``, the non-block remainder)."""
    blocks = [_sub_params(params, f"Block_{i}") for i in range(n_layer)]
    stacked = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    rest = {k: v for k, v in params.items() if not k.startswith("Block_")}
    return stacked, rest


def _sub_params(params: dict, prefix: str) -> dict:
    """The entries of submodule ``prefix``, under their local names."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


@dataclass(frozen=True)
class StageContext:
    """A rank's place on the stage axis: its group, stage and the size."""
    group: object
    rank: int
    size: int

    @classmethod
    def from_mesh(cls, mesh) -> Optional["StageContext"]:
        """The ``stage`` axis of ``mesh`` (None without one above 1)."""
        if mesh_lib.stage_size(mesh) == 1:
            return None
        return cls(mesh_lib.stage_group(mesh), mesh_lib.stage_rank(mesh),
                   mesh_lib.stage_size(mesh))

    def _global(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def _host(self) -> bool:
        return dist.get_backend(self.group) == "gloo"

    def send(self, x: torch.Tensor, step: int, tag: int) -> None:
        """``x`` to the stage ``step`` away, waited once here."""
        buf = x.detach().contiguous()
        if self._host():
            buf = buf.cpu()
        dist.isend(buf, self._global(self.rank + step), group=self.group,
                   tag=tag).wait()

    def recv(self, shape, dtype, device, step: int, tag: int):
        """A tensor from the stage ``step`` away, waited once here."""
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self._host() else device)
        dist.irecv(buf, self._global(self.rank + step), group=self.group,
                   tag=tag).wait()
        return buf.to(device)

    def from_last(self, x: Optional[torch.Tensor], shape, dtype, device):
        """The last stage's ``x`` on every stage rank (outside autograd;
        ``shape``, ``dtype`` and ``device`` for the others' buffers)."""
        last = self.rank == self.size - 1
        buf = (x.detach().contiguous() if last
               else torch.empty(shape, dtype=dtype, device=device))
        if self._host():
            buf = buf.cpu()
        dist.broadcast(buf, src=self._global(self.size - 1),
                       group=self.group)
        return buf.to(device)


class _SendNext(torch.autograd.Function):
    """Forward: microbatch ``m``'s output ``y`` to the next stage; returns
    a zero link chained after ``link`` (the previous hop's, or None).
    Backward: ``y``'s cotangent from the next stage."""

    @staticmethod
    def forward(ctx, y, link, stage: StageContext, m: int):
        ctx.stage, ctx.m = stage, m
        ctx.like = (y.shape, y.dtype, y.device)
        stage.send(y, 1, m)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, g_link):
        g = ctx.stage.recv(*ctx.like, 1, ctx.m)
        return g, (g_link if ctx.needs_input_grad[1] else None), None, None


class _RecvPrev(torch.autograd.Function):
    """Forward: microbatch ``m``'s input from the previous stage, and a
    zero link for the next hop. ``anchor`` is the previous hop's link, or
    for ``m`` = 0 a parameter of the stage, which gets no gradient from
    here: an input through which the leaves reach this node, so autograd
    runs it. Backward: the input's cotangent to the previous stage."""

    @staticmethod
    def forward(ctx, anchor, stage: StageContext, m: int, like):
        ctx.stage, ctx.m = stage, m
        x = stage.recv(*like, -1, m)
        return x, x.new_zeros(())

    @staticmethod
    def backward(ctx, g_x, g_link):
        ctx.stage.send(g_x, -1, ctx.m)
        return (None if ctx.m == 0 else torch.zeros_like(g_link),
                None, None, None)


def _embed(model, params, ids, types, train, seed):
    """The token, position and type embeddings' sum, with the model's
    embedding dropout (``EMBED_FOLD`` of ``seed``)."""
    wte = params["wte.embedding"]
    pos = torch.arange(ids.shape[-1], device=ids.device)[None, :]
    x = (F.embedding(ids, wte) + F.embedding(pos, params["wpe.embedding"])
         + F.embedding(types, wte))
    return model.emb_drop(x, None if seed is None
                          else fold_in(seed, EMBED_FOLD), train)


def _head(model, params, h):
    """The final LayerNorm (GPT-2; none for post-LN GPT-1) and the tied LM
    head: (..., vocab) float32 logits."""
    x = h.float()
    if model.config.arch == "gpt2":
        x = functional_call(model.LayerNorm_0,
                            _sub_params(params, "LayerNorm_0"), (x,))
    return x @ params["wte.embedding"].T


def _pipeline(model, params, ids, types, n_micro, ctx, train, seed):
    """This stage's part of the schedule over (B, T) ``ids``: (the last
    stage's (B, T, C) outputs, None elsewhere; the zero link of this
    rank's last send, None on the last stage)."""
    cfg = model.config
    S, s = (1, 0) if ctx is None else (ctx.size, ctx.rank)
    per = cfg.n_layer // S
    B, T = ids.shape
    mb = B // n_micro
    dropout_on = train and cfg.dropout > 0
    remat = cfg.remat and train and torch.is_grad_enabled()
    wte = params["wte.embedding"]
    like = ((mb, T, wte.shape[1]), wte.dtype, wte.device)
    blocks = [(getattr(model, f"Block_{i}"),
               _sub_params(params, f"Block_{i}"))
              for i in range(s * per, (s + 1) * per)]
    if s == 0:
        micro = _embed(model, params, ids, types, train,
                       seed if dropout_on else None).split(mb)
    else:
        anchor = next(iter(blocks[0][1].values()))
    link, outs = None, []
    for m in range(n_micro):
        if s == 0:
            x = micro[m]
        else:
            x, anchor = _RecvPrev.apply(anchor, ctx, m, like)
        tick = fold_in(seed, (m + s) * S + s) if dropout_on else None
        for li, (block, bp) in enumerate(blocks):
            layer_seed = None if tick is None else fold_in(tick, li)
            if remat:
                x, _ = _remat_block(block, x, train, layer_seed, bp)
            else:
                x, _ = functional_call(block, bp, (x, train, layer_seed))
        if s < S - 1:
            link = _SendNext.apply(x, link, ctx, m)
        else:
            outs.append(x)
    if s < S - 1:
        return None, link
    return torch.cat(outs), None


def _check(model, S: int, B: int, n_micro: int, train: bool, seed,
           n_dp: int = 1, dp_axis: Optional[str] = None):
    """The reference's refusals, in its order."""
    cfg = model.config
    if cfg.attn_impl == "ring":
        raise ValueError("gpt2_pp_lm_apply supports attn_impl "
                         "'full'/'blockwise', not 'ring'")
    if train and cfg.dropout > 0 and seed is None:
        raise ValueError("training with dropout={} requires a seed — "
                         "running without would silently drop the "
                         "configured regularization".format(cfg.dropout))
    if cfg.n_layer % S:
        raise ValueError(f"n_layer ({cfg.n_layer}) must divide by stages "
                         f"({S})")
    if B % n_dp:
        raise ValueError(f"batch ({B}) must divide by the {dp_axis} axis "
                         f"({n_dp})")
    if n_micro < 1 or (B // n_dp) % n_micro:
        raise ValueError(f"per-shard batch ({B // n_dp}) must divide by "
                         f"n_micro ({n_micro})")


def gpt2_pp_lm_apply(mesh, model, params, input_ids, token_type_ids,
                     n_micro: int, *, dp_axis: Optional[str] = None,
                     train: bool = True, seed: Optional[int] = None):
    """LM logits of a ``GPT2DoubleHeads`` through the GPipe pipeline over
    ``mesh``'s stage axis (a ``make_mesh(n, stage=S)`` mesh, or None for
    one process). ``params`` is ``{torch name: tensor}``; ``input_ids``
    and ``token_type_ids`` are (B, T). With ``dp_axis`` (the mesh's
    ``clients``) each client shard pipelines its block of B / n_dp rows
    and folds its position into ``seed``; without it every shard runs
    every row. Returns this shard's (rows, T, vocab) float32 logits, the
    same on every stage rank. ``train`` with dropout > 0 needs ``seed``."""
    S = mesh_lib.stage_size(mesh)
    B = input_ids.shape[0]
    n_dp = mesh_lib.clients_size(mesh, dp_axis) if dp_axis else 1
    _check(model, S, B, n_micro, train, seed, n_dp, dp_axis)
    if dp_axis:
        rows = mesh_lib.worker_block(B, mesh)
        input_ids, token_type_ids = input_ids[rows], token_type_ids[rows]
        if seed is not None:
            seed = fold_in(seed, mesh_lib.clients_rank(mesh, dp_axis))
    ctx = StageContext.from_mesh(mesh)
    hidden, link = _pipeline(model, params, input_ids.long(),
                             token_type_ids.long(), n_micro, ctx, train,
                             seed)
    if ctx is None:
        return _head(model, params, hidden)
    wte = params["wte.embedding"]
    shape = tuple(input_ids.shape) + (wte.shape[1],)
    if hidden is not None:
        ctx.from_last(hidden, shape, hidden.dtype, hidden.device)
        return _head(model, params, hidden)
    seen = ctx.from_last(None, shape, wte.dtype, wte.device)
    with torch.no_grad():
        logits = _head(model, params, seen)
    return logits + link


def make_gpt2_train_loss_pp(mesh, model, n_micro: int,
                            lm_coef: float = 1.0):
    """The pipelined GPT2 LM loss (the contract of
    ``losses.make_gpt2_train_loss`` at ``mc_coef`` 0): the round hands
    each rank its client shard's (B, C, T) batch (the reference's
    ``dp_axis="clients"``) and the seed folded with the shard's position;
    the B * C sequences run through the pipeline in ``n_micro``
    microbatches, and the last stage takes the LM NLL, the mean over each
    dialog's labeled tokens times ``lm_coef``. Returns (the (B,) loss,
    the same on every stage rank; zero (1, B) metrics). LM-only: the
    entry point demands ``--mc_coef 0``."""
    ctx = StageContext.from_mesh(mesh)
    S = 1 if ctx is None else ctx.size

    def apply_loss(params, batch, seed, train):
        input_ids, _, lm_labels, _, token_type_ids = batch
        B, C, T = input_ids.shape
        _check(model, S, B * C, n_micro, train, seed)
        hidden, link = _pipeline(model, params,
                                 input_ids.reshape(B * C, T).long(),
                                 token_type_ids.reshape(B * C, T).long(),
                                 n_micro, ctx, train, seed)
        loss = None
        if hidden is not None:
            lm = _head(model, params, hidden).reshape(B, C, T, -1)
            nll_sum, tokens = _lm_nll_sums(lm, lm_labels)
            loss = lm_coef * (nll_sum / torch.clamp(tokens, min=1.0))
        dev = input_ids.device
        if ctx is not None:
            seen = ctx.from_last(loss, (B,), torch.float32, dev)
            if loss is None:
                loss = seen + link
        return loss, torch.zeros((1, B), device=dev)

    return apply_loss
