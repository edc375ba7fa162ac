"""Module <-> flat vector at the compression boundary, in JAX's coordinates.

The CountSketch hashes flat coordinate indices and top-k breaks ties by
flat index, so the port's flat vector must be exactly the reference's:
``jax.flatten_util.ravel_pytree`` over the flax params tree. That ravels
leaves in sorted-key order, component by component as strings (for
ResNet9: ``ConvBN_0 … ConvBN_3, Dense_0, Residual_0, Residual_1``; for
GPT2 ``Block_10`` comes before ``Block_2``), and each leaf in flax layout:
conv kernels ``(kh, kw, in, out)``, dense kernels ``(in, out)``.

The port's modules name their submodules after flax's auto-names
(``ConvBN_0.Conv_0.weight`` is flax's ``ConvBN_0/Conv_0/kernel``) and
their other leaves after flax's (``embedding`` of ``nn.Embed``, ``scale``
and ``bias`` of ``nn.LayerNorm``, ``bias`` of ``nn.Dense``), so the bridge
needs no per-model table: a torch parameter name maps to its flax path by
renaming ``weight`` to ``kernel``, and only a ``weight`` changes layout,
torch's ``(out, in, kh, kw)`` / ``(out, in)`` permuted to flax's. Every
other leaf keeps its layout (an embedding table is ``(num, features)`` on
both sides; so do GPT2's stacked MoE experts, ``moe_w1``/``moe_b1``/
``moe_w2``/``moe_b2`` under ``Block_i.moe``, whose router is a ``weight``
like any dense kernel), and the sorted flax paths put ``moe``'s leaves
in the reference's flat order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def round_up(n: int, multiple: int) -> int:
    """n rounded up to a multiple (the one padding rule)."""
    return -(-int(n) // int(multiple)) * int(multiple)


def flax_path(name: str) -> Tuple[str, ...]:
    """torch parameter name -> flax params path."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def torch_name(path: Tuple[str, ...]) -> str:
    parts = list(path)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def to_flax_layout(t, leaf: str = "weight"):
    """torch layout -> flax layout of the leaf named ``leaf`` (a permuted
    view; works on numpy too). Only a ``weight`` is permuted."""
    if leaf != "weight":
        return t
    if t.ndim == 4:     # (out, in, kh, kw) -> (kh, kw, in, out)
        return t.permute(2, 3, 1, 0) if torch.is_tensor(t) \
            else t.transpose(2, 3, 1, 0)
    if t.ndim == 2:     # (out, in) -> (in, out)
        return t.T
    return t


def from_flax_layout(t, leaf: str = "kernel"):
    """flax layout -> torch layout of the flax leaf named ``leaf`` (inverse
    of ``to_flax_layout``). Only a ``kernel`` is permuted."""
    if leaf != "kernel":
        return t
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1) if torch.is_tensor(t) \
            else t.transpose(3, 2, 0, 1)
    if t.ndim == 2:
        return t.T
    return t


def _ordered(names):
    return sorted(names, key=flax_path)


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def flatten_params(module: torch.nn.Module
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                     Dict[str, torch.Tensor]]]:
    """(flat vector, unflatten) for ``module``'s parameters in the
    reference's ``ravel_pytree`` order and layout.

    ``unflatten(flat)`` returns ``{torch name: torch-layout view}`` of
    ``flat`` for ``torch.func.functional_call``; a leaf's gradient written
    through the same view of a flat gradient lands in flat (JAX)
    coordinates."""
    params = dict(module.named_parameters())
    names = _ordered(params)
    leaves = [flax_path(n)[-1] for n in names]
    flax_shapes = [tuple(to_flax_layout(params[n], _leaf(n)).shape)
                   for n in names]
    sizes = [int(np.prod(s)) for s in flax_shapes]
    flat = torch.cat([to_flax_layout(params[n].detach(),
                                     _leaf(n)).reshape(-1) for n in names])

    def unflatten(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for n, leaf, shape, size in zip(names, leaves, flax_shapes, sizes):
            out[n] = from_flax_layout(vec[off:off + size].view(shape), leaf)
            off += size
        return out

    return flat, unflatten


def scalar_lr_multipliers(module: torch.nn.Module,
                          scalar_factor: float) -> torch.Tensor:
    """(d,) float32 per-coordinate LR multipliers in ``flatten_params``
    order: ``scalar_factor`` for the size-1 leaves (Fixup's scalar biases
    and scales), 1.0 elsewhere (the reference's ``utils/params.py:45``)."""
    params = dict(module.named_parameters())
    return torch.cat([
        torch.full((params[n].numel(),),
                   scalar_factor if params[n].numel() == 1 else 1.0,
                   dtype=torch.float32) for n in _ordered(params)])


def params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """A flax params tree (nested dicts of arrays) -> torch state_dict."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                # a copy: arrays fetched from JAX are read-only
                arr = np.array(val, dtype=np.float32)
                out[torch_name(path + (key,))] = torch.from_numpy(
                    np.ascontiguousarray(from_flax_layout(arr, key)))

    walk(flax_params, ())
    return out


def batch_stats_from_jax(batch_stats) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree -> the BatchNorm buffers of the torch
    state_dict (``.../BatchNorm_0/mean`` is ``....BatchNorm_0.mean``); its
    leaves keep their layout."""
    return params_from_jax(batch_stats)


def params_to_jax(state_dict) -> dict:
    """torch state_dict -> flax params tree of numpy arrays (inverse of
    ``params_from_jax``)."""
    tree: dict = {}
    for name, t in state_dict.items():
        path = flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(
            to_flax_layout(t.detach().cpu().numpy(), _leaf(name)))
    return tree


def _tensor(arr, device) -> Optional[torch.Tensor]:
    if arr is None:
        return None
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def server_opt_from_arrays(opt, device="cpu"):
    """A ``ServerOptState`` from any object with ``Vvelocity``/``Verror``
    arrays (the reference's state, or numpy)."""
    from commefficient_tpu_torch.federated.state import ServerOptState
    return ServerOptState(Vvelocity=_tensor(opt.Vvelocity, device),
                          Verror=_tensor(opt.Verror, device))


def _rows_with_sink(arr, device):
    """One field's ``(num_clients, ...)`` storage (an array, or a dict of
    arrays: a codec's encoding) as tensors with the port's zero sink row
    appended (``federated/client_store``)."""
    if arr is None:
        return None
    if isinstance(arr, dict):
        return {key: _rows_with_sink(val, device) for key, val in arr.items()}
    t = torch.from_numpy(np.array(arr)).to(device)
    return torch.cat([t, torch.zeros_like(t[:1])])


def client_state_from_arrays(clients, device="cpu"):
    """A ``ClientState`` from any object with ``(num_clients, ...)``
    ``velocities``/``errors``/``weights`` storage or None (the reference's
    device rows in any codec: dense arrays, sparse ``{"idx", "val"}``,
    sketched ``{"table"}``), each with the port's zero sink row appended."""
    from commefficient_tpu_torch.federated.state import ClientState
    return ClientState(**{
        field: _rows_with_sink(getattr(clients, field, None), device)
        for field in ("velocities", "errors", "weights")})


def host_store_from_arrays(store, host_clients) -> None:
    """Fill a port ``HostArenaStore`` with the rows of the reference
    learner's ``host_clients`` (``{field: per-client row view or None}``,
    each row an array or a dict of arrays in the run's encoding)."""
    for field, rows in host_clients.items():
        if rows is None:
            continue
        for cid in range(len(rows)):
            row = rows[cid]
            store.set_row(field, cid, {k: np.array(v) for k, v in row.items()}
                          if isinstance(row, dict) else np.array(row))
