"""Module <-> flat vector at the compression boundary, in JAX's coordinates.

The CountSketch hashes flat coordinate indices and top-k breaks ties by
flat index, so the port's flat vector must be exactly the reference's:
``jax.flatten_util.ravel_pytree`` over the flax params tree. That ravels
leaves in sorted-key order (for ResNet9: ``ConvBN_0 … ConvBN_3, Dense_0,
Residual_0, Residual_1``) and each leaf in flax layout: conv kernels
``(kh, kw, in, out)``, dense kernels ``(in, out)``.

The port's modules name their submodules after flax's auto-names
(``ConvBN_0.Conv_0.weight`` is flax's ``ConvBN_0/Conv_0/kernel``), so the
bridge needs no per-model table: a torch parameter name maps to its flax
path by renaming ``weight`` to ``kernel``, and its layout by permuting
torch's ``(out, in, kh, kw)`` / ``(out, in)`` to flax's.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

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


def to_flax_layout(t):
    """torch layout -> flax layout (a permuted view; works on numpy too)."""
    if t.ndim == 4:     # (out, in, kh, kw) -> (kh, kw, in, out)
        return t.permute(2, 3, 1, 0) if torch.is_tensor(t) \
            else t.transpose(2, 3, 1, 0)
    if t.ndim == 2:     # (out, in) -> (in, out)
        return t.T
    return t


def from_flax_layout(t):
    """flax layout -> torch layout (inverse of ``to_flax_layout``)."""
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1) if torch.is_tensor(t) \
            else t.transpose(3, 2, 0, 1)
    if t.ndim == 2:
        return t.T
    return t


def _ordered(names):
    return sorted(names, key=flax_path)


def flatten_params(module: torch.nn.Module
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                     Dict[str, torch.Tensor]]]:
    """(flat vector, unflatten) for ``module``'s parameters in the
    reference's ``ravel_pytree`` order and layout.

    ``unflatten(flat)`` returns ``{torch name: torch-layout view}`` of
    ``flat`` for ``torch.func.functional_call``; autograd through those
    views lands the gradient in flat (JAX) coordinates."""
    params = dict(module.named_parameters())
    names = _ordered(params)
    flax_shapes = [tuple(to_flax_layout(params[n]).shape) for n in names]
    sizes = [int(np.prod(s)) for s in flax_shapes]
    flat = torch.cat([to_flax_layout(params[n].detach()).reshape(-1)
                      for n in names])

    def unflatten(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for n, shape, size in zip(names, flax_shapes, sizes):
            out[n] = from_flax_layout(vec[off:off + size].view(shape))
            off += size
        return out

    return flat, unflatten


def params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """A flax params tree (nested dicts of arrays) -> torch state_dict."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                arr = np.asarray(val, dtype=np.float32)
                out[torch_name(path + (key,))] = torch.from_numpy(
                    np.ascontiguousarray(from_flax_layout(arr)))

    walk(flax_params, ())
    return out


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
            to_flax_layout(t.detach().cpu().numpy()))
    return tree
