"""Finetune helpers (port of ``commefficient_tpu/utils/finetune.py``): load
pretrained weights from a checkpoint v3 file of either package, swap in a
fresh classifier head, and freeze the rest.

Parameter names here are the flax paths joined by "/" (the port's
``ConvBN_0.Conv_0.weight`` is ``ConvBN_0/Conv_0/kernel``), in the flat
vector's order (``utils/params.py``), so a mask is the reference's
coordinate for coordinate.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.utils.params import (_ordered, flatten_params,
                                                  flax_path)


def _param_names(model: torch.nn.Module) -> List[Tuple[str, str, int]]:
    """``[(torch name, flax path "a/b/kernel", size)]`` in flat order."""
    params = dict(model.named_parameters())
    return [(n, "/".join(flax_path(n)), params[n].numel())
            for n in _ordered(params)]


def mask_for_params(model: torch.nn.Module,
                    predicate: Callable[[str], bool]) -> torch.Tensor:
    """Flat (d,) float32 0/1 mask in ``flatten_params`` order: 1 where
    ``predicate(flax path)`` holds."""
    return torch.cat([torch.full((size,), 1.0 if predicate(path) else 0.0,
                                 dtype=torch.float32)
                      for _, path, size in _param_names(model)])


def _module_sort_key(name: str):
    """Order module paths by (depth, numeric suffix, name): ``Dense_10``
    after ``Dense_9``, shallow modules above nested ones."""
    parts = name.split("/")
    suffix = parts[-1].rsplit("_", 1)[-1]
    num = int(suffix) if suffix.isdigit() else -1
    return (-len(parts), num, name)


def _head(model: torch.nn.Module, head_substring: str) -> str:
    names = [path for _, path, _ in _param_names(model)]
    heads = [n.rsplit("/", 1)[0] for n in names if head_substring in n]
    if not heads:
        raise ValueError(f"no parameter path contains {head_substring!r}; "
                         f"paths: {names[:5]}...")
    return max(set(heads), key=_module_sort_key)


def head_only_mask(model: torch.nn.Module,
                   head_substring: str = "Dense") -> torch.Tensor:
    """The trainable mask of the classifier head alone: the shallowest,
    highest-numbered module whose path contains ``head_substring``."""
    head = _head(model, head_substring)
    return mask_for_params(model, lambda n: n.startswith(head))


def _name_in_head(model: torch.nn.Module, name: str,
                  head_substring: str) -> bool:
    return name.startswith(_head(model, head_substring))


def _resolve(checkpoint_file: str) -> str:
    """A directory's one plain export, else its newest valid step file."""
    if not os.path.isdir(checkpoint_file):
        return checkpoint_file
    from commefficient_tpu_torch.utils.checkpoint import (
        _STEP_RE, find_latest_checkpoint)
    # step files are mid-training saves behind a .latest pointer; only a
    # plain export is the directory's checkpoint, and two are ambiguous
    cands = sorted(f for f in os.listdir(checkpoint_file)
                   if f.endswith(".npz") and not _STEP_RE.match(f))
    if len(cands) > 1:
        raise ValueError(f"{checkpoint_file} holds several checkpoints "
                         f"{cands}; pass the specific .npz file")
    if cands:
        return os.path.join(checkpoint_file, cands[0])
    found = find_latest_checkpoint(checkpoint_file)
    if found is None:
        raise FileNotFoundError(f"no .npz checkpoint in {checkpoint_file}")
    return found


def load_pretrained_for_finetune(
        model: torch.nn.Module, checkpoint_file: str,
        head_substring: str = "Dense",
        make_model: Optional[Callable[[dict], torch.nn.Module]] = None):
    """Put a checkpoint's weights into ``model`` (freshly initialized)
    except its head, and return the head-only trainable mask.

    The reference's finetune: load the pretrained weights, freeze every
    parameter, train a fresh head. A checkpoint with as many coordinates
    as ``model`` overwrites every non-head coordinate. One with another
    count (a head for another number of classes) needs the file's
    ``meta``: ``make_model(meta)`` (default: ``models.get_model(meta
    ["model"], num_classes=meta["num_classes"])``) rebuilds the
    pretrained model, and every leaf of the same name and shape is
    restored; a leaf left fresh outside the head raises."""
    checkpoint_file = _resolve(checkpoint_file)
    flat, unflatten = flatten_params(model)
    head_mask = head_only_mask(model, head_substring)
    with np.load(checkpoint_file) as z:
        if "weights_idx" not in z.files:
            raise ValueError(
                f"{checkpoint_file} has no 'weights_idx' marker — re-save "
                "with this version's save_checkpoint")
        saved = z[f"arr_{int(z['weights_idx'])}"]
        meta = json.loads(str(z["meta"])) if "meta" in z.files else None
    params = dict(model.named_parameters())
    if saved.shape == tuple(flat.shape):
        merged = torch.where(head_mask > 0, flat,
                             torch.from_numpy(saved).to(flat.dtype))
        leaves = unflatten(merged)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(leaves[n])
        return model, head_mask

    # head swap: the coordinate counts differ
    if meta is None:
        raise ValueError(
            f"pretrained weights have {saved.shape[0]} coordinates, model "
            f"has {flat.shape[0]}, and the checkpoint carries no model "
            "metadata for a head swap — re-save with save_checkpoint(meta=...)")
    if make_model is None:
        from commefficient_tpu_torch.models import get_model

        def make_model(meta):
            return get_model(meta["model"], num_classes=meta["num_classes"])
    old = make_model(meta)
    old_flat, old_unflatten = flatten_params(old)
    if saved.shape != tuple(old_flat.shape):
        raise ValueError(
            f"checkpoint meta {meta} rebuilds a model with "
            f"{old_flat.shape[0]} coordinates but the saved vector has "
            f"{saved.shape[0]} — metadata/weights mismatch")
    old_leaves = old_unflatten(torch.from_numpy(saved).to(old_flat.dtype))
    not_restored = []
    with torch.no_grad():
        for n, p in params.items():
            src = old_leaves.get(n)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src)
            else:
                # fresh init (the swapped head)
                not_restored.append("/".join(flax_path(n)))
    bad = [n for n in not_restored
           if not _name_in_head(model, n, head_substring)]
    if bad:
        raise ValueError(
            f"architecture mismatch beyond the head: {bad} have no "
            "pretrained counterpart")
    return model, head_mask
