"""Per-user weight personalization of the continuous-batching server (port
of ``commefficient_tpu/serving/personalize.py``).

Under ``--client_state sparse`` the client store holds each client's
O(k) row: the ``cap`` largest-magnitude coordinates of its residual in
the flat gradient space. ``PersonalizationIndex`` serves them: at slot
admission the user's row is added to the served params (``base + scale *
row``), at retirement taken out again. Nothing is made dense and no
per-user copy of the params exists: an admission returns a new dict in
which only the touched tensors are new.

Exactness: a row that is all zero touches nothing (the params object
comes back as it was); with one active user, admission is ``flat(base)
[idx] += scale * val`` and eviction restores base bitwise, because it
writes the base values back (plus what other active users still add
there) instead of subtracting the delta. Several active users compose
additively on shared coordinates.

Flat coordinates are the reference's ``ravel_pytree`` order and flax
layout (``utils/params.flatten_params``): leaves sorted by flax path,
dense kernels (in, out) where the port's tensors are (out, in). The port
works on its ``{torch name: tensor}`` dict and maps each coordinate into
its tensor's own layout. Coordinates past the last leaf fall in no leaf
and are dropped.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from commefficient_tpu_torch.utils.params import flax_path


def _torch_index(lidx: np.ndarray, name: str, shape) -> np.ndarray:
    """Flax-layout C-order offsets within leaf ``name`` -> offsets in the
    torch-layout tensor of ``shape`` (only a ``weight`` is permuted:
    (out, in) <- (in, out), (out, in, kh, kw) <- (kh, kw, in, out))."""
    if name.rsplit(".", 1)[-1] != "weight" or len(shape) not in (2, 4):
        return lidx
    if len(shape) == 2:
        n_out, n_in = shape
        return (lidx % n_out) * n_in + lidx // n_out
    n_out, n_in, kh, kw = shape
    o = lidx % n_out
    rest = lidx // n_out
    i = rest % n_in
    rest //= n_in
    w = rest % kw
    h = rest // kw
    return ((o * n_in + i) * kh + h) * kw + w


class PersonalizationIndex:
    """Refcounted apply and evict of per-user sparse weight deltas.

    ``store`` is a sparse-codec client store (``HostArenaStore``, or the
    online loop's ``LearnerClientStore``); ``field`` the row that serves
    as the delta (``errors``, the residual); ``scale`` multiplies it."""

    def __init__(self, base_params, store, *, field: str = "errors",
                 scale: float = 1.0):
        codec_name = getattr(getattr(store, "codec", None), "name", None)
        if codec_name != "sparse":
            raise ValueError(
                f"personalized serving needs the sparse client-state "
                f"representation (O(k) idx/val rows); store codec is "
                f"{codec_name!r} — run with --client_state sparse")
        if store._arenas.get(field) is None:
            raise ValueError(f"client store has no {field!r} arena")
        self.store = store
        self.field = field
        self.scale = float(scale)
        self.base = base_params
        self._names = sorted(base_params, key=flax_path)
        self._shapes = [tuple(base_params[n].shape) for n in self._names]
        sizes = [int(np.prod(s)) for s in self._shapes]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        self._sizes = sizes
        #: user_id -> {"idx", "val" (scaled), "dead", "count"}
        self.active: Dict[int, dict] = {}

    def _fetch(self, user_id: int) -> dict:
        row = self.store.row(self.field, int(user_id))
        idx = np.asarray(_host(row["idx"]), np.int64)
        val = np.asarray(_host(row["val"]), np.float32)
        if self.scale != 1.0:
            val = (np.float32(self.scale) * val).astype(np.float32)
        # zero entries (the all-zero initial rows repeat index 0) reach no
        # write at all
        return {"idx": idx, "val": val, "dead": val == 0.0, "count": 1}

    def _corr_at(self, idx: np.ndarray) -> np.ndarray:
        """The remaining active users' values at ``idx``: what an eviction
        leaves on shared coordinates."""
        corr = np.zeros(idx.shape, np.float32)
        for other in self.active.values():
            oidx, oval = other["idx"], np.where(other["dead"], np.float32(0),
                                                other["val"])
            order = np.argsort(oidx, kind="stable")
            so, sv = oidx[order], oval[order]
            pos = np.searchsorted(so, idx)
            safe = np.minimum(pos, so.shape[0] - 1)
            hit = (pos < so.shape[0]) & (so[safe] == idx)
            corr += np.where(hit, sv[safe], np.float32(0))
        return corr

    def _leaves(self, idx, dead):
        """(name, torch-layout offsets, selection) of every leaf the live
        entries of ``idx`` touch."""
        for name, shape, off, size in zip(self._names, self._shapes,
                                          self._offsets, self._sizes):
            sel = (idx >= off) & (idx < off + size) & ~dead
            if sel.any():
                yield name, _torch_index(idx[sel] - off, name, shape), sel

    def rebase(self, new_base_params, *, force: bool = False) -> None:
        """Re-anchor on new base weights (the hot swap). Needs no active
        users unless ``force``."""
        if self.active and not force:
            raise RuntimeError(
                f"rebase with {len(self.active)} active user(s) — evict "
                f"them first (server.drain()) so the bitwise "
                f"base-restore contract survives the swap")
        if sorted(new_base_params) != sorted(self._names):
            raise ValueError(
                "rebase: new base params tree does not match the "
                "serving tree — wrong model/config")
        for i, n in enumerate(self._names):
            if tuple(new_base_params[n].shape) != self._shapes[i]:
                raise ValueError(
                    f"rebase: leaf {i} has shape "
                    f"{tuple(new_base_params[n].shape)}, index expects "
                    f"{self._shapes[i]} — wrong model/config")
        self.base = new_base_params

    def admit(self, params, user_id: int):
        """Add ``user_id``'s delta to ``params`` (refcounted: a user active
        in another slot is counted, not applied twice). Returns a new dict
        with the touched tensors replaced, or ``params`` itself."""
        ent = self.active.get(int(user_id))
        if ent is not None:
            ent["count"] += 1
            return params
        ent = self._fetch(user_id)
        self.active[int(user_id)] = ent
        idx, val, dead = ent["idx"], ent["val"], ent["dead"]
        if dead.all():
            return params
        out = dict(params)
        for name, tidx, sel in self._leaves(idx, dead):
            leaf = params[name]
            new = leaf.contiguous().clone()
            flat = new.view(-1)
            t = torch.as_tensor(tidx, device=leaf.device)
            flat[t] = flat[t] + torch.as_tensor(
                val[sel], device=leaf.device).to(leaf.dtype)
            out[name] = new
        return out

    def evict(self, params, user_id: int):
        """Remove ``user_id``'s delta when its last slot retires: its
        coordinates go back to base plus what the still-active users add
        there."""
        ent = self.active.get(int(user_id))
        if ent is None:
            raise KeyError(f"user {user_id} is not active")
        ent["count"] -= 1
        if ent["count"] > 0:
            return params
        del self.active[int(user_id)]
        idx, dead = ent["idx"], ent["dead"]
        if dead.all():
            return params
        corr = self._corr_at(idx)
        out = dict(params)
        for name, tidx, sel in self._leaves(idx, dead):
            leaf = params[name]
            new = leaf.contiguous().clone()
            t = torch.as_tensor(tidx, device=leaf.device)
            base_vals = self.base[name].reshape(-1)[t].to(leaf.dtype)
            c = torch.as_tensor(corr[sel], device=leaf.device).to(leaf.dtype)
            new.view(-1)[t] = torch.where(c != 0, base_vals + c, base_vals)
            out[name] = new
        return out


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x


def personalization_from_checkpoint(fingerprint: Optional[dict], store,
                                    base_params, *, field: str = "errors",
                                    scale: float = 1.0):
    """A ``PersonalizationIndex`` gated on a checkpoint's fingerprint: None
    with a warning when it has no ``client_state`` record, a ValueError
    when that record is not ``sparse``."""
    if fingerprint is None or "client_state" not in fingerprint:
        warnings.warn(
            "checkpoint fingerprint has no client_state record (legacy "
            "checkpoint, or dense state) — serving unpersonalized",
            stacklevel=2)
        return None
    rep = fingerprint["client_state"]
    if rep != "sparse":
        raise ValueError(
            f"--serve_personalized needs --client_state sparse rows, but "
            f"the checkpoint was trained with client_state={rep!r}; "
            f"re-train or re-encode the store before serving deltas")
    return PersonalizationIndex(base_params, store, field=field,
                                scale=scale)
