"""Checkpoint format v3 (port of ``commefficient_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` holding the learner's whole federated state
(weights, virtual momentum and error, the clients' rows, the
byte-accounting vectors) under the reference's names, so a file written
by either package loads in the other:

* ``arr_i`` with ``leaf_paths`` (the JSON list of the JAX ``FedState``'s
  key paths: ``.weights``, ``.opt.Vvelocity``, ``.clients.errors`` or
  ``.clients.errors['idx']``, ``.round_idx``, ...); the buffered server's
  ``.buffer`` leaves are never saved. The port's client rows carry one
  sink row past the clients (``federated/client_store.py``): it is
  dropped on save and a zero row appended on load;
* ``host_{field}`` (``host_{field}__{leaf}`` for an encoded row) for
  offloaded client rows, read from the host arenas after the offload
  pipeline has drained;
* ``rounds_done``, the byte totals, ``weights_idx`` (which ``arr_i`` is
  the weight vector, for ``utils/finetune.py``), ``format_version``, and
  optional ``meta``, ``cursor`` and ``fingerprint`` (JSON as 0-d numpy
  strings);
* ``digest``: sha256 over the canonical payload (sorted keys, each as
  key, ``str(dtype)``, ``str(shape)`` and raw bytes), verified on load.

The reference keeps its JAX PRNG key under ``learner_rng``; the port
keeps its ``torch.Generator``'s state under ``torch_generator`` instead.
Each package ignores the other's key, so a resume across packages draws
its own seeds.

On a ``model`` mesh axis each rank stores a coordinate block of the
flat state: a save joins the blocks over the model group (the file holds
the reference's padded vector; rank 0 writes it) and a load keeps each
rank's block. Offloaded dense rows are joined alike (a model rank's
arenas hold its block of each row), over both axes. On a ``seq`` axis
the state is replicated and written once. Buffered slots are never
saved: a resume starts with an empty buffer.

Writes are atomic (a temp file, fsync, ``os.replace``, then the
directory's fsync). Periodic saves land as ``{name}_r{step:08d}.npz``
behind a ``{name}.latest`` pointer, the newest ``KEEP_STEP_FILES``
retained (the plain ``{name}.npz`` export is never pruned). With
``COMMEFF_CRASH_POINT ckpt_before_replace`` set, the
``COMMEFF_CRASH_AT_SAVE``-th save (1 by default) SIGKILLs the process
between the fsync and the rename.

``load_checkpoint`` is transactional: every check (digest, leaf paths,
shapes, offloaded rows, fingerprint) passes before the learner changes.

On a mesh (a learner with ``mesh``) the ranks join their row blocks and
arena shards in row order and rank 0 writes the one file, in the format
a one-process run writes, so it loads on any number of ranks, in one
process, and in the JAX package; a load gives each rank its own block.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import signal

import numpy as np
import torch

from commefficient_tpu_torch.federated.round import FedState, split_leaves
from commefficient_tpu_torch.federated.state import (CLIENT_STATE_FIELDS,
                                                     ClientState,
                                                     ServerOptState)
from commefficient_tpu_torch.parallel import distributed
from commefficient_tpu_torch.parallel import mesh as mesh_lib

FORMAT_VERSION = 3

_STEP_RE = re.compile(r"^(?P<name>.+)_r(?P<step>\d{8})\.npz$")

_DIGEST_KEY = "digest"

#: the step checkpoints a save leaves on disk, newest first
KEEP_STEP_FILES = 3

#: the port's own key: the learner's ``torch.Generator`` state (uint8)
GENERATOR_KEY = "torch_generator"

#: saves that reached the crash point so far (the crash-injection hook)
_crash_hits = 0


class CheckpointError(ValueError):
    """A checkpoint file is unreadable, truncated, or fails its digest."""


def _crash_point(tag: str) -> None:
    global _crash_hits
    if os.environ.get("COMMEFF_CRASH_POINT") != tag:
        return
    _crash_hits += 1
    if _crash_hits >= int(os.environ.get("COMMEFF_CRASH_AT_SAVE", "1")):
        os.kill(os.getpid(), signal.SIGKILL)


def _payload_digest(payload: dict) -> str:
    """sha256 over the canonical serialization: sorted keys, each hashed as
    key + dtype + shape + raw bytes (what ``np.load`` gives back)."""
    h = hashlib.sha256()
    for k in sorted(payload):
        if k == _DIGEST_KEY:
            continue
        a = np.ascontiguousarray(payload[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _atomic_savez(fn: str, payload: dict) -> None:
    """Write ``payload`` to ``fn`` so that a reader sees the old file or
    the new one, never a mix."""
    tmp = fn + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    _crash_point("ckpt_before_replace")
    os.replace(tmp, fn)
    # the rename itself survives a power loss once the directory is synced
    try:
        dfd = os.open(os.path.dirname(fn) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _atomic_write_text(fn: str, text: str) -> None:
    tmp = fn + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fn)


def state_leaves(state: FedState):
    """``[(path, tensor, is_client_rows)]`` in the JAX ``FedState``'s leaf
    order and key paths, without the buffer."""
    out = [(".weights", state.weights, False),
           (".opt.Vvelocity", state.opt.Vvelocity, False),
           (".opt.Verror", state.opt.Verror, False)]
    for field in CLIENT_STATE_FIELDS:
        rows = getattr(state.clients, field)
        if isinstance(rows, dict):
            out += [(f".clients.{field}['{k}']", rows[k], True)
                    for k in sorted(rows)]
        elif rows is not None:
            out.append((f".clients.{field}", rows, True))
    out += [(f".{name}", getattr(state, name), False)
            for name in ("round_idx", "last_changed", "client_last_round",
                         "aborted", "weights_version", "quarantine")]
    return out


def _with_leaves(state: FedState, new: dict) -> FedState:
    """``state`` with the leaves of ``new`` (path -> tensor) put in."""
    def rows(field):
        cur = getattr(state.clients, field)
        if isinstance(cur, dict):
            return {k: new[f".clients.{field}['{k}']"] for k in cur}
        return None if cur is None else new[f".clients.{field}"]
    return FedState(
        weights=new[".weights"],
        opt=ServerOptState(Vvelocity=new[".opt.Vvelocity"],
                           Verror=new[".opt.Verror"]),
        clients=ClientState(*(rows(f) for f in CLIENT_STATE_FIELDS)),
        round_idx=new[".round_idx"], last_changed=new[".last_changed"],
        client_last_round=new[".client_last_round"],
        aborted=new[".aborted"], weights_version=new[".weights_version"],
        quarantine=new[".quarantine"], buffer=state.buffer)


def _mesh_of(learner):
    return getattr(learner, "mesh", None)


def _num_clients(learner) -> int:
    return int(learner.state.client_last_round.shape[0])


def _full_rows(t: torch.Tensor, learner) -> torch.Tensor:
    """A held block of client rows (its sink dropped) as every client's,
    the ranks' blocks joined in row order on a mesh."""
    mesh = _mesh_of(learner)
    return t if mesh is None else mesh_lib.all_gather_cat(t, mesh)


def _held_rows(arr: np.ndarray, learner) -> np.ndarray:
    """Every client's rows -> the block this process holds."""
    mesh = _mesh_of(learner)
    if mesh is None:
        return arr
    lo, hi = mesh_lib.row_block(_num_clients(learner), mesh)
    return arr[lo:hi]


def _coord_dim(path: str, learner):
    """The dim along which a model-axis rank stores only its coordinate
    block of the leaf at ``path`` (``api.FedLearner``), or None: the
    weights and ``last_changed``, a dense mode's server state, the dense
    codec's client rows."""
    if mesh_lib.model_size(_mesh_of(learner)) == 1:
        return None
    opt, rows = split_leaves(learner.cfg)
    if path in (".weights", ".last_changed"):
        return 0
    if path.startswith(".opt.") and opt:
        return 0
    if path.startswith(".clients.") and rows:
        return 1
    return None


def _whole(t: torch.Tensor, path: str, learner) -> torch.Tensor:
    """A leaf as the file holds it: a coordinate block joined over the
    model axis (the reference's padded vector)."""
    dim = _coord_dim(path, learner)
    if dim is None:
        return t
    return mesh_lib.model_all_gather(t, _mesh_of(learner), dim=dim)


def _held_coords(arr: np.ndarray, path: str, learner) -> np.ndarray:
    """A whole leaf -> the coordinate block this rank stores."""
    dim = _coord_dim(path, learner)
    if dim is None:
        return arr
    lo, hi = learner.coord_block
    return arr[(slice(None),) * dim + (slice(lo, hi),)]


def _host_fields(learner):
    """``[(field, key -> leaf name or None)]`` of the offloaded rows."""
    store = getattr(learner, "host_store", None)
    if store is None:
        return []
    out = []
    for field in CLIENT_STATE_FIELDS:
        if store.view(field) is None:
            continue
        proto = store.arena(field)
        keys = ({f"host_{field}__{k}": k for k in sorted(proto)}
                if isinstance(proto, dict) else {f"host_{field}": None})
        out.append((field, keys))
    return out


def save_checkpoint(path: str, learner, name: str = "model",
                    meta: dict = None, *, step: int = None,
                    cursor: dict = None, fingerprint: dict = None) -> str:
    """Write ``learner``'s checkpoint under ``path`` and return its file.

    ``meta``: an optional JSON model description (model, num_classes, ...)
    for a finetune's head swap. With ``step`` the file is
    ``{name}_r{step:08d}.npz``, ``{name}.latest`` points at it and only
    the newest ``KEEP_STEP_FILES`` step files stay; without, it is ``{name}.npz``.
    ``cursor`` and ``fingerprint`` are stored as JSON
    (``training/preempt.py``)."""
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(
        path, f"{name}.npz" if step is None else f"{name}_r{step:08d}.npz")
    # the offloaded rows must be current in the arenas
    learner.flush_offload()
    leaves = state_leaves(learner.state)
    paths = [p for p, _, _ in leaves]
    extra = {"meta": np.asarray(json.dumps(meta))} if meta else {}
    if cursor is not None:
        extra["cursor"] = np.asarray(json.dumps(cursor))
    if fingerprint is not None:
        extra["fingerprint"] = np.asarray(json.dumps(fingerprint))
    generator = getattr(learner, "generator", None)
    if generator is not None:
        extra[GENERATOR_KEY] = generator.get_state().numpy()
    for field, keys in _host_fields(learner):
        stacked = learner.host_store.stacked(field)
        for key, leaf in keys.items():
            rows = _full_rows(stacked if leaf is None else stacked[leaf],
                              learner)
            if learner.host_store.coord_block is not None:
                # a model rank's arenas hold its block of each dense row
                rows = mesh_lib.model_all_gather(rows, _mesh_of(learner),
                                                 dim=1)
            extra[key] = rows.numpy()
    arrays = {}
    for i, (p, t, rows) in enumerate(leaves):
        # the client rows' sink row is the port's, not the format's
        t = _whole(t, p, learner)
        arrays[f"arr_{i}"] = (_full_rows(t[:-1], learner) if rows
                              else t).detach().cpu().numpy()
    mesh = _mesh_of(learner)
    if mesh is not None and distributed.rank() != 0:
        # rank 0 writes the file; every rank returns once it is there
        mesh_lib.barrier(mesh)
        return fn
    payload = dict(rounds_done=np.asarray(learner.rounds_done),
                   total_download_bytes=np.asarray(
                       learner.total_download_bytes),
                   total_upload_bytes=np.asarray(learner.total_upload_bytes),
                   weights_idx=np.asarray(paths.index(".weights")),
                   format_version=np.asarray(FORMAT_VERSION),
                   leaf_paths=np.asarray(json.dumps(paths)), **extra,
                   **arrays)
    payload[_DIGEST_KEY] = np.asarray(_payload_digest(payload))
    _atomic_savez(fn, payload)
    if step is not None:
        _atomic_write_text(os.path.join(path, f"{name}.latest"),
                           os.path.basename(fn))
        _prune_step_files(path, name)
    if mesh is not None:
        mesh_lib.barrier(mesh)
    return fn


def _step_files(path: str, name: str = None):
    """(step, filename) of the step checkpoints in ``path``, newest first;
    ``name=None`` matches any prefix."""
    out = []
    try:
        entries = os.listdir(path)
    except OSError:
        return out
    for e in entries:
        m = _STEP_RE.match(e)
        if m and (name is None or m.group("name") == name):
            out.append((int(m.group("step")), e))
    out.sort(reverse=True)
    return out


def _prune_step_files(path: str, name: str) -> None:
    for _, e in _step_files(path, name)[KEEP_STEP_FILES:]:
        try:
            os.remove(os.path.join(path, e))
        except OSError:
            pass


def verify_checkpoint(fn: str) -> dict:
    """Read and check ``fn`` without touching a learner: the payload as
    ``{key: ndarray}``. Raises ``CheckpointError`` on an unreadable or
    truncated file or a digest mismatch; a pre-v3 file has no digest and
    passes if it reads."""
    try:
        with np.load(fn, allow_pickle=False) as z:
            payload = {k: z[k] for k in z.files}
    except Exception as e:  # zipfile and numpy raise many types here
        raise CheckpointError(f"checkpoint {fn} is unreadable: {e}") from e
    if _DIGEST_KEY in payload:
        want = str(payload[_DIGEST_KEY])
        got = _payload_digest(payload)
        if want != got:
            raise CheckpointError(
                f"checkpoint {fn} fails digest verification "
                f"(stored {want[:12]}…, computed {got[:12]}…) — torn or "
                f"corrupted write")
    return payload


def find_latest_checkpoint(path: str, name: str = None):
    """The newest valid checkpoint file under ``path``, or None: the
    ``.latest`` pointer, then the step files newest first (past a corrupt
    newest), then the plain ``{name}.npz``, each digest-verified."""
    candidates = []
    try:
        entries = sorted(os.listdir(path))
    except OSError:
        return None
    for e in entries:
        if e.endswith(".latest") and (name is None or
                                      e == f"{name}.latest"):
            try:
                with open(os.path.join(path, e)) as f:
                    candidates.append(f.read().strip())
            except OSError:
                pass
    candidates += [e for _, e in _step_files(path, name)]
    candidates += [e for e in entries
                   if e.endswith(".npz") and not _STEP_RE.match(e)
                   and (name is None or e == f"{name}.npz")]
    seen = set()
    for e in candidates:
        if not e or e in seen:
            continue
        seen.add(e)
        fn = os.path.join(path, e)
        if not os.path.isfile(fn):
            continue
        try:
            verify_checkpoint(fn)
        except CheckpointError:
            continue
        return fn
    return None


#: leaves an older checkpoint may lack, and their value (from the
#: learner's current leaf)
_BACKFILL = {
    ".aborted": lambda cur: np.zeros((), bool),
    ".weights_version": lambda cur: np.zeros((), np.int32),
    ".quarantine": lambda cur: np.zeros(tuple(cur.shape), np.int32),
}


def load_checkpoint(fn: str, learner, expect_fingerprint: dict = None):
    """Restore ``learner`` (built with the same config) from ``fn`` in
    place, every tensor on the learner's device in its dtype. Returns
    ``{"cursor", "meta", "fingerprint", "rounds_done"}`` (JSON parsed;
    None when absent). Nothing changes unless every check passes."""
    # a pending writeback landing after the restore would bring back
    # rows from before it
    learner.flush_offload()
    z = verify_checkpoint(fn)
    leaves = state_leaves(learner.state)
    if "leaf_paths" in z:
        saved_paths = json.loads(str(z["leaf_paths"]))
        by_path = {p: z[f"arr_{i}"] for i, p in enumerate(saved_paths)}
        unknown = set(saved_paths) - {p for p, _, _ in leaves}
        if unknown:
            raise ValueError(
                f"checkpoint {fn} has state leaves {sorted(unknown)} the "
                f"learner doesn't — config/mode mismatch")
        restored = []
        for p, cur, _ in leaves:
            if p in by_path:
                restored.append(by_path[p])
            elif p in _BACKFILL:
                restored.append(_BACKFILL[p](cur))
            else:
                raise ValueError(
                    f"checkpoint {fn} is missing state leaf {p!r} — "
                    f"config/mode mismatch")
    else:
        # v1 (no leaf list): positional
        n_saved = sum(1 for k in z if k.startswith("arr_"))
        restored = [z[f"arr_{i}"] for i in range(n_saved)]
        if n_saved != len(leaves):
            raise ValueError(
                f"checkpoint {fn} has {n_saved} state arrays, learner "
                f"expects {len(leaves)} — config/mode mismatch")
    for (p, cur, rows), new in zip(leaves, restored):
        shape = list(cur.shape)
        dim = _coord_dim(p, learner)
        if dim is not None:
            shape[dim] = learner.cfg.grad_dim
        want = ((_num_clients(learner),) if rows else ()) + tuple(
            shape[1 if rows else 0:])
        if tuple(new.shape) != want:
            raise ValueError(
                f"checkpoint {fn} array {p} has shape {new.shape}, learner "
                f"expects {want} — model/config mismatch")
    host_pending = []
    for field, keys in _host_fields(learner):
        store = learner.host_store
        proto = store.arena(field)
        tree = {}
        for key, leaf in keys.items():
            if key not in z:
                raise ValueError(
                    f"checkpoint {fn} is missing offloaded client "
                    f"rows {key!r} — it was saved without "
                    f"client_state_offload or with a different "
                    f"--client_state representation (config mismatch)")
            row = proto if leaf is None else proto[leaf]
            want = (store.num_rows,) + tuple(row.shape[1:])
            if store.coord_block is not None:
                want = (store.num_rows, learner.cfg.grad_dim)
            if tuple(z[key].shape) != want:
                raise ValueError(
                    f"checkpoint {fn} {key} has shape {z[key].shape}, "
                    f"learner expects {want} — config mismatch")
            tree[leaf] = z[key]
        host_pending.append((field, tree[None] if None in tree else tree))
    fingerprint = (json.loads(str(z["fingerprint"]))
                   if "fingerprint" in z else None)
    if expect_fingerprint is not None and fingerprint is not None:
        bad = sorted(k for k in set(fingerprint) | set(expect_fingerprint)
                     if fingerprint.get(k) != expect_fingerprint.get(k))
        if bad:
            detail = ", ".join(
                f"{k}: checkpoint={fingerprint.get(k)!r} "
                f"run={expect_fingerprint.get(k)!r}" for k in bad)
            raise ValueError(
                f"checkpoint {fn} was written by a run with a different "
                f"config — resuming would silently change the trajectory. "
                f"Mismatched: {detail}")
    generator = getattr(learner, "generator", None)
    gen_state = (torch.from_numpy(z[GENERATOR_KEY].copy())
                 if generator is not None and GENERATOR_KEY in z else None)
    # ---- every check passed: mutate ------------------------------------
    new = {}
    for (p, cur, rows), arr in zip(leaves, restored):
        arr = _held_coords(arr, p, learner)
        if rows:
            arr = _held_rows(arr, learner)
        t = torch.from_numpy(np.array(arr)).to(dtype=cur.dtype)
        if rows:
            t = torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
        new[p] = t.to(cur.device)
    learner.state = _with_leaves(learner.state, new)
    for field, tree in host_pending:
        learner.host_store.assign(field, tree)
    learner.rounds_done = int(z["rounds_done"])
    learner.total_download_bytes = float(z["total_download_bytes"])
    learner.total_upload_bytes = float(z["total_upload_bytes"])
    if gen_state is not None:
        generator.set_state(gen_state)
    return {"cursor": json.loads(str(z["cursor"])) if "cursor" in z
            else None,
            "meta": json.loads(str(z["meta"])) if "meta" in z else None,
            "fingerprint": fingerprint,
            "rounds_done": int(z["rounds_done"])}
