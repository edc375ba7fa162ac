"""Per-client transmit budgets of ``--client_k_dist`` (port of the draws in
``commefficient_tpu/federated/faults.py``).

Every draw is a pure function of (seed, round, client, tag): a keyed
numpy Philox counter, no shared stream, so a cohort's budgets do not
depend on the order the host asks for them and replay bitwise across
packages. The fault model's straggler and fate draws (tags 1 and 2 of
the same scheme) belong to the buffered server (ROADMAP.md A10).
"""

from __future__ import annotations

import numpy as np

# stream tag of the client-capacity draw; the fault model's are 1 and 2
_TAG_K = 3


def _keyed_gen(seed: int, tag: int, round_idx: int, client: int):
    """Order-independent keyed Philox stream: the counter is the (round,
    client, tag) coordinates, so a draw is a pure function of its key."""
    bg = np.random.Philox(
        counter=[0, int(round_idx), int(client), int(tag)],
        key=[int(seed) & 0xFFFFFFFFFFFFFFFF, 0])
    return np.random.Generator(bg)


def parse_k_dist(spec: str):
    """Parse a ``--client_k_dist`` spec into ``(lo, hi)`` k-fractions.

    Format: ``uniform:lo,hi`` with ``0 < lo <= hi <= 1``: each client's
    budget k_i is a per-client Uniform[lo, hi] fraction of the
    provisioned k; the client keeps the first k_i slots of its top-k
    selection and the rest stays in its error-feedback row. Raises
    ValueError on a malformed spec."""
    try:
        kind, _, rest = spec.partition(":")
        if kind != "uniform":
            raise ValueError(f"unknown client_k_dist family {kind!r} "
                             f"(supported: 'uniform')")
        lo_s, hi_s = rest.split(",")
        lo, hi = float(lo_s), float(hi_s)
    except ValueError as e:
        if "client_k_dist" in str(e):
            raise
        raise ValueError(
            f"client_k_dist must look like 'uniform:lo,hi' (fractions of "
            f"k), got {spec!r}") from None
    if not (0.0 < lo <= hi <= 1.0):
        raise ValueError(f"client_k_dist fractions need 0 < lo <= hi <= 1, "
                         f"got lo={lo}, hi={hi}")
    return lo, hi


def client_k_for(seed: int, client: int, k: int, spec: str) -> int:
    """One client's budget k_i: a chronic property of the client (round
    pinned to 0), the same every round."""
    lo, hi = parse_k_dist(spec)
    u = _keyed_gen(seed, _TAG_K, 0, client).random()
    return max(1, int(round((lo + (hi - lo) * u) * k)))


def cohort_client_ks(seed: int, ids, k: int, spec: str,
                     memo: dict = None) -> np.ndarray:
    """The (W,) int32 budgets of one sampled cohort, one draw per client
    (memoized in ``memo`` when given)."""
    ids = np.asarray(ids)
    out = np.empty(ids.shape[0], np.int32)
    for w, cid in enumerate(ids):
        c = int(cid)
        if memo is not None and c in memo:
            out[w] = memo[c]
            continue
        ki = client_k_for(seed, c, k, spec)
        if memo is not None:
            memo[c] = ki
        out[w] = ki
    return out
