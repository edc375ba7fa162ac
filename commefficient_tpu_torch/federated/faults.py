"""The seeded client fault model and the per-client transmit budgets of
``--client_k_dist`` (port of ``commefficient_tpu/federated/faults.py``).

Every draw is a pure function of (seed, round, client, tag): a keyed
numpy Philox counter, no shared stream, so a schedule does not depend on
the order the host asks for it and replays bitwise across packages and
across a resume.

Per (cohort, client), ``FaultModel.fate`` draws:

* dropout (``dropout_prob``): the client never starts; the sync server
  waits ``sync_timeout`` for it, the buffered server never sees it;
* crash (``crash_prob``, given a start): the client pulls the weights
  and computes, but its contribution never arrives;
* latency: log-normal around ``base_latency`` with spread
  ``latency_sigma``, times ``straggler_mult`` for the chronic
  stragglers, a ``straggler_frac`` of the clients drawn once per client
  (round 0 of tag 1), lazily and memoized, so a cohort costs O(W) draws.

Latency is in simulated units (one unit = one base round trip).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# stream tags: independent Philox keys per purpose, so a new draw never
# shifts an existing one
_TAG_STRAGGLER = 1
_TAG_FATE = 2
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


@dataclass(frozen=True)
class ClientFate:
    """One client's behavior in one cohort."""
    started: bool    # pulled weights and began computing
    arrives: bool    # contribution reaches the server
    latency: float   # dispatch -> arrival, simulated units (inf if lost)


class FaultModel:
    """Seeded generator of per-(cohort, client) fates. ``round_idx`` is
    the cohort index the caller dispatches (monotone), not the server's
    ``round_idx``, which freezes on an abort."""

    def __init__(self, seed: int, num_clients: int, *,
                 base_latency: float = 1.0, latency_sigma: float = 0.25,
                 straggler_frac: float = 0.0, straggler_mult: float = 10.0,
                 dropout_prob: float = 0.0, crash_prob: float = 0.0,
                 sync_timeout: float = None):
        if not 0 <= dropout_prob < 1 or not 0 <= crash_prob < 1:
            raise ValueError("dropout_prob / crash_prob must be in [0, 1)")
        if base_latency <= 0 or straggler_mult < 1:
            raise ValueError("base_latency must be > 0 and "
                             "straggler_mult >= 1")
        self.seed = int(seed)
        self.num_clients = int(num_clients)
        self.base_latency = float(base_latency)
        self.latency_sigma = float(latency_sigma)
        self.straggler_frac = float(straggler_frac)
        self.straggler_mult = float(straggler_mult)
        self.dropout_prob = float(dropout_prob)
        self.crash_prob = float(crash_prob)
        # the sync server waits for the slowest legitimate client before
        # it can tell a dropout from a straggler
        self.sync_timeout = (float(sync_timeout) if sync_timeout is not None
                             else self.base_latency * self.straggler_mult)
        self._straggler_memo = {}
        # per-(cohort, client) fate draws so far: at most cohorts * W
        self.fate_draws = 0

    def _is_straggler(self, client: int) -> bool:
        c = int(client) % self.num_clients
        hit = self._straggler_memo.get(c)
        if hit is None:
            hit = self._straggler_memo[c] = bool(
                self._gen(_TAG_STRAGGLER, 0, c).random()
                < self.straggler_frac)
        return hit

    @property
    def straggler(self) -> np.ndarray:
        """The (num_clients,) chronic-straggler mask (draws every client:
        for tests and analysis)."""
        return np.array([self._is_straggler(c)
                         for c in range(self.num_clients)])

    def _gen(self, tag: int, round_idx: int, client: int):
        return _keyed_gen(self.seed, tag, round_idx, client)

    def fate(self, round_idx: int, client: int) -> ClientFate:
        self.fate_draws += 1
        g = self._gen(_TAG_FATE, round_idx, client)
        # the draw order within the stream is part of the replay contract
        u_drop, u_crash = g.random(), g.random()
        lat = g.lognormal(mean=np.log(self.base_latency),
                          sigma=self.latency_sigma)
        if self._is_straggler(client):
            lat *= self.straggler_mult
        if u_drop < self.dropout_prob:
            return ClientFate(False, False, np.inf)
        if u_crash < self.crash_prob:
            return ClientFate(True, False, np.inf)
        return ClientFate(True, True, float(lat))

    def cohort_fates(self, round_idx: int, ids, valid=None):
        """(started, arrives, latency), each (W,), for one cohort; padded
        slots (``valid`` False) get no fate."""
        ids = np.asarray(ids)
        W = ids.shape[0]
        valid = (np.ones(W, bool) if valid is None
                 else np.asarray(valid, bool))
        started = np.zeros(W, bool)
        arrives = np.zeros(W, bool)
        latency = np.full(W, np.inf)
        for w in range(W):
            if not valid[w]:
                continue
            f = self.fate(round_idx, int(ids[w]))
            started[w], arrives[w], latency[w] = (f.started, f.arrives,
                                                  f.latency)
        return started, arrives, latency

    def sync_round(self, round_idx: int, ids, valid=None):
        """The sync server's view of a cohort: (present (W,), started
        (W,), round_time), the barrier being the slowest arrival, or
        ``sync_timeout`` when an expected client never reports."""
        started, arrives, latency = self.cohort_fates(round_idx, ids, valid)
        valid = (np.ones(len(np.asarray(ids)), bool) if valid is None
                 else np.asarray(valid, bool))
        present = arrives & valid
        t = float(latency[present].max()) if present.any() else 0.0
        if (valid & ~arrives).any():
            t = max(t, self.sync_timeout)
        return present, started, t
