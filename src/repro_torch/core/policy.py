"""In-data-plane L7 policy engine — a vectorized policy table fused into
the batched metadata pass.

Libra's bet is that proxies only need small *metadata* in user space while
the bulk payload stays below the boundary. This module pushes the routing
decision itself below the boundary too (the "Offloading L7 Policies to the
Kernel" / XLB direction): a :class:`PolicyTable` is an ordered list of
rules — header-prefix / byte-range matchers over the metadata tokens →
an action — that **compiles to dense int32 arrays** and is evaluated for a
whole batched round as ONE vectorized first-match pass
(:func:`repro_torch.kernels.ops.policy_match`: the plain PyTorch version
or the CUDA kernel — plus an int64-exact numpy path for the host
datapath). Matched messages are admitted, matched, and queued for
``forward_batch`` to their verdict backend without the per-channel Python
routing callbacks ever running; Python becomes the slow-path exception
handler (``PUNT``).

Match semantics (the contract shared by the kernel, the jnp oracle, the
numpy fast path, and :meth:`PolicyTable.interpret` — the naive Python
interpreter the property tests compare against):

* a condition ``(offset, lo, hi)`` with ``offset >= 0`` holds iff
  ``offset < meta_len`` and ``lo <= meta[offset] <= hi`` (padding slots,
  ``offset == -1``, always hold);
* a *payload-prefix* condition — ``offset <= -2``, encoding position
  ``-offset - 2`` of the message's **first anchored page** (built with
  :func:`payload_at` / :func:`payload_prefix`) — holds iff that position
  is inside both the page window and the payload and the *plaintext*
  payload token is in ``[lo, hi]``. The fused device round evaluates it
  directly against the page tokens it is anchoring (still in registers);
  the host paths peek the first page window;
* a rule matches iff all its conditions hold;
* the verdict row is the FIRST matching rule (rule order is priority);
  ``R`` (the row count) is the no-match sentinel.

Action semantics (resolved host-side from the matched row — the stateful
O(B) part; matching is the O(B·R·K) data-plane part):

* ``FORWARD(backend_k)`` — route to the channel's ``dsts[k]``.
* ``REWRITE(slot, value, backend)`` — patch metadata token ``slot`` then
  forward. A slot outside the metadata PUNTs (``rewrite-overflow``); a
  rewrite on an encrypted record PUNTs too (``rewrite-crypto``: patching
  sealed metadata would break the record's auth tag).
* ``RATE_LIMIT(rate, burst, backend, per)`` — token bucket (``rate``
  tokens/tick refill, ``burst`` capacity, milli-token granularity so the
  dense encoding round-trips), keyed per rule or — ``per=offset`` — per
  tenant token ``meta[offset]``. A debit forwards; an empty bucket PUNTs
  (``rate-limited``) so Python decides what an over-limit flow deserves.
* ``DROP`` — consume the message and free its anchored pages
  (:meth:`LibraStack.drop_message`), nothing transmitted.
* ``PUNT`` — explicit slow-path escape.

``PUNT`` verdicts (no match, rewrite overflow, rate-limited, malformed
header, unknown backend) always fall back to the channel's existing
``rewrite``/``router`` callback path; per-verdict counters live in
:class:`~repro_torch.core.stream.CopyCounters` (``policy_hits`` /
``policy_punts`` / ``policy_drops`` / ``policy_rate_debits`` — event
counters, excluded from the Fig. 9 copy-identity snapshot, summed by
``LibraCluster.counters_aggregate``) and in :attr:`PolicyTable.stats`.

:class:`PythonPolicyRouter` is the contrast baseline: the SAME table
evaluated message-by-message by the naive interpreter, exposed through the
classic per-channel callback slots — what the offload bypasses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sync import ClusterLock

#: action kinds (dense ``act_kind`` encoding, stable across compile/decode)
ACT_FORWARD, ACT_REWRITE, ACT_RATE_LIMIT, ACT_DROP, ACT_PUNT = range(5)

#: milli-token fixed point for rates/bursts in the dense int32 encoding
_MILLI = 1000

#: PUNT reasons (Verdict.reason / stats keys)
PUNT_NO_MATCH = "no-match"
PUNT_RULE = "rule-punt"
PUNT_RATE_LIMITED = "rate-limited"
PUNT_REWRITE_OVERFLOW = "rewrite-overflow"
PUNT_REWRITE_CRYPTO = "rewrite-crypto"
PUNT_MALFORMED = "malformed"
PUNT_BAD_BACKEND = "bad-backend"
PUNT_UNHEALTHY = "unhealthy"

#: HealthTable backend states
HEALTHY, UNHEALTHY, HALF_OPEN = range(3)

#: condition-offset encoding shared with the device plane
#: (repro_torch.kernels.selective_copy.PAD_COND / PAYLOAD_COND_BASE): ``-1`` is
#: the dense-array padding slot; ``offset <= -2`` encodes first-anchored-
#: page position ``-offset - 2``
PAD_COND = -1
PAYLOAD_COND_BASE = -2


class HealthTable:
    """Per-backend health consulted by the match pass as a dense column.

    Classic circuit-breaker shape on the channel's backend index space
    (``dsts[k]``): ``fail_threshold`` *consecutive* failures trip a backend
    to UNHEALTHY; after ``probe_after`` ticks it goes HALF_OPEN (traffic
    allowed again — the probe); the first success closes the circuit
    (HEALTHY), the first failure re-trips it. All transitions are driven by
    the deterministic stack tick, never the wall clock.

    The data-plane view is :meth:`column` — ``[n_backends]`` int32, 1 where
    traffic may flow (HEALTHY or HALF_OPEN) — which
    :meth:`PolicyTable.rule_live` folds into the per-rule live mask the
    vectorized match consumes. Backend indices outside the table are
    treated as healthy (unknown backends are the PUNT path's problem, not
    the breaker's)."""

    def __init__(self, n_backends: int, *, fail_threshold: int = 3,
                 probe_after: int = 8):
        assert n_backends >= 1 and fail_threshold >= 1 and probe_after >= 1
        self.n_backends = n_backends
        self.fail_threshold = fail_threshold
        self.probe_after = probe_after
        self.state = np.zeros(n_backends, np.int32)       # HEALTHY
        self.fails = np.zeros(n_backends, np.int64)       # consecutive
        self.probe_at = np.full(n_backends, -1, np.int64)
        self.stats = {"trips": 0, "recoveries": 0, "probes": 0,
                      "failures": 0, "successes": 0}
        # one HealthTable is shared by every worker's PolicyTable clone
        # (PolicyTable.clone keeps the health reference): self-locking,
        # per the repro_torch.core.sync discipline
        self.lock = ClusterLock("health")

    def _in_range(self, k: int) -> bool:
        return 0 <= k < self.n_backends

    def healthy(self, k: int) -> bool:
        """May traffic flow to backend ``k``? (HEALTHY or HALF_OPEN.)"""
        return not self._in_range(k) or int(self.state[k]) != UNHEALTHY

    def column(self) -> np.ndarray:
        """Dense [n_backends] int32 health column (1 = traffic allowed)."""
        return (self.state != UNHEALTHY).astype(np.int32)

    def note_failure(self, k: int, now: int) -> None:
        """One failed send to ``k`` at tick ``now``. HALF_OPEN re-trips
        immediately; HEALTHY trips at ``fail_threshold`` consecutive."""
        if not self._in_range(k):
            return
        with self.lock:
            self.stats["failures"] += 1
            self.fails[k] += 1
            st = int(self.state[k])
            if st == UNHEALTHY:
                return
            if st == HALF_OPEN or self.fails[k] >= self.fail_threshold:
                self.state[k] = UNHEALTHY
                self.probe_at[k] = now + self.probe_after
                self.stats["trips"] += 1

    def note_success(self, k: int) -> None:
        """One completed send to ``k`` — closes the circuit."""
        if not self._in_range(k):
            return
        with self.lock:
            self.stats["successes"] += 1
            self.fails[k] = 0
            if int(self.state[k]) != HEALTHY:
                self.state[k] = HEALTHY
                self.probe_at[k] = -1
                self.stats["recoveries"] += 1

    def tick(self, now: int) -> None:
        """Advance probe deadlines: UNHEALTHY backends whose deadline
        passed go HALF_OPEN (one probe's worth of traffic re-admitted)."""
        with self.lock:
            due = (self.state == UNHEALTHY) & (self.probe_at >= 0) \
                & (self.probe_at <= now)
            n = int(due.sum())
            if n:
                self.state[due] = HALF_OPEN
                self.probe_at[due] = -1
                self.stats["probes"] += n

    def mark_down(self, k: int, now: int = 0) -> None:
        """Administratively trip ``k`` (fault injection / known-dead)."""
        if not self._in_range(k):
            return
        with self.lock:
            self.state[k] = UNHEALTHY
            self.fails[k] = max(int(self.fails[k]), self.fail_threshold)
            self.probe_at[k] = now + self.probe_after
            self.stats["trips"] += 1

    def mark_up(self, k: int) -> None:
        """Administratively close ``k``'s circuit."""
        self.note_success(k)

    def summary(self) -> Dict[str, object]:
        out = dict(self.stats)
        out["state"] = self.state.tolist()
        return out


@dataclasses.dataclass(frozen=True)
class MatchCond:
    """``lo <= meta[offset] <= hi`` (and ``offset < meta_len``) for
    ``offset >= 0``; ``offset <= -2`` matches first-anchored-page position
    ``-offset - 2`` instead (see :func:`payload_at`)."""
    offset: int
    lo: int
    hi: int

    def __post_init__(self):
        assert self.offset != PAD_COND, \
            "-1 is the dense padding slot, not a condition offset"
        assert self.lo <= self.hi, (self.lo, self.hi)

    @property
    def payload_pos(self) -> int:
        """Payload position for a payload-prefix condition, ``-1`` for a
        metadata condition."""
        return PAYLOAD_COND_BASE - self.offset if self.offset < 0 else -1


def eq(offset: int, value: int) -> MatchCond:
    """Equality matcher on one metadata token."""
    return MatchCond(offset, value, value)


def between(offset: int, lo: int, hi: int) -> MatchCond:
    """Inclusive byte-range matcher on one metadata token."""
    return MatchCond(offset, lo, hi)


def prefix(*values: int) -> Tuple[MatchCond, ...]:
    """Header-prefix matcher: tokens 0..n-1 must equal ``values``."""
    return tuple(eq(i, v) for i, v in enumerate(values))


def payload_at(pos: int, lo: int, hi: int) -> MatchCond:
    """Inclusive byte-range matcher on *payload* position ``pos`` of the
    message's first anchored page (plaintext). Only positions inside the
    first page can match — the window the data plane has in registers."""
    assert pos >= 0, pos
    return MatchCond(PAYLOAD_COND_BASE - pos, lo, hi)


def payload_prefix(*values: int) -> Tuple[MatchCond, ...]:
    """Payload-prefix matcher: payload tokens 0..n-1 must equal
    ``values`` (the L7 'first bytes of the body' classifier)."""
    return tuple(payload_at(i, v, v) for i, v in enumerate(values))


@dataclasses.dataclass(frozen=True)
class Action:
    kind: int
    backend: int = 0          # FORWARD / REWRITE / RATE_LIMIT target
    slot: int = 0             # REWRITE metadata position
    value: int = 0            # REWRITE replacement token
    rate_millis: int = 0      # RATE_LIMIT refill (milli-tokens / tick)
    burst_millis: int = 0     # RATE_LIMIT bucket capacity (milli-tokens)
    key_offset: int = -1      # RATE_LIMIT bucket key meta[offset]; -1 = rule
    failover: int = -1        # FORWARD fallback backend when primary is down


def forward(backend: int = 0, failover: int = -1) -> Action:
    """Route to ``backend``; if a :class:`HealthTable` says it is down,
    re-verdict in-plane to ``failover`` (``-1`` = none: the rule goes
    non-live instead and the match falls through to later rules)."""
    return Action(ACT_FORWARD, backend=backend, failover=failover)


def rewrite(slot: int, value: int, backend: int = 0) -> Action:
    return Action(ACT_REWRITE, backend=backend, slot=slot, value=value)


def rate_limit(rate: float, burst: float = 1.0, *, backend: int = 0,
               per: int = -1) -> Action:
    """``rate`` tokens/tick refill, ``burst`` capacity (both rounded to
    milli-tokens); ``per`` keys the bucket on ``meta[per]`` (per-tenant)."""
    return Action(ACT_RATE_LIMIT, backend=backend,
                  rate_millis=int(round(rate * _MILLI)),
                  burst_millis=int(round(burst * _MILLI)), key_offset=per)


def drop() -> Action:
    return Action(ACT_DROP)


def punt() -> Action:
    return Action(ACT_PUNT)


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    conds: Tuple[MatchCond, ...]
    action: Action
    name: str = dataclasses.field(default="", compare=False)


def rule(action: Action, *conds, name: str = "") -> PolicyRule:
    """Build a rule; conds may be :class:`MatchCond` or tuples of them
    (so :func:`prefix` splices in directly)."""
    flat: List[MatchCond] = []
    for c in conds:
        flat.extend(c if isinstance(c, (tuple, list)) else (c,))
    return PolicyRule(tuple(flat), action, name=name)


@dataclasses.dataclass
class Verdict:
    """One message's resolved policy outcome."""
    kind: str                 # 'forward' | 'drop' | 'punt'
    backend: int = 0
    rule: int = -1            # matched row (R = no match)
    reason: str = ""          # punt reason
    rewrites: Tuple[Tuple[int, int], ...] = ()
    epoch: int = 0            # table epoch the verdict was resolved under
    failover: bool = False    # True iff re-verdicted to the failover backend


class PolicyTable:
    """Ordered policy rules compiled to dense int32 arrays.

    The dense form is ``(cond_off, cond_lo, cond_hi)`` — each ``[R, K]``
    int32, ``-1`` offsets padding always-true slots — plus the action
    columns ``(act_kind, act_a, act_b, act_c, act_d)`` (each ``[R]``
    int32). :meth:`decode` reconstructs the source rows from the dense
    arrays alone (rule names excepted), so compilation is lossless —
    the property tests round-trip it.

    ``health`` (a :class:`HealthTable`, optional) makes backend liveness a
    data-plane input: :meth:`rule_live` folds it into a per-rule int32
    mask that the match pass consumes, and FORWARD rules with a
    ``failover`` re-verdict to it host-side. :meth:`swap` replaces the
    rule set under live traffic: the dense arrays are recompiled in place
    and :attr:`epoch` bumps — verdicts stamp the epoch they were resolved
    under, and in-flight messages keep their already-resolved verdicts
    (resolution is eager at match time), so a swap never re-routes a
    message mid-round.
    """

    def __init__(self, rules: Sequence[PolicyRule],
                 health: Optional[HealthTable] = None):
        self.health = health
        self.epoch = 0
        # token buckets: (rule, key) -> [milli-tokens, last refill tick]
        self._buckets: Dict[Tuple[int, int], List[int]] = {}
        self.stats: Dict[str, object] = {
            "rounds": 0, "matched": 0, "no_match": 0, "forwards": 0,
            "drops": 0, "punts": 0, "rate_debits": 0, "failovers": 0,
            "swaps": 0, "rule_hits": [],
            "punts_by_reason": {},
        }
        self._compile(rules)

    def _compile(self, rules: Sequence[PolicyRule]) -> None:
        """(Re)build the dense arrays from ``rules`` — the one copy of the
        compiler shared by ``__init__`` and :meth:`swap`."""
        self.rules: Tuple[PolicyRule, ...] = tuple(rules)
        assert self.rules, "a PolicyTable needs at least one rule"
        r = len(self.rules)
        k = max(max((len(ru.conds) for ru in self.rules), default=1), 1)
        self.cond_off = np.full((r, k), -1, np.int32)
        self.cond_lo = np.zeros((r, k), np.int32)
        self.cond_hi = np.zeros((r, k), np.int32)
        acts = np.zeros((5, r), np.int32)   # kind, a, b, c, d
        for i, ru in enumerate(self.rules):
            for j, c in enumerate(ru.conds):
                for v in (c.offset, c.lo, c.hi):
                    assert -(1 << 31) <= v < (1 << 31), \
                        "conditions must fit the int32 device plane"
                self.cond_off[i, j] = c.offset
                self.cond_lo[i, j] = c.lo
                self.cond_hi[i, j] = c.hi
            a = ru.action
            acts[0, i] = a.kind
            if a.kind == ACT_FORWARD:
                acts[1, i] = a.backend
                acts[2, i] = a.failover
            if a.kind == ACT_REWRITE:
                acts[1, i] = a.backend
                acts[2, i] = a.slot
                acts[3, i] = a.value
            if a.kind == ACT_RATE_LIMIT:
                acts[1, i] = a.backend
                acts[2, i] = a.rate_millis
                acts[3, i] = a.burst_millis
                acts[4, i] = a.key_offset
        (self.act_kind, self.act_a, self.act_b,
         self.act_c, self.act_d) = acts
        self.stats["rule_hits"] = [0] * r

    def swap(self, rules: Sequence[PolicyRule]) -> int:
        """Hot-swap the rule set under live traffic: recompile the dense
        arrays in place, reset the token buckets (bucket rows are keyed by
        row index, which the swap renumbers), and bump :attr:`epoch`.
        Health state survives (it describes backends, not rules). Returns
        the new epoch. In-flight messages — already matched and resolved —
        keep their old-epoch verdicts; only rounds matched *after* the
        swap see the new table."""
        self._compile(rules)
        self._buckets.clear()
        self.epoch += 1
        self.stats["swaps"] += 1
        return self.epoch

    @property
    def n_rules(self) -> int:
        return len(self.rules)

    @property
    def has_payload_conds(self) -> bool:
        """True iff any rule peeks the payload — callers only build (and
        ship) first-page windows when this is set, so metadata-only tables
        keep their exact pre-payload operand shapes."""
        return bool((self.cond_off <= PAYLOAD_COND_BASE).any())

    def clone(self) -> "PolicyTable":
        """Same rules, fresh buckets/stats (per-worker tables). The
        :class:`HealthTable` instance is SHARED — backend health is a
        cluster-wide fact, not per-worker state."""
        return PolicyTable(self.rules, health=self.health)

    # -- dense form --------------------------------------------------------
    def dense(self) -> Tuple[np.ndarray, ...]:
        return (self.cond_off, self.cond_lo, self.cond_hi, self.act_kind,
                self.act_a, self.act_b, self.act_c, self.act_d)

    @classmethod
    def decode(cls, cond_off, cond_lo, cond_hi, act_kind, act_a, act_b,
               act_c, act_d) -> "PolicyTable":
        """Rebuild the source rows from the dense arrays (names lost)."""
        rules = []
        for i in range(len(act_kind)):
            conds = tuple(
                MatchCond(int(cond_off[i, j]), int(cond_lo[i, j]),
                          int(cond_hi[i, j]))
                for j in range(cond_off.shape[1]) if cond_off[i, j] != -1)
            kind = int(act_kind[i])
            if kind == ACT_FORWARD:
                a = Action(kind, backend=int(act_a[i]),
                           failover=int(act_b[i]))
            elif kind == ACT_REWRITE:
                a = Action(kind, backend=int(act_a[i]), slot=int(act_b[i]),
                           value=int(act_c[i]))
            elif kind == ACT_RATE_LIMIT:
                a = Action(kind, backend=int(act_a[i]),
                           rate_millis=int(act_b[i]),
                           burst_millis=int(act_c[i]),
                           key_offset=int(act_d[i]))
            else:
                a = Action(kind)
            rules.append(PolicyRule(conds, a))
        return cls(rules)

    # -- matching ----------------------------------------------------------
    def rule_live(self) -> Optional[np.ndarray]:
        """Per-rule liveness column for the match pass: ``[R]`` int32,
        ``0`` for a routing rule (FORWARD/REWRITE/RATE_LIMIT) whose primary
        backend is down with no healthy failover — such a rule is skipped
        by the match so priority falls through to the next rule (or the
        PUNT tail). Returns ``None`` when every rule is live (no health
        table, or nothing tripped) so the kernel paths stay operand-free
        on the fault-free fast path."""
        h = self.health
        if h is None:
            return None
        col = h.column()
        nb = h.n_backends

        def _ok(idx: np.ndarray) -> np.ndarray:
            out_of = (idx < 0) | (idx >= nb)
            return out_of | (col[np.clip(idx, 0, nb - 1)] > 0)

        routing = np.isin(self.act_kind,
                          (ACT_FORWARD, ACT_REWRITE, ACT_RATE_LIMIT))
        primary_ok = _ok(self.act_a)
        fo = np.where(self.act_kind == ACT_FORWARD, self.act_b, -1)
        failover_ok = (fo >= 0) & _ok(fo)
        live = (~routing) | primary_ok | failover_ok
        if live.all():
            return None
        return live.astype(np.int32)

    def interpret(self, meta: np.ndarray, meta_len: int,
                  live: Optional[np.ndarray] = None,
                  payload: Optional[np.ndarray] = None,
                  payload_len: int = 0) -> int:
        """Naive Python interpreter of the rows — the oracle the vectorized
        pass (and the kernel) must agree with. Returns the first matching
        row, or ``n_rules``. ``live`` (the :meth:`rule_live` column) skips
        dead rows exactly as the vectorized paths do. ``payload`` is the
        plaintext first-page window (payload-prefix conditions never hold
        without one)."""
        for i, ru in enumerate(self.rules):
            if live is not None and not live[i]:
                continue
            if all(self._cond_holds(c, meta, meta_len, payload, payload_len)
                   for c in ru.conds):
                return i
        return self.n_rules

    @staticmethod
    def _cond_holds(c: MatchCond, meta, meta_len: int, payload,
                    payload_len: int) -> bool:
        if c.offset >= 0:
            return c.offset < meta_len and c.lo <= int(meta[c.offset]) <= c.hi
        pos = c.payload_pos
        return (payload is not None and pos < payload_len
                and pos < len(payload)
                and c.lo <= int(payload[pos]) <= c.hi)

    def match_rows(self, metas: np.ndarray, meta_lens: np.ndarray,
                   keystreams: Optional[np.ndarray] = None,
                   live: Optional[np.ndarray] = None,
                   payload: Optional[np.ndarray] = None,
                   payload_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized numpy first-match over a round: ``metas`` [B, M]
        (int64-exact host truth), ``meta_lens`` [B] → [B] row indices.
        ``keystreams`` (same shape, 0 where plaintext) is XORed in first —
        matching against *decrypted* metadata without a separate pass.
        ``live`` ([R] int32) masks out rules whose backends are down.
        ``payload`` ([B, W] plaintext first-page windows, with
        ``payload_lens``) serves payload-prefix conditions."""
        m = metas if keystreams is None else np.bitwise_xor(
            metas, keystreams.astype(metas.dtype))
        mm = m.shape[1]
        off = self.cond_off.astype(np.int64)                 # [R, K]
        vals = m[:, np.clip(off, 0, mm - 1)]                 # [B, R, K]
        pad = off == PAD_COND
        present = (off >= 0) & (off < meta_lens[:, None, None]) & (off < mm)
        ok = pad[None] | (present & (vals >= self.cond_lo) &
                          (vals <= self.cond_hi))
        if payload is not None:
            w = payload.shape[1]
            ppos = PAYLOAD_COND_BASE - off                   # [R, K]
            pvals = payload[:, np.clip(ppos, 0, w - 1)]      # [B, R, K]
            pay_ok = (off <= PAYLOAD_COND_BASE)[None] \
                & (ppos[None] < payload_lens[:, None, None]) \
                & (ppos < w)[None] \
                & (pvals >= self.cond_lo) & (pvals <= self.cond_hi)
            ok = ok | pay_ok
        rule_ok = ok.all(axis=2)                             # [B, R]
        if live is not None:
            rule_ok &= live[None, :] > 0
        return np.where(rule_ok.any(axis=1), rule_ok.argmax(axis=1),
                        self.n_rules).astype(np.int32)

    def match_batch(self, metas: np.ndarray, meta_lens: np.ndarray, *,
                    keystreams: Optional[np.ndarray] = None,
                    impl: str = "host",
                    payload: Optional[np.ndarray] = None,
                    payload_lens: Optional[np.ndarray] = None,
                    device="cuda") -> np.ndarray:
        """One vectorized match pass for a whole batched round.
        ``impl='host'`` is the int64-exact numpy path; anything else goes
        through :func:`repro_torch.kernels.ops.policy_match` (the CUDA kernel
        / its plain PyTorch version) on the int32 plane of ``device`` — rounds whose tokens do
        not survive int32 bounce back to the numpy path (the same rule as
        the anchoring pass). The :meth:`rule_live` health column rides
        along as an extra dense operand on every path, as does the
        plaintext first-page ``payload`` window when the table has
        payload-prefix conditions."""
        self.stats["rounds"] += 1
        live = self.rule_live()
        if impl != "host":
            vals = [int(metas.min(initial=0)), int(metas.max(initial=0))]
            if payload is not None and payload.size:
                vals += [int(payload.min()), int(payload.max())]
            if -(1 << 31) <= min(vals) and max(vals) < (1 << 31):
                import torch

                from repro_torch.kernels import ops

                dev = ops.checked_device(device)

                def up(a):
                    return (None if a is None else torch.from_numpy(
                        np.ascontiguousarray(a, np.int32)).to(dev))

                rids = ops.policy_match(
                    up(metas), up(meta_lens), up(self.cond_off),
                    up(self.cond_lo), up(self.cond_hi), impl=impl,
                    keystream=up(keystreams), live=up(live),
                    payload=up(payload), payload_len=up(payload_lens))
                return rids.cpu().numpy().astype(np.int32)
        return self.match_rows(metas, meta_lens, keystreams, live,
                               payload=payload, payload_lens=payload_lens)

    # -- action resolution (host-side, stateful) ---------------------------
    def _bucket_debit(self, row: int, key: int, now: int) -> bool:
        """Token bucket for RATE_LIMIT rows: refill by rate·Δtick (capped
        at burst), then try to debit one token. Milli-token integer math —
        deterministic for identical (trace, tick) schedules."""
        b = self._buckets.get((row, key))
        if b is None:
            b = [int(self.act_c[row]), now]    # start full
            self._buckets[(row, key)] = b
        tokens, last = b
        tokens = min(int(self.act_c[row]),
                     tokens + (now - last) * int(self.act_b[row]))
        if tokens >= _MILLI:
            b[0], b[1] = tokens - _MILLI, now
            return True
        b[0], b[1] = tokens, now
        return False

    def failover_for(self, rid: int) -> int:
        """The failover backend of FORWARD row ``rid`` (``-1`` if none /
        not a FORWARD row) — consulted by held-send retries without
        re-running :meth:`decide` (which would double-debit buckets)."""
        if 0 <= rid < self.n_rules and int(self.act_kind[rid]) == ACT_FORWARD:
            return int(self.act_b[rid])
        return -1

    def _resolve_one(self, rid: int, meta: np.ndarray, meta_len: int,
                     crypto: bool, now: int, counters=None) -> Verdict:
        v = self._resolve_inner(rid, meta, meta_len, crypto, now, counters)
        v.epoch = self.epoch
        return v

    def _resolve_inner(self, rid: int, meta: np.ndarray, meta_len: int,
                       crypto: bool, now: int, counters=None) -> Verdict:
        st = self.stats
        if rid >= self.n_rules:
            st["no_match"] += 1
            return Verdict("punt", rule=self.n_rules, reason=PUNT_NO_MATCH)
        st["matched"] += 1
        st["rule_hits"][rid] += 1
        kind = int(self.act_kind[rid])
        if kind == ACT_FORWARD:
            backend = int(self.act_a[rid])
            if self.health is not None and not self.health.healthy(backend):
                fo = int(self.act_b[rid])
                if fo >= 0 and self.health.healthy(fo):
                    st["failovers"] += 1
                    if counters is not None:
                        counters.policy_failovers += 1
                    return Verdict("forward", backend=fo, rule=rid,
                                   failover=True)
                # matched before the trip landed (or raced the live mask):
                # nothing healthy to route to — the slow path decides
                return Verdict("punt", rule=rid, reason=PUNT_UNHEALTHY)
            return Verdict("forward", backend=backend, rule=rid)
        if kind == ACT_REWRITE:
            slot = int(self.act_b[rid])
            if crypto:
                # patching sealed metadata would break the record's auth
                # tag downstream — only the slow path may re-frame it
                return Verdict("punt", rule=rid, reason=PUNT_REWRITE_CRYPTO)
            if slot >= meta_len:
                return Verdict("punt", rule=rid,
                               reason=PUNT_REWRITE_OVERFLOW)
            return Verdict("forward", backend=int(self.act_a[rid]), rule=rid,
                           rewrites=((slot, int(self.act_c[rid])),))
        if kind == ACT_RATE_LIMIT:
            key_off = int(self.act_d[rid])
            key = int(meta[key_off]) if 0 <= key_off < meta_len else -1
            if self._bucket_debit(rid, key, now):
                st["rate_debits"] += 1
                if counters is not None:
                    counters.policy_rate_debits += 1
                return Verdict("forward", backend=int(self.act_a[rid]),
                               rule=rid)
            return Verdict("punt", rule=rid, reason=PUNT_RATE_LIMITED)
        if kind == ACT_DROP:
            return Verdict("drop", rule=rid)
        return Verdict("punt", rule=rid, reason=PUNT_RULE)

    def resolve(self, rids: np.ndarray, metas: np.ndarray,
                meta_lens: np.ndarray, *, crypto: Sequence[bool],
                now: int, counters=None) -> List[Verdict]:
        """Resolve a round's matched rows to verdicts, in round order
        (token-bucket debits are sequential, mirroring the scalar
        schedule). ``metas`` must be the *plaintext* metadata."""
        return [self._resolve_one(int(rid), metas[i], int(meta_lens[i]),
                                  bool(crypto[i]), now, counters)
                for i, rid in enumerate(rids)]

    def decide(self, buf: np.ndarray, *, parser, crypto: bool = False,
               now: int = 0, counters=None,
               payload: Optional[np.ndarray] = None,
               payload_len: int = 0) -> Verdict:
        """Scalar-path verdict for one delivered message (``[meta...,
        VPI]`` or a full copy): parse for the metadata boundary, run the
        naive interpreter, resolve. Unparseable frames PUNT
        (``malformed``). ``payload``/``payload_len`` is the plaintext
        first-page window for payload-prefix conditions (callers peek it
        only when :attr:`has_payload_conds`)."""
        buf = np.asarray(buf)
        res = parser.parse(buf)
        if not res.ok or res.meta_len > len(buf):
            self.stats["rounds"] += 1
            return Verdict("punt", rule=self.n_rules, reason=PUNT_MALFORMED,
                           epoch=self.epoch)
        self.stats["rounds"] += 1
        rid = self.interpret(buf, res.meta_len, self.rule_live(),
                             payload=payload, payload_len=payload_len)
        return self._resolve_one(rid, buf, res.meta_len, crypto, now,
                                 counters)

    # -- verdict accounting (apply side) -----------------------------------
    def note_outcome(self, verdict: Verdict) -> None:
        """Count the outcome a channel actually applied (forwards vs punts
        may diverge from resolution when e.g. the backend index is out of
        range for the channel)."""
        st = self.stats
        if verdict.kind == "forward":
            st["forwards"] += 1
        elif verdict.kind == "drop":
            st["drops"] += 1
        else:
            st["punts"] += 1
            by = st["punts_by_reason"]
            by[verdict.reason] = by.get(verdict.reason, 0) + 1

    def summary(self) -> Dict[str, object]:
        """JSON-friendly telemetry snapshot."""
        out = dict(self.stats)
        out["rule_hits"] = list(self.stats["rule_hits"])
        out["punts_by_reason"] = dict(self.stats["punts_by_reason"])
        out["buckets"] = len(self._buckets)
        out["epoch"] = self.epoch
        if self.health is not None:
            out["health"] = self.health.summary()
        return out


class PythonPolicyRouter:
    """The per-channel Python slow path the offload bypasses, as a
    baseline: the SAME :class:`PolicyTable` rules evaluated message-by-
    message by the naive interpreter, exposed through the classic
    ``rewrite``/``router`` callback slots of :class:`ProxyChannel`.

    Wire it as ``ProxyChannel(..., rewrite=r.rewrite, router=r.router)``
    (``rewrite`` runs first and caches the verdict the immediately
    following ``router`` call consumes — the channel calls them back to
    back per message). A DROP verdict returns ``None`` from ``router``,
    which the channel treats as "consume and free" — the same
    :meth:`LibraStack.drop_message` path the offloaded verdict takes. Byte
    and Fig. 9 counter streams are identical to the offloaded table on the
    same trace; only the policy_* event counters (which the baseline does
    not touch) differ.
    """

    def __init__(self, table: PolicyTable, dsts: Sequence, *, parser,
                 crypto: bool = False, stack=None, src=None,
                 punt_router=None, punt_rewrite=None):
        self.table = table
        self.dsts = list(dsts)
        self.parser = parser
        self.crypto = crypto
        self.stack = stack
        # the channel's source socket — needed (with ``stack``) to peek the
        # anchored first-page window when the table has payload conditions
        self.src = src
        self.punt_router = punt_router
        self.punt_rewrite = punt_rewrite
        self._verdict: Optional[Verdict] = None

    def _now(self) -> int:
        return self.stack.now_tick if self.stack is not None else 0

    def rewrite(self, buf: np.ndarray, logical: int) -> np.ndarray:
        payload, plen = None, 0
        if self.table.has_payload_conds and self.stack is not None \
                and self.src is not None:
            payload, plen = self.stack._policy_window(buf, self.src)
        v = self.table.decide(buf, parser=self.parser, crypto=self.crypto,
                              now=self._now(), payload=payload,
                              payload_len=plen)
        if v.kind == "forward" and v.backend >= len(self.dsts):
            v = Verdict("punt", rule=v.rule, reason=PUNT_BAD_BACKEND)
        self._verdict = v
        if v.kind == "forward" and v.rewrites:
            out = np.array(buf)
            for slot, value in v.rewrites:
                out[slot] = value
            return out
        if v.kind == "punt" and self.punt_rewrite is not None:
            return self.punt_rewrite(buf, logical)
        return buf

    def router(self, buf: np.ndarray, logical: int):
        v, self._verdict = self._verdict, None
        assert v is not None, "router called without a preceding rewrite"
        self.table.note_outcome(v)
        if v.kind == "forward":
            return self.dsts[v.backend]
        if v.kind == "drop":
            return None
        if self.punt_router is not None:
            return self.punt_router(buf, logical)
        return self.dsts[0]
