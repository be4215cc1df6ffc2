"""Libra core: programmable selective data movement (the paper's contribution).

PyTorch port of the JAX package's ``repro.core``: the same modules and
names, with the resident pool and each round's operands as torch tensors
on ``LibraStack(device=...)`` (and ``LibraCluster(device=...)``, which
gives every worker its own resident pool).

Three layers, top to bottom:

**Facade (policy-free POSIX surface)** — what unmodified proxies program
against. One :class:`LibraStack` per "kernel" owns the anchored payload
pool, the global VPI map, the parser registry, the tick clock, and the
copy-telemetry counters; :class:`LibraSocket` exposes per-connection
``recv``/``send``/``forward``/``close``/``poll`` with zero plumbing at
call-sites. :class:`ProxyRuntime` is the epoll-style event loop that
multiplexes N flows with mixed parser policies over one stack.

* ``stack``          — :class:`LibraStack` (shared kernel state + clock)
* ``socket``         — :class:`LibraSocket` (POSIX-shaped connection facade)
* ``runtime``        — :class:`ProxyRuntime` / :class:`ProxyChannel`
                       (readiness sets, round-robin/priority/DRR
                       scheduling, send budgets, ticks)
* ``cluster``        — :class:`LibraCluster` / :class:`SteeringPolicy` /
                       :class:`ClusterRuntime`: N-worker scale-out with
                       RSS-style flow steering, the cross-worker VPI
                       grant protocol, and work-stealing scheduling

**Mechanism (datapaths)** — the selective-copy machinery itself.

* ``ingress``        — selective-copy recv path (§3.3)
* ``egress``         — metadata-copy + zero-copy ownership-transfer send
                       path, deferred teardown (§3.4, §A.2–A.4)
* ``state_machine``  — RX/TX lifecycle state machines (paper Figs. 4–5)
* ``vpi``            — 64-bit opaque anchored-payload handles + registry
* ``anchor_pool``    — paged, refcounted payload pool allocator + accounting
* ``stream``         — connections + token payload pool (protocol testbed)
* ``device_pool``    — the pool resident on the device as one int32 tensor

**Policy (user programs)** — the eBPF analogue supplied by applications.

* ``parser``         — programmable metadata-boundary policies
* ``crypto``         — kTLS-analogue record layer (§B.1): record framing as
                       a parser policy, keyed token cipher, sw/hw session
                       modes (``stack.socket(..., tls='sw'|'hw')``)
* ``policy``         — in-data-plane L7 policy engine: a
                       :class:`PolicyTable` of matcher→action rules
                       compiled to dense arrays, evaluated per batched
                       round as one vectorized match pass fused into
                       ``recv_batch`` (Python is the PUNT slow path);
                       epoch-versioned hot swap, plus the
                       :class:`HealthTable` backend circuit breaker that
                       feeds the match pass's ``live`` rule mask
* ``faults``         — :class:`FaultPlan`: seeded, deterministic chaos
                       injection (EAGAIN storms, resets, pool pressure,
                       worker kills, frame corruption) for testing the
                       fault-tolerance layer

The free functions ``libra_recv``/``libra_send``/``libra_close``/
``expire_teardowns`` remain exported as the explicit-plumbing compatibility
layer; new code should go through the facade (see docs/API.md).
"""
from repro_torch.core.anchor_pool import AnchorPool, PageRef, PoolExhausted
from repro_torch.core.cluster import ClusterRuntime, LibraCluster, SteeringPolicy
from repro_torch.core.crypto import (
    REC_MAGIC,
    CryptoRecordParser,
    RecordAuthError,
    TlsSession,
    open_record,
    open_stream,
    record_tag,
    seal_record,
    seal_stream,
)
from repro_torch.core.device_pool import DevicePool, DeviceRangeError
from repro_torch.core.egress import expire_teardowns, libra_close, libra_send
from repro_torch.core.faults import FaultPlan
from repro_torch.core.ingress import libra_recv
from repro_torch.core.parser import (
    BUILTIN_PARSERS,
    ChunkedParser,
    DelimiterParser,
    LengthPrefixedParser,
    TokenStreamParser,
    build_chunked_message,
    build_delimited_message,
    build_message,
    kmp_find,
)
from repro_torch.core.policy import (
    Action,
    HealthTable,
    MatchCond,
    PolicyRule,
    PolicyTable,
    PythonPolicyRouter,
    Verdict,
    between,
    drop,
    eq,
    forward,
    prefix,
    punt,
    rate_limit,
    rewrite,
    rule,
)
from repro_torch.core.runtime import (
    ChannelStats,
    LatencyHistogram,
    ProxyChannel,
    ProxyRuntime,
)
from repro_torch.core.socket import Events, LibraSocket
from repro_torch.core.stack import SEND_EAGAIN, SEND_OK, LibraStack
from repro_torch.core.state_machine import RxStateMachine, St, TxStateMachine
from repro_torch.core.stream import Connection, CopyCounters, RxRing, TokenPool
from repro_torch.core.vpi import VPI_BYTES, VpiEntry, VpiRegistry

__all__ = [
    # facade
    "LibraStack", "LibraSocket", "Events",
    "ProxyRuntime", "ProxyChannel", "ChannelStats", "LatencyHistogram",
    "LibraCluster", "SteeringPolicy", "ClusterRuntime",
    "SEND_OK", "SEND_EAGAIN",
    # mechanism
    "AnchorPool", "PageRef", "PoolExhausted",
    "VpiRegistry", "VpiEntry", "VPI_BYTES",
    "RxStateMachine", "TxStateMachine", "St",
    "Connection", "TokenPool", "DevicePool", "DeviceRangeError",
    "CopyCounters", "RxRing",
    # policy
    "LengthPrefixedParser", "DelimiterParser", "ChunkedParser",
    "TokenStreamParser", "BUILTIN_PARSERS", "kmp_find",
    "build_message", "build_delimited_message", "build_chunked_message",
    # L7 policy engine + fault tolerance
    "PolicyTable", "PolicyRule", "MatchCond", "Action", "Verdict",
    "PythonPolicyRouter", "rule", "eq", "between", "prefix",
    "forward", "rewrite", "rate_limit", "drop", "punt",
    "HealthTable", "FaultPlan",
    # kTLS-analogue record layer
    "CryptoRecordParser", "TlsSession", "REC_MAGIC", "RecordAuthError",
    "seal_record", "seal_stream", "open_record", "open_stream", "record_tag",
    # compatibility layer (explicit plumbing)
    "libra_recv", "libra_send", "libra_close", "expire_teardowns",
]
