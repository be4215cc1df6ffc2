"""``LibraStack`` — one Libra "kernel" instance.

The stack owns everything the paper's kernel half owns, so that socket
call-sites carry zero plumbing:

* the anchored payload pool (:class:`AnchorPool` allocator +
  :class:`TokenPool` payload store — the kernel-retained skb pages),
* the global ``<VPI, payload>`` map (:class:`VpiRegistry`),
* the parser-policy registry (named eBPF RX/TX-Prog analogues),
* a monotonic tick clock driving §A.4 deferred-teardown expiry,
* the global :class:`CopyCounters` telemetry block (paper Fig. 9).

Sockets are created with :meth:`socket` / :meth:`socket_pair`; a single
stack multiplexes any number of connections with heterogeneous parser
policies (see :mod:`repro_torch.core.runtime` for the event loop on top).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.anchor_pool import AnchorPool, PageRef
from repro_torch.core.crypto import (
    REC_HEADER,
    TAG_SLOT,
    CryptoRecordParser,
    keystream_batch,
)
from repro_torch.core.device_pool import DevicePool, DeviceRangeError
from repro_torch.core.egress import expire_teardowns
from repro_torch.core.ingress import reset_rx_from_tx
from repro_torch.core.parser import BUILTIN_PARSERS, LengthPrefixedParser, ParserPolicy
from repro_torch.core.socket import Events, LibraSocket
from repro_torch.core.state_machine import MIN_PAYLOAD, St
from repro_torch.core.stream import Connection, CopyCounters, TokenPool
from repro_torch.core.sync import plane_lock
from repro_torch.core.vpi import VpiRegistry

ParserLike = Union[str, ParserPolicy]

#: forward_batch outcome tags
SEND_OK = "ok"
SEND_EAGAIN = "eagain"


@dataclasses.dataclass
class _BatchItem:
    """One admissible message in a batched recv round."""
    sock: LibraSocket
    buf_len: int
    meta_len: int
    payload_len: int
    pages: List[PageRef]
    meta: np.ndarray = None
    payload: np.ndarray = None   # zero-copy rx window (valid until advance)
    ks: np.ndarray = None        # hw-kTLS RX keystream (fused into the scatter)
    plain: np.ndarray = None     # payload plaintext the auth sweep produced
    # policy-offload operands (captured only when a policy rides the round):
    # the pre-decrypt inner metadata and its keystream span, so the device
    # match pass can run on ciphertext + keystream exactly like the kernel's
    # other crypto operands (host rounds match the plaintext directly)
    cmeta: np.ndarray = None
    meta_ks: np.ndarray = None
    # one-kernel round speculation: the forward-time cache descriptor the
    # fused gather output lands in (parked on the socket after the VPI is
    # registered; forward_batch validates the guess before consuming it)
    fused_tx: dict = None


def _fits_int32(a: np.ndarray) -> bool:
    """True when every token survives the int32 device stream round-trip."""
    return len(a) == 0 or (int(a.min()) >= -(1 << 31)
                           and int(a.max()) < (1 << 31))


def _fused_base(impl: str) -> Optional[str]:
    """The device impl underlying a fused-round dispatch string:
    ``'fused-round'`` -> ``'auto'``, ``'fused-round:ref'`` -> ``'ref'``
    (same for ``:cuda``); ``None`` for a non-fused impl.
    The base impl also serves ineligible/bounced rounds through the
    classic three-launch path."""
    if impl == "fused-round":
        return "auto"
    if impl.startswith("fused-round:"):
        return impl.split(":", 1)[1]
    return None


class LibraStack:
    """Shared selective-copy state for a set of :class:`LibraSocket`\\ s."""

    def __init__(self, *, n_shards: int = 4, pages_per_shard: int = 64,
                 page_size: int = 16, max_pages_per_seq: int = 0,
                 grace_ticks: int = 5, secret: Optional[bytes] = None,
                 alloc: Optional[AnchorPool] = None,
                 registry: Optional[VpiRegistry] = None,
                 parsers: Optional[Dict[str, type]] = None,
                 device_pool: bool = True, device="cuda"):
        self.alloc = alloc or AnchorPool(n_shards, pages_per_shard, page_size,
                                         max_pages_per_seq=max_pages_per_seq)
        # device_pool=True (default): the payload pool stays resident on the
        # device across batched rounds (dirty-row-tracked host mirror for the
        # scalar paths — residency itself is lazy, so host-only workloads pay
        # nothing). device_pool=False keeps the legacy host pool that bounces
        # the whole pool per device-impl round (pool_syncs telemetry).
        # ``device`` is where device-impl rounds run: "cuda" by default (a
        # first device round with no GPU present raises), "cpu" in tests.
        self.pool = (DevicePool(self.alloc, device=device) if device_pool
                     else TokenPool(self.alloc, device=device))
        self.registry = registry or VpiRegistry(secret=secret,
                                                grace_ticks=grace_ticks)
        self.counters = CopyCounters()
        self.parsers: Dict[str, type] = dict(BUILTIN_PARSERS)
        self.parsers.setdefault("crypto-record", CryptoRecordParser)
        if parsers:
            self.parsers.update(parsers)
        self.now_tick = 0
        self.sockets: Dict[int, LibraSocket] = {}
        # vpi -> anchoring socket (the kernel finds this through the global
        # eBPF map; the facade keeps an explicit owner index)
        self._vpi_owner: Dict[int, LibraSocket] = {}
        self._null_conn: Optional[Connection] = None
        # multi-worker awareness (set by repro_torch.core.cluster.LibraCluster):
        # this stack's slot in the cluster, the cluster itself (the VPI
        # interconnect consulted when a transmit meets a handle that does
        # not resolve locally), and the peer workers' pools by pool_id so
        # egress can route cross-worker grant entries to the pool that
        # actually owns their pages. All stay inert for a standalone stack.
        self.worker_id: Optional[int] = None
        self.interconnect = None
        self._peer_pools: Dict[str, Union[TokenPool, DevicePool]] = {}
        # chaos harness: a repro_torch.core.faults.FaultPlan consulted by the
        # socket delivery and channel send paths (None = no faults)
        self.fault_plan = None

    # -- socket lifecycle ----------------------------------------------------
    def make_parser(self, parser: ParserLike, **kw) -> ParserPolicy:
        """Resolve a registered parser name (or pass a policy through)."""
        if isinstance(parser, str):
            return self.parsers[parser](**kw)
        return parser

    def socket(self, parser: ParserLike = "length-prefixed", *,
               min_payload: int = MIN_PAYLOAD,
               send_budget: Optional[int] = None,
               tls: Optional[str] = None) -> LibraSocket:
        """Open a connection on this stack. ``min_payload`` above any real
        message size forces the native full-copy path (a standard-stack
        baseline socket); ``send_budget`` models a bounded send buffer.

        ``tls='sw'|'hw'`` runs the connection through the kTLS-analogue
        record layer: ``parser`` becomes the *inner* protocol and the wire
        carries encrypted records (the given parser is wrapped in a
        :class:`CryptoRecordParser`; session keys derive from the stack's
        registry secret). ``'sw'`` models software kTLS — separate
        decrypt/encrypt-and-copy passes at the RX/TX boundary, no fused
        batching; ``'hw'`` models NIC-inline kTLS — the cipher fused into
        the selective-copy scatter/gather, zero extra passes."""
        pol = self.make_parser(parser)
        if tls is not None and not isinstance(pol, CryptoRecordParser):
            pol = CryptoRecordParser(inner=pol)
        sock = LibraSocket(self, pol, min_payload=min_payload,
                           send_budget=send_budget, tls=tls)
        self.sockets[sock.fileno()] = sock
        return sock

    def socket_pair(self, parser: ParserLike = "length-prefixed",
                    **kw) -> Tuple[LibraSocket, LibraSocket]:
        """A (client-side, backend-side) pair sharing one parser policy —
        the two halves of one proxied flow."""
        return self.socket(parser, **kw), self.socket(parser, **kw)

    def close_all(self) -> int:
        """Close every open socket; returns total anchors deferred."""
        return sum(s.close() for s in list(self.sockets.values()))

    # -- clock ---------------------------------------------------------------
    def tick(self, n: int = 1) -> int:
        """Advance the monotonic clock ``n`` ticks, expiring §A.4 grace
        periods each tick. Returns the number of pages reclaimed."""
        freed = 0
        for _ in range(max(n, 1)):
            self.now_tick += 1
            freed += expire_teardowns(self.pool, self.registry, self.now_tick)
        self._gc_anchor_owners()
        return freed

    def drain(self) -> int:
        """Tick through a full grace period (teardown flush for tests and
        orderly shutdown)."""
        return self.tick(self.registry.grace_ticks + 1)

    # -- telemetry -----------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.alloc.total_pages - self.alloc.free_pages

    def utilization(self) -> float:
        return self.alloc.used_fraction

    @property
    def high_watermark(self) -> float:
        """§A.1 receive-window watermark (fraction of pool pages in use at
        which ingress backpressure engages)."""
        return self.alloc.high_watermark

    @high_watermark.setter
    def high_watermark(self, frac: float) -> None:
        self.alloc.high_watermark = frac

    def above_watermark(self) -> bool:
        """Backpressure signal: the pool is nearly full — pausing selective
        ingress now avoids overflowing into the §A.1 drain path."""
        return self.alloc.above_watermark()

    def poll(self) -> Dict[int, Events]:
        """Stack-wide readiness snapshot (epoll_wait analogue)."""
        return {fd: s.poll() for fd, s in self.sockets.items()}

    # -- batched datapath ----------------------------------------------------
    def recv_batch(
        self,
        socks: Sequence[LibraSocket],
        buf_len: Union[int, Dict[int, int]] = 1 << 20,
        *,
        impl: str = "host",
        policy=None,
        tx_hints: Optional[Dict[int, LibraSocket]] = None,
    ) -> Dict[int, Tuple[np.ndarray, int]]:
        """Batched instrumented recvmsg (§3.3) across many sockets.

        Gathers every socket whose next frame is admissible to the
        selective path in one shot (RX machine in DEFAULT, parseable frame,
        whole payload resident, room for metadata + VPI in the buffer, pool
        pages available), runs the selective-copy data plane ONCE for the
        whole batch, and scatters the results back through each socket's RX
        state machine — batched data movement, unchanged per-socket control
        flow and counters.

        ``impl='host'`` executes the single-pass placement as one fused
        numpy scatter directly into the pool (allocation-free, exact int64).
        Any other value is forwarded to :func:`repro_torch.kernels.ops.selective_copy`
        (``'auto'``/``'ref'``/``'cuda'``): the round is
        flattened into one ``[B, S]`` int32 batch and the fused kernel runs
        over the pool's reserved scratch row. With the default
        :class:`DevicePool` the pool is **resident across rounds** — only
        the round's O(batch) operands cross the host/device boundary and
        nothing syncs back (rows materialize lazily for scalar readers);
        the legacy host pool (``device_pool=False``) pays one whole-pool
        bounce per round (``pool.xfer['pool_syncs']``).

        ``impl='fused-round'`` (or ``'fused-round:ref'`` /
        ``'fused-round:cuda'`` to pin the backend) runs the
        whole round as ONE device launch — anchoring, hw-kTLS decrypt, the
        L7 first-match AND the egress gather fused into a single kernel
        against the resident pool (``pool.xfer['fused_rounds']``), instead
        of the three launches the multi-pass path costs. ``tx_hints``
        (src fd -> likely destination socket) lets the fused round
        speculatively TX-encrypt the gather output for hw-kTLS
        destinations; ``forward_batch`` validates each guess and consumes
        the prefetched payload (``pool.xfer['tx_spec_hits']``), falling
        back to its own gather on a miss. Ineligible or bounced rounds
        (host pool, int64-only tokens, non-contiguous pages,
        DeviceRangeError) are served by the classic multi-pass path on the
        underlying impl and counted as ``device_fallbacks``.

        ``policy`` (a :class:`~repro_torch.core.policy.PolicyTable`) fuses the
        L7 routing decision into this same metadata pass: ONE vectorized
        first-match sweep over the round's metadata block resolves every
        message's verdict (token-bucket debits included, in round order)
        and leaves it on ``sock._policy_verdict`` for the runtime to apply
        — matched messages go straight to ``forward_batch`` without the
        per-channel Python routing callbacks. hw-kTLS rows are matched as
        ciphertext + keystream on the device plane (the kernel's fused
        decrypt), plaintext on the host plane — identical verdicts.

        ``buf_len`` is one size for all sockets or a per-fd mapping.
        Returns ``{fd: (buffer, logical_len)}`` for the serviced sockets;
        a socket absent from the result was not batchable this round (mid
        message, drain mode, unparseable/short frame, buffer too small for
        metadata + VPI, pool exhausted, ...) and should fall back to scalar
        ``recv`` — every edge state keeps its §3.3/§A.1 semantics there.
        """
        def _bl(sock: LibraSocket) -> int:
            if isinstance(buf_len, dict):
                return buf_len.get(sock.fileno(), 1 << 20)
            return buf_len

        cands: List[Tuple[LibraSocket, object, int]] = []
        for sock in socks:
            conn = sock.connection
            if conn.closed or conn.rx_drain_remaining > 0:
                continue
            if conn.crypto is not None and conn.crypto.mode == "sw":
                # sw-kTLS: the software record layer must run between the
                # socket queue and the pool, per message — such sockets are
                # not admissible to the fused batch and pay the scalar
                # decrypt-and-copy path (the §B.1 penalty: software crypto
                # forfeits the batched-datapath amortization)
                continue
            sm = conn.rx_machine
            if sm.state is not St.DEFAULT:
                continue
            if conn.rx_available() == 0:
                continue
            parsed = sock.parse_pending()
            if not parsed.ok or parsed.payload_len < sm.min_payload:
                continue  # full-copy / unparseable: scalar path
            if conn.rx_available() < parsed.meta_len + parsed.payload_len:
                continue  # NIC DMA incomplete: never anchor holes
            bl = _bl(sock)
            if bl < parsed.meta_len + parsed.payload_len:
                # the WHOLE logical message must fit the user buffer: a
                # buf_len-capped round would hand back a truncated logical
                # length and leave a FAST_PATH continuation straddling the
                # batch/scalar boundary — scalar ``recv`` owns truncated
                # delivery end to end (§3.3), the batch services only
                # complete messages (every result below is machine-complete)
                continue
            cands.append((sock, parsed, bl))
        if not cands:
            return {}

        # ONE freelist pass allocates the whole round (placement identical
        # to per-item alloc_sequence calls, so the pool layout — and every
        # downstream byte — matches the scalar schedule exactly)
        with plane_lock(self.alloc):
            page_lists = self.alloc.alloc_batch(
                [parsed.payload_len for _, parsed, _ in cands])
        # every page list the round still owns, keyed by identity: entries
        # leave as they are freed in-band (reject/overflow) or handed off to
        # the registry; a fault anywhere below hands the rest back (OWN001)
        round_owned = {id(pl): pl for pl in page_lists if pl is not None}
        try:
            return self._recv_batch_round(cands, page_lists, round_owned,
                                          policy, impl, tx_hints)
        except BaseException:
            if round_owned:
                with plane_lock(self.alloc):
                    self.alloc.free_batch(list(round_owned.values()))
            raise

    def _recv_batch_round(self, cands, page_lists, round_owned, policy,
                          impl, tx_hints=None
                          ) -> Dict[int, Tuple[np.ndarray, int]]:
        items: List[_BatchItem] = []
        leaked: List[List[PageRef]] = []
        for (sock, parsed, bl), pages in zip(cands, page_lists):
            if pages is None:
                continue  # §A.1 overflow is the scalar path's business
            sm = sock.connection.rx_machine
            # drive the existing state machine: DEFAULT -> ... -> WRITE_VPI
            decision = sm.on_recv(sock.connection.rx_window(sm.parser.lookahead),
                                  bl, parsed=parsed)
            if decision.state is not St.WRITE_VPI:
                # should be unreachable given the admission checks above,
                # but a machine that lands anywhere else must not leak the
                # pages we just allocated: hand everything back and let the
                # scalar path re-evaluate the socket from a clean state
                # (nothing has been consumed from the ring yet)
                leaked.append(pages)
                sm.reset()
                continue
            items.append(_BatchItem(sock, bl, decision.copy_meta,
                                    sm.payload_len, pages))
        if leaked:
            with plane_lock(self.alloc):
                self.alloc.free_batch(leaked)
            for pl in leaked:
                round_owned.pop(id(pl), None)
        if not items:
            return {}

        # -- selective copy of metadata (host buffers stay int64-exact) -----
        crypt: List[_BatchItem] = []
        for it in items:
            conn = it.sock.connection
            it.meta = conn.rx_peek(it.meta_len).copy()
            conn.rx_advance(it.meta_len)
            self.counters.meta_copied += it.meta_len
            it.payload = conn.rx_peek(it.payload_len)
            if conn.crypto is not None:
                crypt.append(it)
        if crypt:
            # hw-kTLS (sw never reaches the batch): ONE vectorized keystream
            # sweep covers every encrypted record of the round, inner
            # metadata + payload. The metadata span decrypts right here
            # (those bytes are being copied to user space anyway); the
            # payload span is fused into the batched anchoring pass below —
            # no per-message crypto work survives in the fused round.
            kss = keystream_batch(
                [it.sock.connection.crypto.rx_key for it in crypt],
                [int(it.meta[1]) for it in crypt],
                [it.meta_len - REC_HEADER + it.payload_len for it in crypt])
            rejected = set()
            for it, ks in zip(crypt, kss):
                imeta = it.meta_len - REC_HEADER
                crypto = it.sock.connection.crypto
                if policy is not None:
                    # keep the ciphertext inner metadata + its keystream
                    # span: the device match pass consumes them as the
                    # kernel's keystream operand (fused decrypt-and-match)
                    it.cmeta = it.meta.copy()
                    it.meta_ks = ks[:imeta]
                it.meta[REC_HEADER:] = np.bitwise_xor(it.meta[REC_HEADER:],
                                                      ks[:imeta])
                it.ks = ks[imeta:]
                # per-record auth, folded into this same sweep (the NIC
                # verifies while it DMAs): a tag mismatch rejects the
                # record before the fused anchoring pass — pages back to
                # the freelist, record consumed, nothing charged, nothing
                # delivered (scalar ``recv`` raises RecordAuthError for
                # the same wire bytes; the batch drops the slot so one
                # tampered flow cannot poison the round). The plaintext
                # the check produces is kept: the host scatter anchors it
                # directly (one cipher pass total); the device plane still
                # ships ciphertext + keystream operands (the kernel's XOR
                # is its fused decrypt).
                it.plain = np.bitwise_xor(it.payload, it.ks)
                if not crypto.verify_record(
                        int(it.meta[1]), it.meta[TAG_SLOT],
                        np.concatenate([it.meta[REC_HEADER:], it.plain])):
                    self.counters.meta_copied -= it.meta_len
                    with plane_lock(self.alloc):
                        self.alloc.free_batch([it.pages])
                    round_owned.pop(id(it.pages), None)
                    it.sock.connection.rx_advance(it.payload_len)
                    it.sock.connection.rx_machine.reset()
                    it.sock._auth_rejected = True
                    rejected.add(id(it))
                    continue
                crypto.stats["records_opened"] += 1
            if rejected:
                items = [it for it in items if id(it) not in rejected]
                if not items:
                    return {}

        # -- one-kernel round: anchor + decrypt + match + gather, 1 launch --
        base = _fused_base(impl)
        if base is not None:
            if self._recv_batch_fused(items, policy, base, tx_hints):
                return self._recv_batch_scatter(items, round_owned)
            # not device-eligible (or bounced): the classic three-launch
            # path serves the round on the same underlying impl
            self.counters.device_fallbacks += 1
            impl = base

        # -- L7 policy: ONE vectorized match pass for the round -------------
        if policy is not None:
            self._policy_match_round(items, policy, impl)

        # -- payload anchoring: ONE fused pass for the whole round ----------
        if impl != "host" and not all(
                _fits_int32(it.meta) and _fits_int32(it.payload)
                for it in items):
            # the device data plane rides an int32 stream; out-of-range
            # int64 tokens would truncate silently — serve this round from
            # the int64-exact host scatter instead and count the bounce
            self.counters.device_fallbacks += 1
            impl = "host"
        if impl != "host" and not self._recv_batch_device(items, impl):
            # the round's destination rows hold host-truth content that
            # does not survive the int32 device dtype: int64-exact host path
            self.counters.device_fallbacks += 1
            impl = "host"
        if impl == "host":
            self.pool.write_payload_batch(
                [(it.pages, it.plain if it.plain is not None else it.payload)
                 for it in items],
                keystreams=[None if it.plain is not None else it.ks
                            for it in items])

        return self._recv_batch_scatter(items, round_owned)

    def _recv_batch_scatter(self, items: List[_BatchItem], round_owned
                            ) -> Dict[int, Tuple[np.ndarray, int]]:
        """The round's per-socket bookkeeping tail, shared by the fused and
        multi-pass data planes: register each anchor, advance the RX
        machine, and hand back the ``[meta..., VPI]`` user buffers."""
        results: Dict[int, Tuple[np.ndarray, int]] = {}
        for it in items:
            conn = it.sock.connection
            sm = conn.rx_machine
            self.counters.anchored += it.payload_len
            self.counters.allocs += 1
            conn.rx_advance(it.payload_len)
            with plane_lock(self.registry):
                vpi = self.registry.register(
                    self.pool.pool_id,
                    [(p.shard, p.local_pid, p.base_pos) for p in it.pages],
                    it.payload_len,
                )
            round_owned.pop(id(it.pages), None)
            conn.anchored[vpi] = (it.pages, it.payload_len)
            buf = np.concatenate(
                [it.meta, np.array([VpiRegistry.to_token(vpi)], np.int64)])
            self.counters.vpi_injected += 1
            # admission guaranteed logical room for the whole message, so
            # the credit always completes the machine (scalar ``recv`` owns
            # buf_len-truncated logical delivery)
            logical = it.meta_len + it.payload_len
            sm.on_payload_consumed(it.payload_len)
            self._note_anchor_owner(it.sock)
            # park (or clear) the fused round's speculative TX descriptor:
            # unconditional, so a stale guess from an earlier round can
            # never alias a recycled VPI
            if it.fused_tx is not None:
                it.fused_tx["vpi"] = vpi
            it.sock._fused_tx = it.fused_tx
            results[it.sock.fileno()] = (buf, logical)
        return results

    def _policy_match_round(self, items: List[_BatchItem], policy,
                            impl: str) -> None:
        """The fused L7 routing decision for one batched round: flatten the
        round's (already materialized) metadata into one [B, M] block, run
        the table's vectorized first-match pass once, resolve actions in
        round order (token buckets debit here), and park each verdict on
        its socket for the runtime to consume. Device impls match hw-kTLS
        rows as ciphertext + keystream (the kernel's fused decrypt); the
        host impl matches the plaintext the crypt sweep already produced —
        the verdicts are identical either way. Payload-prefix conditions
        get the plaintext first-page window (built only when the table has
        any — metadata-only tables keep their exact operand shapes)."""
        pmetas, mlens = self._round_meta_block(items)
        b = len(items)
        mm = pmetas.shape[1]
        pw = plens = None
        if getattr(policy, "has_payload_conds", False):
            pw, plens = self._round_payload_windows(items)
        if impl == "host":
            rids = policy.match_batch(pmetas, mlens, payload=pw,
                                      payload_lens=plens)
        else:
            cmetas = pmetas
            ksm = None
            if any(it.cmeta is not None for it in items):
                cmetas = pmetas.copy()
                ksm = np.zeros((b, mm), np.int64)
                for i, it in enumerate(items):
                    if it.cmeta is not None:
                        cmetas[i, : it.meta_len] = it.cmeta
                        ksm[i, REC_HEADER : it.meta_len] = it.meta_ks
            rids = policy.match_batch(cmetas, mlens, keystreams=ksm,
                                      impl=impl, payload=pw,
                                      payload_lens=plens,
                                      device=self.pool.device)
            # launch accounting for the 3-vs-1 claim: a device-impl
            # multi-pass round dispatches its match as its own launch
            self.pool.xfer["policy_match_rounds"] += 1
        self._park_verdicts(items, policy, rids, pmetas, mlens)

    def _round_meta_block(self, items: List[_BatchItem]):
        """The round's plaintext metadata flattened to [B, M] int64 (+ [B]
        lengths) — the block both match paths and verdict resolution share."""
        mm = max(it.meta_len for it in items)
        b = len(items)
        pmetas = np.zeros((b, mm), np.int64)
        mlens = np.empty((b,), np.int32)
        for i, it in enumerate(items):
            pmetas[i, : it.meta_len] = it.meta
            mlens[i] = it.meta_len
        return pmetas, mlens

    def _round_payload_windows(self, items: List[_BatchItem]):
        """[B, page] plaintext first-page windows + [B] payload lengths for
        payload-prefix policy conditions — the host mirror of the window
        the fused kernel matches while the page is still in registers."""
        page = self.alloc.page_size
        pw = np.zeros((len(items), page), np.int64)
        plens = np.empty((len(items),), np.int32)
        for i, it in enumerate(items):
            src = it.plain if it.plain is not None else it.payload
            w = min(page, it.payload_len)
            pw[i, :w] = src[:w]
            plens[i] = it.payload_len
        return pw, plens

    def _park_verdicts(self, items: List[_BatchItem], policy, rids,
                       pmetas, mlens) -> None:
        """Resolve a round's matched rows host-side (token buckets debit in
        round order) and park each verdict on its socket for the runtime."""
        verdicts = policy.resolve(
            rids, pmetas, mlens,
            crypto=[it.sock.connection.crypto is not None for it in items],
            now=self.now_tick, counters=self.counters)
        for it, v in zip(items, verdicts):
            it.sock._policy_verdict = v

    def _policy_window(self, buf: np.ndarray, sock: LibraSocket
                       ) -> Tuple[Optional[np.ndarray], int]:
        """The plaintext first-page payload window of one delivered message
        (``[meta..., VPI]`` or a full copy), for scalar payload-prefix
        policy decisions — the host mirror of the window the fused kernel
        matches in registers. Anchored messages peek the pool (which holds
        plaintext in every kTLS mode — ingress decrypts before anchoring);
        full copies slice the inline buffer. Returns ``(window,
        payload_len)``, ``(None, 0)`` when there is nothing to peek."""
        page = self.alloc.page_size
        buf64 = np.asarray(buf, np.int64)
        _meta_len, _vpi, entry, res = sock._peek_message(buf64)
        if entry is not None:
            w = min(page, entry.payload_len)
            if w <= 0:
                return None, 0
            if entry.stash is not None:
                win = np.asarray(entry.stash, np.int64)[:w]
            else:
                pages = [PageRef(*pg) for pg in entry.pages]
                win = self.pool_for_entry(entry).read_payload(pages[:1], w)
            return win, entry.payload_len
        if res.ok and res.payload_len > 0:
            avail = min(res.payload_len, max(len(buf64) - res.meta_len, 0))
            w = min(page, avail)
            if w <= 0:
                return None, 0
            return buf64[res.meta_len : res.meta_len + w], avail
        return None, 0

    def drop_message(self, msg: np.ndarray, sock: LibraSocket) -> bool:
        """Policy ``DROP``: consume a delivered ``[meta..., VPI]`` message
        without transmitting it — the registry reference is released and
        the anchored pages go straight back to the freelist (no §A.4 grace:
        the verdict is an explicit discard, not a dangling close). ``sock``
        supplies the parser that framed the message. Full-copy messages
        (no live anchor) have nothing below the boundary to free. Returns
        True when an anchor was released.

        Dropping plays the egress-completion role end to end: the socket's
        RX machine is parked awaiting Post-Send cleanup (§3.4) after a
        selective delivery, so the drop performs the same
        :func:`reset_rx_from_tx` a completed transmit would — without it
        the connection would wedge in FAST_PATH forever."""
        buf64 = np.asarray(msg, np.int64)
        try:
            # the peek→release pair is one atomic region: a grantee
            # completing a forward of the same anchor releases the owner
            # VPI concurrently, and VpiRegistry.release() on an already-
            # gone entry reports "last reference" — peeking outside the
            # lock would double-free the pages (lock order: registry
            # before the owner's alloc, per the committed hierarchy)
            with plane_lock(self.registry):
                _meta_len, vpi, entry, _res = sock._peek_message(buf64)
                if entry is None:
                    return False
                if entry.stash is not None:
                    # one-copy handoff entry: payload rides the entry itself
                    self.registry.release(vpi)
                    return True
                pages = [PageRef(*pg) for pg in entry.pages]
                if entry.grant is not None:
                    # cross-worker grant: release our entry and the pin on
                    # the owner's pages — a peer pool's grant state, so the
                    # drop holds the cluster-plane lock (no-op single-stack)
                    owner_alloc = self.pool_for_entry(entry).alloc
                    with plane_lock(owner_alloc):
                        if self.registry.release(vpi):
                            owner_alloc.release_export(pages)
                    return True
                owner = self._anchor_owner(vpi)
                with plane_lock(self.alloc):
                    if self.registry.release(vpi):
                        self.alloc.free_pages_list(pages)
            if owner is not None:
                owner.connection.anchored.pop(vpi, None)
            self._gc_anchor_owners()
            return True
        finally:
            reset_rx_from_tx(sock.connection)

    def _recv_batch_fused(self, items: List[_BatchItem], policy, impl: str,
                          tx_hints) -> bool:
        """The one-kernel scheduling round: flatten the round into the same
        [B, S] operands as :meth:`_recv_batch_device` and run
        :meth:`DevicePool.fused_round_device` ONCE — payload anchoring,
        hw-kTLS RX decrypt, the L7 first-match (payload-prefix conditions
        evaluated against the page tokens still in registers) and the
        egress gather all in a single device launch, instead of the three
        the multi-pass path costs. The gather output is parked per message
        in a :attr:`_BatchItem.fused_tx` descriptor (the scatter tail moves
        it onto the socket once the VPI exists): a speculative TX —
        ``tx_hints`` names each flow's likely destination so hw-kTLS TX
        encryption is fused in too, and ``forward_batch`` validates the
        guess before consuming it. Returns False when the round is not
        device-eligible (host pool, int64-only tokens, non-contiguous page
        lists) or bounced (DeviceRangeError) — the caller then serves it
        through the classic three-launch path."""
        if not isinstance(self.pool, DevicePool):
            return False
        page = self.alloc.page_size
        for it in items:
            if not (_fits_int32(it.meta) and _fits_int32(it.payload)):
                return False
            if any(pg.base_pos != j * page
                   for j, pg in enumerate(it.pages)):
                # the in-register gather addresses payload position
                # [j*page, (j+1)*page) through table slot j — only the
                # allocator's contiguous layout qualifies
                return False
        b = len(items)
        pps = max(max(len(it.pages) for it in items), 1)
        meta_max = max(max(it.meta_len for it in items), 1)
        s = max(it.meta_len + len(it.pages) * page for it in items)
        s = max(-(-max(s, meta_max) // page) * page, page)
        stream = np.zeros((b, s), np.int32)
        meta_len = np.zeros((b,), np.int32)
        total_len = np.zeros((b,), np.int32)
        tables = np.full((b, pps), -1, np.int32)
        ks = np.zeros((b, s), np.int32) if any(
            it.ks is not None for it in items) else None
        for i, it in enumerate(items):
            msg = it.meta_len + it.payload_len
            stream[i, : it.meta_len] = it.meta
            stream[i, it.meta_len : msg] = it.payload
            meta_len[i] = it.meta_len
            total_len[i] = msg
            if it.ks is not None:
                ks[i, it.meta_len : msg] = it.ks
            for j, pg in enumerate(it.pages):
                tables[i, j] = self.alloc.flat_pid(pg)
        txks = self._speculate_tx(items, tx_hints, pps * page)
        off = lo = hi = live = None
        if policy is not None:
            off, lo, hi = policy.cond_off, policy.cond_lo, policy.cond_hi
            live = policy.rule_live()
        try:
            verdict, gathered = self.pool.fused_round_device(
                stream, meta_len, total_len, tables, meta_max=meta_max,
                impl=impl, keystream=ks, tx_keystream=txks,
                cond_off=off, cond_lo=lo, cond_hi=hi, live=live,
                n_buffers=getattr(self.pool, "fused_buffers", 0))
        except DeviceRangeError:
            return False
        if policy is not None:
            # the fused launch IS this round's match pass; resolution stays
            # host-side exactly as in _policy_match_round
            policy.stats["rounds"] += 1
            pmetas, mlens = self._round_meta_block(items)
            self._park_verdicts(items, policy, verdict, pmetas, mlens)
        for i, it in enumerate(items):
            if it.fused_tx is not None:
                it.fused_tx["payload"] = gathered[i, : it.payload_len]
        return True

    def _speculate_tx(self, items: List[_BatchItem], tx_hints,
                      width: int) -> Optional[np.ndarray]:
        """Speculative TX operands for the fused round: each message whose
        likely destination (``tx_hints``: src fd -> socket) is known gets a
        forward-time cache descriptor on its :class:`_BatchItem`; hw-kTLS
        destinations additionally contribute rows to the returned
        [B, width] TX-keystream operand (ONE vectorized sweep, exactly the
        forward_batch schedule) so the fused gather emits ciphertext and
        the metadata span is stashed for seal_meta at forward time. Wrong
        guesses cost nothing — forward_batch validates the descriptor and
        falls back to its own gather."""
        txks = None
        enc: List[Tuple[int, object, int, int]] = []
        for i, it in enumerate(items):
            dst = tx_hints.get(it.sock.fileno()) if tx_hints else None
            if dst is None or dst.closed:
                continue
            crypto = dst.connection.crypto
            if crypto is None:
                it.fused_tx = {"dst_fd": dst.fileno(), "crypto": None,
                               "plen": it.payload_len, "seq": None,
                               "meta_ks": None, "payload": None}
            elif crypto.mode == "hw" and it.ks is not None:
                # encrypted record toward an hw session: the record seq
                # rides the header (slot 1), so the whole TX keystream is
                # computable before the destination ever sees the message
                enc.append((i, crypto, int(it.meta[1]),
                            it.meta_len - REC_HEADER))
            # sw destinations: scalar encrypt-and-copy, never speculated
        if enc:
            kss = keystream_batch(
                [crypto.tx_key for _, crypto, _, _ in enc],
                [seq for _, _, seq, _ in enc],
                [imeta + items[i].payload_len for i, _, _, imeta in enc])
            txks = np.zeros((len(items), width), np.int32)
            for (i, crypto, seq, imeta), ksr in zip(enc, kss):
                it = items[i]
                txks[i, : it.payload_len] = ksr[imeta:]
                it.fused_tx = {
                    "dst_fd": tx_hints[it.sock.fileno()].fileno(),
                    "crypto": crypto, "plen": it.payload_len, "seq": seq,
                    "meta_ks": ksr[:imeta], "payload": None}
        return txks

    def _recv_batch_device(self, items: List[_BatchItem], impl: str) -> bool:
        """Flatten the round into one [B, S] batch and run the fused
        selective-copy kernel once through the pool's device entry point
        (resident :class:`DevicePool` by default: O(batch) up, nothing
        back; legacy host pool: one whole-pool bounce). hw-kTLS rows ship
        their RX keystream as the kernel's ``keystream`` operand, so
        decryption is fused into the payload placement. Returns False when
        the round must bounce to the int64-exact host scatter."""
        page = self.alloc.page_size
        b = len(items)
        pps = max(len(it.pages) for it in items)
        meta_max = max(max(it.meta_len for it in items), 1)
        s = max(it.meta_len + len(it.pages) * page for it in items)
        s = max(-(-max(s, meta_max) // page) * page, page)
        stream = np.zeros((b, s), np.int32)
        meta_len = np.zeros((b,), np.int32)
        total_len = np.zeros((b,), np.int32)
        tables = np.full((b, pps), -1, np.int32)
        ks = np.zeros((b, s), np.int32) if any(
            it.ks is not None for it in items) else None
        for i, it in enumerate(items):
            msg = it.meta_len + it.payload_len
            # int64 host tokens ride the int32 device stream; recv_batch
            # pre-checked the range (out-of-range rounds fall back to host)
            stream[i, : it.meta_len] = it.meta
            stream[i, it.meta_len : msg] = it.payload
            meta_len[i] = it.meta_len
            total_len[i] = msg
            if it.ks is not None:
                ks[i, it.meta_len : msg] = it.ks
            for j, pg in enumerate(it.pages):
                tables[i, j] = self.alloc.flat_pid(pg)
        try:
            self.pool.anchor_batch_device(stream, meta_len, total_len,
                                          tables, meta_max=meta_max,
                                          impl=impl, keystream=ks)
        except DeviceRangeError:
            return False
        return True

    def forward_batch(
        self,
        sends: Sequence[Tuple[Optional[LibraSocket], LibraSocket,
                              np.ndarray, Optional[int]]],
        *,
        impl: str = "host",
    ) -> List[Tuple[str, int]]:
        """Batched proxy forwarding: ``sends`` is a list of
        ``(src_sock, dst_sock, buf, budget)``. The anchored payloads of all
        FAST_PATH-eligible messages are fetched with ONE fused gather
        (:meth:`TokenPool.read_payload_batch`, or — ``impl`` other than
        ``'host'`` on the resident :class:`DevicePool` — the fused
        :func:`~repro_torch.kernels.ops.selective_gather` kernel reading the
        anchored pages on-device) and handed to each socket's normal
        transmit path, so counters, staging, partial-send resume and
        cross-datapath cleanup behave exactly as scalar ``forward``.

        Returns one ``(status, accepted)`` per send, in order:
        ``(SEND_OK, n)`` or ``(SEND_EAGAIN, 0)`` (backend busy with another
        flow's truncated message — retry next round, as scalar).

        Encrypted hw-mode destinations get their TX keystream fused into
        the batched gather (NIC-inline encrypt, still one pass); sw-mode
        destinations are excluded from the prefetch — their encrypt pass
        runs per message inside the scalar transmit (the §B.1 penalty).
        Messages a fused recv round already gathered
        (``recv_batch(impl='fused-round', tx_hints=...)``) skip even that
        single launch: the speculative descriptor parked on the source
        socket is validated (same VPI, destination session and payload
        length, plain local anchor) and consumed directly
        (``pool.xfer['tx_spec_hits']``); misses fall back to the gather.

        Cross-worker sends work here too: a VPI that does not resolve on
        the destination's stack is adopted through the cluster interconnect
        (zero-copy grant or counted one-copy stash) before prefetch
        eligibility is decided, and the fused gathers are grouped by the
        pool that owns each entry's pages — a grant's payload is gathered
        straight off the owning worker's (device-resident) pool."""
        sends = list(sends)
        # under one-kernel rounds, sends the fused recv did not speculate
        # (or whose guess missed) gather on the same underlying device impl
        base = _fused_base(impl)
        if base is not None:
            impl = base
        prefetch: List[Optional[np.ndarray]] = [None] * len(sends)
        peeks: List[Optional[Tuple]] = [None] * len(sends)
        # (send slot, entry, (pages, len), ksinfo) per prefetch-eligible send
        gather: List[Tuple[int, object, Tuple, Optional[Tuple]]] = []
        for k, (src, dst, buf, budget) in enumerate(sends):
            if dst.pending_send is not None or dst.closed:
                continue
            buf64 = np.asarray(buf, np.int64)
            peek = dst._peek_message(buf64)
            if peek[2] is None and peek[1] is not None:
                # unresolved handle: in a cluster it may be anchored on a
                # peer worker — adopt (grant/copy) and re-peek so the rest
                # of the round treats it exactly like a local message
                adopted = dst.stack._adopt_message(buf64, peek[1], peek[3])
                if adopted is not None:
                    buf64 = adopted
                    peek = dst._peek_message(buf64)
                    sends[k] = (src, dst, buf64, budget)
            peeks[k] = peek
            entry = peek[2]
            if entry is None or \
                    entry.payload_len < dst.connection.tx_machine.min_payload:
                continue
            crypto = dst.connection.crypto
            if crypto is not None and crypto.mode == "sw":
                continue  # software record layer: scalar encrypt-and-copy
            spec = getattr(src, "_fused_tx", None) if src is not None \
                else None
            if spec is not None and spec.get("vpi") == peek[1]:
                # the fused round speculated this send: its gather output
                # (TX-encrypted for an hw destination) is already in hand.
                # Validate the guess — right destination session, same
                # payload, a plain local anchor — and skip the gather; a
                # miss just falls through to the classic path below.
                src._fused_tx = None
                if spec["payload"] is not None \
                        and spec["dst_fd"] == dst.fileno() \
                        and spec["crypto"] is crypto \
                        and spec["plen"] == entry.payload_len \
                        and entry.stash is None and entry.grant is None:
                    if spec["meta_ks"] is not None:
                        crypto.stash_tx_meta_ks(spec["seq"],
                                                spec["meta_ks"])
                    prefetch[k] = np.asarray(spec["payload"], np.int64)
                    self.pool.xfer["tx_spec_hits"] += 1
                    continue
            ksinfo = None
            if crypto is not None:
                # hw-kTLS: (session, seq, inner-meta length) — the whole
                # record keystream is generated below in one vectorized
                # sweep for the round (metadata span stashed for the
                # seal_meta this transmit is about to trigger, payload span
                # fused into the batched gather)
                ksinfo = (crypto, int(buf64[1]), peek[0] - REC_HEADER)
            gather.append((k, entry, ([PageRef(*pg) for pg in entry.pages],
                                      entry.payload_len), ksinfo))
        if gather:
            keystreams: List[Optional[np.ndarray]] = [None] * len(gather)
            enc = [(i, info) for i, (_, _, _, info) in enumerate(gather)
                   if info is not None]
            if enc:
                kss = keystream_batch(
                    [info[0].tx_key for _, info in enc],
                    [info[1] for _, info in enc],
                    [info[2] + gather[i][2][1] for i, info in enc])
                for (i, (crypto, seq, imeta)), ks in zip(enc, kss):
                    crypto.stash_tx_meta_ks(seq, ks[:imeta])
                    keystreams[i] = ks[imeta:]
            # one-copy stash entries carry their payload already; pool
            # entries are gathered per owning pool (grants read the peer
            # worker's pool, local anchors read ours) — one fused gather
            # per pool touched by the round
            groups: Dict[int, Tuple[TokenPool, List[int]]] = {}
            for i, (k, entry, seq_info, _) in enumerate(gather):
                if entry.stash is not None:
                    pv = np.asarray(entry.stash, np.int64)
                    if keystreams[i] is not None:
                        pv = np.bitwise_xor(pv, keystreams[i])
                    prefetch[k] = pv
                    continue
                owner = sends[k][1].stack.pool_for_entry(entry)
                groups.setdefault(id(owner), (owner, []))[1].append(i)
            for owner, idxs in groups.values():
                payloads = self._gather_payloads(
                    [gather[i][2] for i in idxs],
                    [keystreams[i] for i in idxs], impl, pool=owner)
                for i, pv in zip(idxs, payloads):
                    prefetch[gather[i][0]] = pv
        out: List[Tuple[str, int]] = []
        for k, (src, dst, buf, budget) in enumerate(sends):
            peeked, pf = peeks[k], prefetch[k]
            if peeked is not None and peeked[2] is not None and \
                    dst.stack.registry.peek(peeked[1]) is not peeked[2]:
                # an earlier send in this round invalidated the peek (e.g.
                # it released or tore down the same VPI): transmitting
                # against the stale entry would mis-size the pending
                # message and wedge the socket — drop the prefetch and let
                # the transmit re-evaluate, exactly as scalar ``forward``
                peeked, pf = None, None
            try:
                n = dst._transmit(src, buf, budget,
                                  payload_prefetched=pf, peeked=peeked)
            except BlockingIOError:
                out.append((SEND_EAGAIN, 0))
                continue
            out.append((SEND_OK, n))
        return out

    def _gather_payloads(
        self,
        seqs: List[Tuple[List[PageRef], int]],
        keystreams: List[Optional[np.ndarray]],
        impl: str,
        pool: Optional[TokenPool] = None,
    ) -> List[np.ndarray]:
        """Fetch one round's anchored payloads: the fused device gather off
        the resident pool when eligible, the host gather otherwise.
        Byte-identical either way (the gather oracle mirrors
        ``read_payload``); ineligible/bounced rounds stay int64-exact.
        ``pool`` routes the gather to the pool that owns the pages (a peer
        worker's, for cross-worker grant entries); default = our own.
        Every eligible round gathers on the device, however few its rows
        (a GPU launch costs microseconds); a device-plane round served on
        the host instead counts in ``pool.xfer['host_gathers']``."""
        pool = self.pool if pool is None else pool
        page = pool.alloc.page_size
        if impl != "host" and isinstance(pool, DevicePool) and all(
                all(pg.base_pos == j * page for j, pg in enumerate(pages))
                for pages, _ in seqs):
            # the kernel addresses payload position [j*page, (j+1)*page)
            # through table slot j — only contiguously-anchored sequences
            # (the allocator's invariant layout) are device-ELIGIBLE; a
            # non-contiguous page list (exotic registry contents) is not a
            # bounce and does not count a device_fallback, it simply never
            # qualifies for the device plane
            try:
                return self._forward_batch_device(seqs, keystreams, impl,
                                                  pool)
            except DeviceRangeError:
                # a requested row holds host-truth tokens outside int32:
                # the int64-exact host gather serves the round
                self.counters.device_fallbacks += 1
        if impl != "host" and isinstance(pool, DevicePool):
            pool.xfer["host_gathers"] += 1
        return pool.read_payload_batch(seqs, keystreams=keystreams)

    def _forward_batch_device(
        self,
        seqs: List[Tuple[List[PageRef], int]],
        keystreams: List[Optional[np.ndarray]],
        impl: str,
        pool: TokenPool,
    ) -> List[np.ndarray]:
        """Flatten the round into [B, pps] tables + [B] lengths and run the
        fused egress gather once against ``pool``'s resident device array.
        TX keystreams (payload-relative, 31-bit) ride the kernel's
        ``keystream`` operand — NIC-inline encrypt, zero extra passes."""
        page = pool.alloc.page_size
        b = len(seqs)
        pps = max((len(pages) for pages, _ in seqs), default=1) or 1
        tables = np.full((b, pps), -1, np.int32)
        lengths = np.zeros((b,), np.int32)
        ks = (np.zeros((b, pps * page), np.int32)
              if any(k is not None for k in keystreams) else None)
        for i, (pages, ln) in enumerate(seqs):
            lengths[i] = ln
            for j, pg in enumerate(pages):
                tables[i, j] = pool.alloc.flat_pid(pg)
            if ks is not None and keystreams[i] is not None:
                ks[i, :ln] = keystreams[i]
        block = pool.gather_batch_device(tables, lengths, impl=impl,
                                         keystream=ks)
        return [block[i, :ln] for i, (_, ln) in enumerate(seqs)]

    # -- multi-worker plumbing (driven by repro_torch.core.cluster) ----------------
    def register_peer_pool(self, pool: TokenPool) -> None:
        """Make a peer worker's pool addressable by its ``pool_id`` so this
        stack's egress can compose grant entries straight out of it."""
        self._peer_pools[pool.pool_id] = pool

    def pool_for_entry(self, entry) -> TokenPool:
        """The pool that owns ``entry``'s pages: this stack's own pool for
        local anchors (and stash entries, which never touch a pool), the
        registered peer pool for cross-worker grants."""
        if entry is None or entry.pool_id == self.pool.pool_id:
            return self.pool
        return self._peer_pools.get(entry.pool_id, self.pool)

    def _adopt_message(self, msg: np.ndarray, vpi: Optional[int],
                       parsed) -> Optional[np.ndarray]:
        """A transmit met a framed message whose VPI does not resolve in
        THIS stack's registry. In a cluster the handle may belong to a peer
        worker: ask the interconnect to hand the anchored payload over (a
        zero-copy grant, or the counted one-copy fallback) and return the
        message with the granted VPI patched into its VPI slot. None when
        the handle is unknown cluster-wide (stale/garbage: the normal
        FALLBACK_BYPASS path takes it from here)."""
        if self.interconnect is None or vpi is None:
            return None
        if parsed is None or not parsed.ok or \
                len(msg) < parsed.meta_len + 1:
            return None
        granted = self.interconnect.grant_into(self, vpi)
        if granted is None:
            return None
        out = np.asarray(msg, np.int64).copy()
        out[parsed.meta_len] = VpiRegistry.to_token(granted)
        return out

    # -- facade bookkeeping (called by LibraSocket) --------------------------
    def _note_anchor_owner(self, sock: LibraSocket) -> None:
        for vpi in sock.connection.anchored:
            self._vpi_owner.setdefault(vpi, sock)

    def _anchor_owner(self, vpi: int) -> Optional[LibraSocket]:
        return self._vpi_owner.get(vpi)

    def _null_source(self) -> Connection:
        """Inert connection used as the nominal source of sends with no
        live anchor owner, so cross-path cleanup never resets a real RX
        machine (its state machines carry no traffic)."""
        if self._null_conn is None:
            self._null_conn = Connection(LengthPrefixedParser(), self.registry)
        return self._null_conn

    def _gc_anchor_owners(self) -> None:
        dead = [v for v in self._vpi_owner if v not in self.registry]
        for v in dead:
            del self._vpi_owner[v]

    def _detach(self, sock: LibraSocket) -> None:
        self.sockets.pop(sock.fileno(), None)
        self._gc_anchor_owners()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"LibraStack(sockets={len(self.sockets)}, "
                f"pages={self.alloc.free_pages}/{self.alloc.total_pages} free, "
                f"vpis={len(self.registry)}, tick={self.now_tick})")
