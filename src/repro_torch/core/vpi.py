"""Virtual Payload Identifier (VPI) — §3.2 of the paper.

A VPI is a 64-bit opaque, position-independent handle injected into the
control-plane-visible stream in place of an anchored payload. Properties
kept from the paper:

* **Secure mapping** — the VPI is a keyed blake2b hash (never a raw pool
  address), so control-plane code cannot learn pool layout (the KASLR
  argument transfers: handles must not leak device memory structure).
* **Position independence** — the handle survives arbitrary reshuffling of
  the metadata stream (it is just 8 bytes of payload to the proxy).
* **Admission policy** — payloads smaller than the VPI itself (or smaller
  than ``min_payload``) are not anchored; they take the full-copy path.
* **Refcounts + deferred teardown** (§A.4) — entries are refcounted (prefix
  sharing / multi-forwarding) and freed through a grace period.
* **Cross-worker grants** — a multi-worker cluster hands an anchored payload
  from one worker's registry to another's without moving bytes:
  :meth:`VpiRegistry.import_grant` registers a *grant entry* in the
  destination registry that references the owner's pages (and records the
  owner handle), while the owner's pages gain a pin ref
  (:meth:`~repro_torch.core.anchor_pool.AnchorPool.export_grant`). When the grant
  completes, teardown forwards back to the owner (see
  :mod:`repro_torch.core.egress`), so a grant safely outlives the owner socket's
  §A.4 grace period.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
from typing import Dict, List, Optional, Tuple

VPI_BYTES = 8


@dataclasses.dataclass
class GrantRef:
    """Back-reference of a cross-worker grant entry to its owner: the
    registry that anchored the payload and the owner-side VPI. Teardown of
    the grant forwards through this handle (egress completion releases the
    owner entry when it is still live; a §A.4-torn-down owner keeps its own
    deferred-free schedule)."""
    owner_registry: "VpiRegistry"
    owner_vpi: int


@dataclasses.dataclass
class VpiEntry:
    vpi: int
    pool_id: str
    # pages: list of (shard, local_page_id, base_position)
    pages: List[Tuple[int, int, int]]
    payload_len: int           # logical payload length (tokens)
    refcount: int = 1
    state: str = "ANCHORED"    # ANCHORED | TEARDOWN
    teardown_deadline: Optional[int] = None  # engine tick for deferred free
    meta: Optional[dict] = None
    # cross-worker handoff state (see GrantRef): a zero-copy grant keeps the
    # owner back-reference; the one-copy fallback instead carries the
    # payload itself in ``stash`` (pages stay empty, pool never consulted)
    grant: Optional[GrantRef] = None
    stash: Optional[object] = None   # np.ndarray payload (cross_worker_copied)


class VpiRegistry:
    """The global <VPI, anchored-payload> map (the paper's global eBPF map)."""

    def __init__(self, secret: Optional[bytes] = None, grace_ticks: int = 5):
        self._secret = secret if secret is not None else os.urandom(16)
        self._entries: Dict[int, VpiEntry] = {}
        self._counter = 0
        self.grace_ticks = grace_ticks
        # telemetry (used by benchmarks & tests)
        self.stats = {"registered": 0, "hits": 0, "misses": 0, "released": 0,
                      "deferred": 0, "collisions": 0,
                      "grants_in": 0, "grants_out": 0}

    # -- key derivation ----------------------------------------------------
    def derive_key(self, label: bytes, *context: int) -> bytes:
        """Derive a subordinate secret (e.g. a kTLS-analogue session key)
        from the registry secret — same trust root as the VPI handles, so
        control-plane code can hold neither pool addresses nor keystreams."""
        h = hashlib.blake2b(key=self._secret, digest_size=16)
        h.update(label)
        for c in context:
            h.update(struct.pack("<q", int(c)))
        return h.digest()

    # -- handle generation ------------------------------------------------
    def _make_vpi(self) -> int:
        while True:
            self._counter += 1
            h = hashlib.blake2b(
                struct.pack("<Q", self._counter), key=self._secret, digest_size=8
            ).digest()
            vpi = struct.unpack("<Q", h)[0]
            # never hand out 0 (reserved as "no VPI")
            if vpi != 0 and vpi not in self._entries:
                return vpi
            self.stats["collisions"] += 1

    # -- registry ops ------------------------------------------------------
    def register(self, pool_id: str, pages, payload_len: int, meta=None) -> int:
        vpi = self._make_vpi()
        self._entries[vpi] = VpiEntry(vpi, pool_id, list(pages), payload_len,
                                      meta=meta)
        self.stats["registered"] += 1
        return vpi

    def import_grant(self, owner: "VpiRegistry", owner_vpi: int,
                     pool_id: str, pages, payload_len: int,
                     stash=None) -> int:
        """Cross-worker handoff: register a grant entry for an anchored
        payload owned by another worker's registry. With ``stash=None``
        the grant is **zero-copy** — ``pages`` reference the owner's pool
        (the caller must pin them via
        :meth:`~repro_torch.core.anchor_pool.AnchorPool.export_grant`) and the
        entry carries a :class:`GrantRef` so completion/teardown forwards
        back to the owner. With a ``stash`` the entry is the **one-copy
        fallback**: the payload bytes ride the entry itself (``pages``
        empty, no owner back-reference — the owner side was released at
        handoff)."""
        vpi = self._make_vpi()
        self._entries[vpi] = VpiEntry(
            vpi, pool_id, list(pages), payload_len,
            grant=(GrantRef(owner, owner_vpi) if stash is None else None),
            stash=stash)
        self.stats["registered"] += 1
        self.stats["grants_in"] += 1
        owner.stats["grants_out"] += 1
        return vpi

    def resolve(self, vpi: int) -> Optional[VpiEntry]:
        e = self._entries.get(vpi)
        if e is None or e.state == "TEARDOWN":
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return e

    def peek(self, vpi: int) -> Optional[VpiEntry]:
        """``resolve`` without touching the hit/miss telemetry — for
        control-plane bookkeeping (the socket facade sizing a message)."""
        e = self._entries.get(vpi)
        return None if e is None or e.state == "TEARDOWN" else e

    def handoffs(self) -> List[VpiEntry]:
        """Live cross-worker handoff entries (grant back-reference or
        stashed payload) — the shutdown reclaim sweep's view."""
        return [e for e in self._entries.values()
                if e.grant is not None or e.stash is not None]

    def drop(self, vpi: int) -> Optional[VpiEntry]:
        """Forcibly remove an entry regardless of refcount — an abandoned
        cross-worker handoff reclaimed at shutdown (normal completion goes
        through :meth:`release`). Returns the entry, or None."""
        e = self._entries.pop(vpi, None)
        if e is not None:
            self.stats["released"] += 1
        return e

    def torn_down(self, vpi: int) -> bool:
        """True while ``vpi`` sits in its §A.4 grace period: the handle was
        real but its payload is being reclaimed (vs a garbage token)."""
        e = self._entries.get(vpi)
        return e is not None and e.state == "TEARDOWN"

    def retain(self, vpi: int) -> None:
        self._entries[vpi].refcount += 1

    def release(self, vpi: int) -> bool:
        """Drop a reference; returns True when the entry is fully gone."""
        e = self._entries.get(vpi)
        if e is None:
            return True
        e.refcount -= 1
        if e.refcount <= 0:
            del self._entries[vpi]
            self.stats["released"] += 1
            return True
        return False

    # -- deferred teardown (§A.4) -----------------------------------------
    def begin_teardown(self, vpi: int, now_tick: int) -> None:
        """Socket closed while payload still anchored: keep the anchor alive
        for a grace period instead of dangling."""
        e = self._entries.get(vpi)
        if e is not None:
            e.state = "TEARDOWN"
            e.teardown_deadline = now_tick + self.grace_ticks
            self.stats["deferred"] += 1

    def expire_teardowns(self, now_tick: int) -> List[VpiEntry]:
        """Returns entries whose grace period elapsed; caller frees pages."""
        out = []
        for vpi in list(self._entries):
            e = self._entries[vpi]
            if e.state == "TEARDOWN" and e.teardown_deadline is not None \
                    and now_tick >= e.teardown_deadline:
                out.append(e)
                del self._entries[vpi]
        return out

    # -- stream encoding ----------------------------------------------------
    @staticmethod
    def encode(vpi: int) -> bytes:
        return struct.pack("<Q", vpi)

    @staticmethod
    def decode(buf: bytes) -> int:
        assert len(buf) >= VPI_BYTES
        return struct.unpack("<Q", buf[:VPI_BYTES])[0]

    @staticmethod
    def to_token(vpi: int) -> int:
        """Bit-reinterpret the uint64 VPI into an int64 stream token (the
        8-byte slot it occupies in the user-visible byte stream)."""
        return struct.unpack("<q", struct.pack("<Q", vpi))[0]

    @staticmethod
    def from_token(tok: int) -> int:
        return struct.unpack("<Q", struct.pack("<q", int(tok)))[0]

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, vpi: int) -> bool:
        return vpi in self._entries
