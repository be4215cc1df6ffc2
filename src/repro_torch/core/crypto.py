"""kTLS-analogue record layer — the paper's §B.1 encrypted datapath.

The paper's second headline result is that Libra's selective-copy gains
survive encryption only when crypto runs where the payload lives: with
NIC-offloaded kTLS the cipher is fused into the DMA datapath ("hw" mode),
while software kTLS must run a separate decrypt/encrypt-and-copy pass over
every payload ("sw" mode) — exactly the pass Libra worked to eliminate.
This module is the token-level mirror of that record layer:

* **Record framing** (:class:`CryptoRecordParser`) — a TLS-record analogue
  wrapping any inner parser's frames. The wire carries
  ``[REC_MAGIC, seq, inner_meta_len, payload_len, tag]`` (the plaintext
  record header) followed by the encrypted inner frame. For the
  selective-copy machinery the record header + encrypted inner metadata are
  *metadata* (copied to user space, decrypted on the way) and the encrypted
  payload is the *anchored* region — so the whole existing RX/TX state
  machinery runs unmodified over ciphertext.
* **Per-record auth tag** — ``tag`` is a truncated (31-bit) keyed blake2b
  over ``(seq, inner plaintext frame)``: the GCM-tag analogue. Because it
  authenticates the *plaintext*, a proxy re-sealing a record under its TX
  key preserves the tag byte-for-byte (same plaintext, same seq) — egress
  pays zero tag recomputation, mirroring NIC-inline kTLS where the device
  re-tags in the DMA pass. Ingress verifies before anchoring: ``sw`` mode
  checks the tag on its decrypt-and-copy pass, ``hw`` mode folds the check
  into the batched keystream sweep (no separate per-message pass). A
  mismatch rejects the record — pages freed, stream advanced —
  via :class:`RecordAuthError` / a dropped batch slot. The MAC key defaults
  to a fixed domain-separation constant (integrity modeling; a real AEAD
  would derive it per session — the repro's point is the datapath cost,
  not the key schedule).
* **Token cipher** — a reversible XOR stream cipher whose per-record
  keystream is derived from the owning stack's :class:`VpiRegistry` secret
  (blake2b seed, splitmix64 expansion). Keystream tokens are 31-bit, so a
  ciphertext token of an int32-safe plaintext token stays int32-safe — the
  fused device kernel's ``keystream`` operand XORs it away in int32.
* **Sessions** (:class:`TlsSession`) — per-socket rx/tx keys plus the small
  amount of continuation state the full-copy fallbacks need (drained
  records on RX, budget-truncated record frames on TX).

Mode semantics (paper Fig. 6c/6d):

* ``sw`` — software kTLS. The record layer runs *between* the socket queue
  and the pool, per message: ingress pays a separate full decrypt pass
  (decrypt-and-copy) before anchoring, egress a separate encrypt pass after
  gathering, and the socket is **not admissible to the fused batched data
  plane** (``recv_batch``/``forward_batch`` prefetch skip it) — software
  crypto forfeits the batched-datapath speedup.
* ``hw`` — NIC-inline kTLS. The XOR is fused into the selective-copy
  scatter/gather itself (:meth:`TokenPool.write_payload` /
  :meth:`read_payload` ``keystream=`` operands, and the fused Pallas
  kernel's ``keystream`` input): anchored ciphertext is decrypted exactly
  once, on the fly, with zero extra passes, and batched rounds stay fused.

Both modes produce byte-identical wire traffic — they differ only in how
many times the payload is touched, which is the paper's point.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.parser import (
    DEFAULT_LOOKAHEAD,
    LengthPrefixedParser,
    ParseResult,
    ParserPolicy,
)

#: record content-type marker (TLS ApplicationData is 23)
REC_MAGIC = 23
#: plaintext record header: [REC_MAGIC, seq, inner_meta_len, payload_len, tag]
REC_HEADER = 5
#: header slot carrying the truncated-blake2b record auth tag
TAG_SLOT = 4
#: keystream tokens are 31-bit so ciphertext = plaintext XOR keystream keeps
#: int32-safe plaintext tokens int32-safe (the device stream constraint)
KS_MASK = 0x7FFFFFFF
#: default MAC domain-separation key (see module docstring)
DEFAULT_MAC_KEY = b"libra-record-mac"

TLS_MODES = ("sw", "hw")


class RecordAuthError(Exception):
    """A record's auth tag did not verify — the record was rejected (bytes
    consumed past it, nothing anchored / anchored pages freed)."""


# ---------------------------------------------------------------------------
# keystream (deterministic, vectorized, host/device-identical)
# ---------------------------------------------------------------------------

def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays (numpy array ops
    wrap mod 2**64 silently; only scalar ops would warn)."""
    z = x + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@functools.lru_cache(maxsize=8192)
def _record_seed(key: bytes, seq: int) -> int:
    """Per-record keystream seed — the only hash in the cipher. Cached so
    the several spans of one record (metadata, payload, drain resumes)
    derive from one blake2b evaluation."""
    return struct.unpack(
        "<Q", hashlib.blake2b(struct.pack("<q", int(seq)), key=key,
                              digest_size=8).digest())[0]


def keystream(key: bytes, seq: int, n: int, offset: int = 0) -> np.ndarray:
    """``n`` keystream tokens for record ``seq`` starting at encrypted-region
    position ``offset`` (position 0 = first token after the record header).
    Pure function of (key, seq, position): any span of a record's keystream
    can be regenerated independently — partial sends and §A.1 drains resume
    at arbitrary offsets."""
    if n <= 0:
        return np.zeros((0,), np.int64)
    seed = _record_seed(key, seq)
    idx = np.arange(offset, offset + n, dtype=np.uint64) + np.uint64(seed)
    return ((_splitmix64(idx) >> np.uint64(33)) & np.uint64(KS_MASK)
            ).astype(np.int64)


def keystream_batch(keys: Sequence[bytes], seqs: Sequence[int],
                    lens: Sequence[int],
                    offsets: Optional[Sequence[int]] = None,
                    ) -> "list[np.ndarray]":
    """Keystream spans for a whole batch of records in ONE vectorized pass
    (one index build + one splitmix sweep over the concatenated lengths) —
    the hw-mode batched data plane generates every record's keystream here,
    so per-message Python overhead stays out of the fused rounds. Returns
    one array per (key, seq, len, offset) quadruple; equals per-record
    :func:`keystream` calls token for token."""
    lens_arr = np.asarray(lens, np.int64)
    total = int(lens_arr.sum())
    if total == 0:
        return [np.zeros((0,), np.int64) for _ in lens]
    seeds = np.array([_record_seed(k, s) for k, s in zip(keys, seqs)],
                     np.uint64)
    if offsets is not None:
        seeds = seeds + np.asarray(offsets, np.uint64)
    starts = np.zeros_like(lens_arr)
    np.cumsum(lens_arr[:-1], out=starts[1:])
    rel = np.arange(total, dtype=np.uint64) \
        - np.repeat(starts.astype(np.uint64), lens_arr)
    idx = rel + np.repeat(seeds, lens_arr)
    ks = ((_splitmix64(idx) >> np.uint64(33)) & np.uint64(KS_MASK)
          ).astype(np.int64)
    return np.split(ks, np.cumsum(lens_arr)[:-1])


def xor_tokens(tokens: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """Apply the stream cipher (its own inverse) — returns a new array."""
    return np.bitwise_xor(np.asarray(tokens, np.int64), ks)


def record_tag(mac_key: bytes, seq: int, body_plain: np.ndarray) -> int:
    """Truncated-blake2b record auth tag over the *plaintext* record body
    (the inner frame: inner metadata + payload), domain-separated by the
    record ``seq``. 31-bit so the tag token — part of the plaintext header —
    rides the int32 device stream untouched."""
    h = hashlib.blake2b(key=mac_key, digest_size=8)
    h.update(struct.pack("<q", int(seq)))
    h.update(np.ascontiguousarray(np.asarray(body_plain, np.int64)).tobytes())
    return struct.unpack("<Q", h.digest())[0] & KS_MASK


# ---------------------------------------------------------------------------
# record framing (the ParserPolicy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CryptoRecordParser:
    """TLS-record framing over any inner parser's frames.

    ``parse`` needs no key: the record header is plaintext and
    self-describing (metadata boundary = header + encrypted inner metadata,
    payload = encrypted inner payload). ``inner`` is the application
    protocol the records encapsulate — used when *building* records
    (:func:`seal_record` locates the inner metadata boundary with it)."""

    inner: ParserPolicy = dataclasses.field(default_factory=LengthPrefixedParser)
    name: str = "crypto-record"
    lookahead: int = DEFAULT_LOOKAHEAD

    def parse(self, window: np.ndarray) -> ParseResult:
        if len(window) and int(window[0]) != REC_MAGIC:
            return ParseResult(False)   # not a record boundary: reject now
        if len(window) < REC_HEADER:
            return ParseResult(False, need_more=True)
        inner_meta = int(window[2])
        payload_len = int(window[3])
        if inner_meta < 0 or payload_len < 0 \
                or REC_HEADER + inner_meta > self.lookahead:
            return ParseResult(False)
        if len(window) < REC_HEADER + inner_meta:
            return ParseResult(False, need_more=True)
        return ParseResult(True, meta_len=REC_HEADER + inner_meta,
                           payload_len=payload_len,
                           consumed=REC_HEADER + inner_meta)


def record_header(buf: np.ndarray) -> Optional[Tuple[int, int, int]]:
    """``(seq, inner_meta_len, payload_len)`` when ``buf`` starts with a
    record header, else None."""
    if len(buf) < REC_HEADER or int(buf[0]) != REC_MAGIC:
        return None
    return int(buf[1]), int(buf[2]), int(buf[3])


# ---------------------------------------------------------------------------
# record build/open helpers (benchmarks, tests, and wire-side peers)
# ---------------------------------------------------------------------------

def seal_record(key: bytes, frame: np.ndarray, parser: ParserPolicy,
                seq: int, mac_key: bytes = DEFAULT_MAC_KEY) -> np.ndarray:
    """Wrap one inner ``frame`` (a full [meta..., payload...] message of
    ``parser``'s protocol) into an encrypted, tagged wire record under
    ``key``."""
    frame = np.asarray(frame, np.int64)
    res = parser.parse(frame)
    assert res.ok and res.payload_len >= 0, \
        "seal_record needs a complete, parseable inner frame"
    assert res.meta_len + res.payload_len == len(frame), \
        (res.meta_len, res.payload_len, len(frame))
    hdr = np.array([REC_MAGIC, seq, res.meta_len, res.payload_len,
                    record_tag(mac_key, seq, frame)], np.int64)
    body = xor_tokens(frame, keystream(key, seq, len(frame)))
    return np.concatenate([hdr, body])


def seal_stream(key: bytes, frames: Sequence[np.ndarray],
                parser: ParserPolicy, seq0: int = 0,
                mac_key: bytes = DEFAULT_MAC_KEY) -> np.ndarray:
    """Seal consecutive inner frames into a record stream (seq0, seq0+1, …)."""
    recs = [seal_record(key, f, parser, seq0 + i, mac_key=mac_key)
            for i, f in enumerate(frames)]
    if not recs:
        return np.zeros((0,), np.int64)
    return np.concatenate(recs)


def open_record(key: bytes, wire: np.ndarray,
                mac_key: bytes = DEFAULT_MAC_KEY,
                verify: bool = True) -> Tuple[np.ndarray, int]:
    """Decrypt the record at the head of ``wire``; returns
    ``(inner_frame, tokens_consumed)``. ``verify=True`` (default) checks
    the record auth tag and raises :class:`RecordAuthError` on mismatch."""
    hdr = record_header(wire)
    assert hdr is not None, "open_record: not a record boundary"
    seq, inner_meta, payload_len = hdr
    body_len = inner_meta + payload_len
    end = REC_HEADER + body_len
    assert len(wire) >= end, (len(wire), end)
    body = xor_tokens(wire[REC_HEADER:end], keystream(key, seq, body_len))
    if verify and record_tag(mac_key, seq, body) != int(wire[TAG_SLOT]):
        raise RecordAuthError(f"record seq={seq}: auth tag mismatch")
    return body, end


def open_stream(key: bytes, wire: np.ndarray,
                mac_key: bytes = DEFAULT_MAC_KEY,
                verify: bool = True) -> np.ndarray:
    """Decrypt a whole record stream back to the concatenated inner frames
    (what the plaintext regime would have put on the wire), verifying each
    record's auth tag along the way."""
    wire = np.asarray(wire, np.int64)
    frames, pos = [], 0
    while pos < len(wire):
        frame, used = open_record(key, wire[pos:], mac_key=mac_key,
                                  verify=verify)
        frames.append(frame)
        pos += used
    if not frames:
        return np.zeros((0,), np.int64)
    return np.concatenate(frames)


# ---------------------------------------------------------------------------
# per-socket session
# ---------------------------------------------------------------------------

class TlsSession:
    """Per-connection kTLS-analogue state: direction keys plus the small
    continuation state the full-copy fallback paths need.

    ``rx_key`` decrypts records *arriving at* this socket (wire peers seal
    with it); ``tx_key`` encrypts records this socket transmits (wire peers
    open its ``tx_wire()`` with it). Keys derive from the owning stack's
    VPI-registry secret, so two sockets of one stack never share keystreams.
    """

    def __init__(self, mode: str, rx_key: bytes, tx_key: bytes,
                 mac_key: bytes = DEFAULT_MAC_KEY):
        assert mode in TLS_MODES, mode
        self.mode = mode
        self.rx_key = rx_key
        self.tx_key = tx_key
        self.mac_key = mac_key
        self._seq = 0
        # §A.1 drain continuation: (seq, next encrypted-region offset) of the
        # record whose payload is being served through the full-copy path
        self.rx_drain: Optional[Tuple[int, int]] = None
        # budget-truncated full-copy TX record: (seq, next record position,
        # end position) — resumes the keystream mid-record
        self.tx_resume: Optional[Tuple[int, int, int]] = None
        # record seq of an RX metadata span copied across several recv calls
        # (tiny user buffers): continuations no longer see the header
        self.rx_meta_seq: Optional[int] = None
        # one-slot TX metadata-keystream stash: the batched forwarder
        # generates the whole record keystream in its vectorized sweep and
        # parks the metadata span here for the seal_meta call it is about
        # to trigger (keyed by seq — a mismatch just regenerates)
        self._tx_meta_ks: Optional[Tuple[int, np.ndarray]] = None
        self.stats = {"records_opened": 0, "records_sealed": 0,
                      "sw_decrypt_passes": 0, "sw_encrypt_passes": 0,
                      "auth_failures": 0}

    @staticmethod
    def _crypt_span(key: bytes, chunk: np.ndarray, seq: int,
                    rec_pos: int) -> np.ndarray:
        """XOR the encrypted-region part of a record span that starts at
        record position ``rec_pos`` (0 = REC_MAGIC). Header tokens pass
        through untouched; the keystream offset follows the position."""
        chunk = np.asarray(chunk, np.int64)
        out = chunk.copy()
        enc_from = max(REC_HEADER - rec_pos, 0)
        span = len(chunk) - enc_from
        if span > 0:
            off = rec_pos + enc_from - REC_HEADER
            out[enc_from:] = xor_tokens(chunk[enc_from:],
                                        keystream(key, seq, span, off))
        return out

    # -- wire-side helpers (tests / benchmarks: the remote peers) -----------
    def next_seq(self) -> int:
        """Fresh record sequence number for locally-originated records."""
        self._seq += 1
        return self._seq

    def seal(self, frame: np.ndarray, parser: ParserPolicy,
             seq: Optional[int] = None) -> np.ndarray:
        """Encrypt an inner frame *toward* this socket (peer-side sendmsg)."""
        return seal_record(self.rx_key, frame, parser,
                           self.next_seq() if seq is None else seq,
                           mac_key=self.mac_key)

    def seal_frames(self, frames: Sequence[np.ndarray],
                    parser: ParserPolicy) -> np.ndarray:
        return np.concatenate([self.seal(f, parser) for f in frames]) \
            if frames else np.zeros((0,), np.int64)

    def open_wire(self, wire: np.ndarray) -> np.ndarray:
        """Decrypt everything this socket transmitted (peer-side recv)."""
        return open_stream(self.tx_key, wire, mac_key=self.mac_key)

    # -- RX datapath hooks ---------------------------------------------------
    def verify_record(self, seq: int, tag: int,
                      body_plain: np.ndarray) -> bool:
        """Check a record's auth tag against the decrypted body (inner
        metadata + payload plaintext). Counts failures; the caller rejects
        the record (consume + free) on False."""
        if record_tag(self.mac_key, seq, body_plain) == int(tag):
            return True
        self.stats["auth_failures"] += 1
        return False

    def rx_open_span(self, chunk: np.ndarray, seq: int,
                     rec_pos: int) -> np.ndarray:
        """Decrypt an RX record span starting at record position
        ``rec_pos`` (full-copy fallbacks, drain mode, partial metadata)."""
        return self._crypt_span(self.rx_key, chunk, seq, rec_pos)

    def rx_payload_keystream(self, seq: int, inner_meta_len: int,
                             n: int, consumed: int = 0) -> np.ndarray:
        """Keystream covering payload tokens [consumed, consumed+n) of a
        record (payload starts at encrypted-region offset inner_meta_len)."""
        return keystream(self.rx_key, seq, n, inner_meta_len + consumed)

    def sw_decrypt_payload(self, seq: int, inner_meta_len: int,
                           payload: np.ndarray,
                           consumed: int = 0) -> np.ndarray:
        """sw-kTLS ingress: the separate decrypt-and-copy pass (a fresh
        buffer the zero-copy path then has to anchor anyway)."""
        self.stats["sw_decrypt_passes"] += 1
        return xor_tokens(payload, self.rx_payload_keystream(
            seq, inner_meta_len, len(payload), consumed))

    # -- TX datapath hooks ---------------------------------------------------
    def stash_tx_meta_ks(self, seq: int, ks: np.ndarray) -> None:
        """Park a metadata keystream the batched forwarder already swept."""
        self._tx_meta_ks = (seq, ks)

    def seal_meta(self, meta: np.ndarray) -> np.ndarray:
        """Re-encrypt the inner-metadata span of an outgoing record prefix
        under this socket's TX key (the selective metadata copy, outbound)."""
        meta = np.asarray(meta, np.int64)
        if len(meta) <= REC_HEADER:
            return meta
        seq = int(meta[1])
        span = len(meta) - REC_HEADER
        stash, self._tx_meta_ks = self._tx_meta_ks, None
        if stash is not None and stash[0] == seq and len(stash[1]) == span:
            ks = stash[1]
        else:
            ks = keystream(self.tx_key, seq, span)
        out = meta.copy()
        out[REC_HEADER:] = xor_tokens(meta[REC_HEADER:], ks)
        self.stats["records_sealed"] += 1
        return out

    def tx_payload_keystream(self, seq: int, inner_meta_len: int,
                             n: int) -> np.ndarray:
        return keystream(self.tx_key, seq, n, inner_meta_len)

    def sw_encrypt_payload(self, seq: int, inner_meta_len: int,
                           payload: np.ndarray) -> np.ndarray:
        """sw-kTLS egress: the encrypt-and-copy pass that re-touches the
        gathered payload (paper §B.1)."""
        self.stats["sw_encrypt_passes"] += 1
        return xor_tokens(payload, self.tx_payload_keystream(
            seq, inner_meta_len, len(payload)))

    def tx_encrypt_span(self, chunk: np.ndarray, seq: int,
                        rec_pos: int) -> np.ndarray:
        """Encrypt a full-copy TX span that starts at record position
        ``rec_pos`` (0 = REC_MAGIC): header tokens pass through, everything
        at positions >= REC_HEADER gets the TX keystream. Used by the
        fallback/bypass egress paths, including budget-truncated resumes."""
        return self._crypt_span(self.tx_key, chunk, seq, rec_pos)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TlsSession(mode={self.mode!r})"
