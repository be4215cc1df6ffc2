"""Programmable metadata parsers — the eBPF RX-Prog/TX-Prog analogue (§2.5 S1).

The framework supplies the *mechanism* (selective copy + anchoring); users
supply the *policy*: a parser that, given a bounded lookahead window over the
incoming stream, locates the metadata boundary and the payload length.

Parsers are restricted the way eBPF programs are:
  * bounded lookahead (default 256 tokens, configurable — the paper's
    256-byte window),
  * pure functions of (window, parser state) — no side effects,
  * deterministic O(N) scanning (KMP for delimiter search, as in the paper).

Each policy has a host form (numpy, drives the engine) and the same logic is
usable under tracing (jnp) for the in-step ``selective_copy`` kernel path.

Stream framing used by the proxy scenario (token-level mirror of HTTP):
  HTTP/1.0-like : [MAGIC, meta_len, payload_len, *meta] [*payload]
  chunked       : header, then repeated [CHUNK_MAGIC, chunk_len] [*chunk], 0-len ends
  delimiter     : metadata terminated by a delimiter motif (CRLFCRLF analogue)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

MAGIC = 17          # start-of-message marker token
CHUNK_MAGIC = 19    # chunk header marker
DELIM = (13, 10, 13, 10)  # CRLF CRLF motif, token-level
DEFAULT_LOOKAHEAD = 256


@dataclasses.dataclass(frozen=True)
class ParseResult:
    ok: bool
    meta_len: int = 0        # metadata tokens (copied to user space)
    payload_len: int = 0     # opaque payload tokens (anchored)
    consumed: int = 0        # window tokens consumed by this parse
    need_more: bool = False  # window too small — wait for more data


class ParserPolicy(Protocol):
    name: str
    lookahead: int

    def parse(self, window: np.ndarray) -> ParseResult: ...


def kmp_table(pattern: Sequence[int]) -> List[int]:
    """Knuth–Morris–Pratt failure function (the paper's metadata scanner)."""
    t = [0] * len(pattern)
    k = 0
    for i in range(1, len(pattern)):
        while k > 0 and pattern[i] != pattern[k]:
            k = t[k - 1]
        if pattern[i] == pattern[k]:
            k += 1
        t[i] = k
    return t


def kmp_find(hay: np.ndarray, pattern: Sequence[int]) -> int:
    """First index of ``pattern`` in ``hay`` or -1. Deterministic O(N+M)."""
    t = kmp_table(pattern)
    k = 0
    for i in range(len(hay)):
        while k > 0 and hay[i] != pattern[k]:
            k = t[k - 1]
        if hay[i] == pattern[k]:
            k += 1
            if k == len(pattern):
                return i - k + 1
    return -1


@dataclasses.dataclass
class LengthPrefixedParser:
    """HTTP/1.0-like: fixed 3-token header [MAGIC, meta_len, payload_len]
    followed by ``meta_len`` metadata tokens, then the opaque payload."""

    name: str = "length-prefixed"
    lookahead: int = DEFAULT_LOOKAHEAD

    def parse(self, window: np.ndarray) -> ParseResult:
        if len(window) < 3:
            return ParseResult(False, need_more=True)
        if int(window[0]) != MAGIC:
            return ParseResult(False)
        meta_len = int(window[1])
        payload_len = int(window[2])
        if meta_len < 0 or payload_len < 0 or 3 + meta_len > self.lookahead:
            return ParseResult(False)
        if len(window) < 3 + meta_len:
            return ParseResult(False, need_more=True)
        return ParseResult(True, meta_len=3 + meta_len, payload_len=payload_len,
                           consumed=3 + meta_len)


@dataclasses.dataclass
class DelimiterParser:
    """HTTP-header-like: metadata runs until the DELIM motif; the payload
    length is encoded right after the delimiter (content-length analogue)."""

    name: str = "delimiter"
    lookahead: int = DEFAULT_LOOKAHEAD
    delim: Tuple[int, ...] = DELIM

    def parse(self, window: np.ndarray) -> ParseResult:
        idx = kmp_find(window[: self.lookahead], self.delim)
        if idx < 0:
            need = len(window) < self.lookahead
            return ParseResult(False, need_more=need)
        end = idx + len(self.delim)
        if len(window) < end + 1:
            return ParseResult(False, need_more=True)
        payload_len = int(window[end])
        if payload_len < 0:
            # corrupt/hostile content-length: a negative value would flow
            # into the RX machine as a negative skip_payload and rewind the
            # ring (re-delivering stream bytes) — unparseable, full copy
            return ParseResult(False)
        return ParseResult(True, meta_len=end + 1, payload_len=payload_len,
                           consumed=end + 1)


@dataclasses.dataclass
class ChunkedParser:
    """HTTP/1.1 chunked transfer: repeated [CHUNK_MAGIC, len] chunk headers;
    a zero-length chunk terminates the message (§2.4 Table 2)."""

    name: str = "chunked"
    lookahead: int = DEFAULT_LOOKAHEAD

    def parse(self, window: np.ndarray) -> ParseResult:
        if len(window) < 2:
            return ParseResult(False, need_more=True)
        if int(window[0]) != CHUNK_MAGIC:
            return ParseResult(False)
        clen = int(window[1])
        if clen < 0:
            # hostile chunk length: same negative-rewind hazard as the
            # delimiter parser — reject instead of passing it downstream
            return ParseResult(False)
        return ParseResult(True, meta_len=2, payload_len=clen, consumed=2)


@dataclasses.dataclass
class TokenStreamParser:
    """LLM-serving policy: the 'header' is the routing prefix of a request
    (system prompt / route tag of ``header_len`` tokens); everything after
    is opaque payload context. This is the policy the serving engine uses:
    header tokens surface to the router, payload KV is anchored."""

    header_len: int
    name: str = "token-stream"
    lookahead: int = DEFAULT_LOOKAHEAD

    def parse(self, window: np.ndarray) -> ParseResult:
        if len(window) < self.header_len:
            return ParseResult(False, need_more=True)
        return ParseResult(True, meta_len=self.header_len,
                           payload_len=-1,  # runs to end of request
                           consumed=self.header_len)


BUILTIN_PARSERS = {
    "length-prefixed": LengthPrefixedParser,
    "delimiter": DelimiterParser,
    "chunked": ChunkedParser,
}


def build_message(meta: np.ndarray, payload: np.ndarray) -> np.ndarray:
    """Encode a length-prefixed message (test/benchmark helper)."""
    hdr = np.array([MAGIC, len(meta), len(payload)], np.int64)
    return np.concatenate([hdr, meta.astype(np.int64), payload.astype(np.int64)])


def build_delimited_message(meta: np.ndarray, payload: np.ndarray) -> np.ndarray:
    hdr = np.concatenate([meta.astype(np.int64), np.array(DELIM, np.int64),
                          np.array([len(payload)], np.int64)])
    return np.concatenate([hdr, payload.astype(np.int64)])


def build_chunked_message(chunks: Sequence[np.ndarray]) -> np.ndarray:
    parts = []
    for c in chunks:
        parts.append(np.array([CHUNK_MAGIC, len(c)], np.int64))
        parts.append(c.astype(np.int64))
    parts.append(np.array([CHUNK_MAGIC, 0], np.int64))
    return np.concatenate(parts)
