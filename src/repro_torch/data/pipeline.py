"""Host data pipeline: synthetic corpus + deterministic, resumable iterator.

A copy of the JAX package's ``repro.data.pipeline``, which is numpy and
Python only: the port keeps its own, and its batches are byte-for-byte
the reference's for the same corpus seed and state.

The pipeline mirrors the Libra ingress split at the data layer: per example
it stages a small *metadata* record (lengths, shard/offset, routing tag —
what the trainer's control plane inspects) separately from the bulk token
payload, and the payload buffers are reused in place across batches (no
per-batch reallocation). Iterator state (shard, position, epoch, rng) is
tiny and rides inside checkpoints for exact resume.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    shard: int
    position: int
    epoch: int
    seed: int

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PipelineState":
        return cls(**d)


class SyntheticCorpus:
    """Deterministic pseudo-corpus: shard s, document d reproducible from
    (seed, s, d) — stands in for a tokenized dataset on disk."""

    def __init__(self, vocab_size: int, num_shards: int = 16,
                 docs_per_shard: int = 1024, seed: int = 0):
        self.vocab_size = vocab_size
        self.num_shards = num_shards
        self.docs_per_shard = docs_per_shard
        self.seed = seed

    def doc(self, shard: int, idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + shard) * 1_000_003 + idx)
        n = int(rng.integers(64, 512))
        # mildly structured stream (zipf-ish) so loss actually decreases
        toks = rng.zipf(1.5, n) % (self.vocab_size - 2) + 1
        return toks.astype(np.int32)


class DataPipeline:
    def __init__(self, corpus: SyntheticCorpus, batch: int, seq_len: int,
                 state: Optional[PipelineState] = None, pad_id: int = 0):
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.state = state or PipelineState(0, 0, 0, corpus.seed)
        # payload buffers reused across batches (anchored, never reallocated)
        self._tokens = np.zeros((batch, seq_len), np.int32)
        self._labels = np.zeros((batch, seq_len), np.int32)

    def _next_doc(self) -> np.ndarray:
        s = self.state
        doc = self.corpus.doc(s.shard, s.position)
        s.position += 1
        if s.position >= self.corpus.docs_per_shard:
            s.position = 0
            s.shard += 1
            if s.shard >= self.corpus.num_shards:
                s.shard = 0
                s.epoch += 1
        return doc

    def next_batch(self) -> Dict[str, np.ndarray]:
        self._tokens.fill(self.pad_id)
        self._labels.fill(-1)
        meta = []
        for i in range(self.batch):
            doc = self._next_doc()
            n = min(len(doc) - 1, self.seq_len)
            self._tokens[i, :n] = doc[:n]
            self._labels[i, :n] = doc[1 : n + 1]
            meta.append((n, self.state.shard, self.state.position))
        return {
            "tokens": self._tokens,
            "labels": self._labels,
            # control-plane metadata record (lengths/provenance) — the only
            # part the trainer's host logic ever inspects
            "meta": np.array(meta, np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
