"""Attention paths of serving and training.

PyTorch twins of the JAX package's ``repro.models.attention``. Without a
mesh one device plays shard ``SHARD`` (0) of the flash-decode layout, as
the JAX package's one-device mesh does, so the combine across devices
reduces to ``acc / max(l, 1e-30)``. With the engine's one-shard stack that
device owns every page; under a stack of more shards the pages of the
others are neither written nor read, as in JAX.

With a ``mesh`` (a ``DeviceMesh``; :func:`plan_decode_sharding` picks the
batch axis and the combine axes) each rank is shard
:func:`combined_axis_index` of the combine axes: it writes and reads only
the pages its shard of the pool holds, ``ops.paged_attention`` gives its
partial ``(acc, m, l)``, and the partials are combined by an all-reduce of
``m`` (max) and then of ``l * exp(m - m_max)`` and ``acc * exp(m - m_max)``
(sum) over the combine axes: flash-decode, the reference's ``shard_map``
body. The inputs are either DTensors (sharded as the reference's
``in_specs``: batch over the batch axis, pages over every axis), which the
region unwraps with ``local_map``, or already this rank's local shards.

* ``dense_attention`` — the plain reference path the tests hold the
  kernels against, and training's attention up to 1024 positions.
* ``blockwise_attention`` — training's attention above 1024 positions:
  online softmax over tiles of 512 with a backward of its own that
  recomputes each tile from the saved log-sum-exp (the reference's
  ``custom_vjp``); ``dense_or_blockwise`` picks between the two as the
  reference's models do.
* ``prefill_attention`` — prefill: causal GQA attention at positions
  ``arange(S)``, optionally over a sliding window, through
  ``ops.flash_attention`` (the JAX package computes the same function
  with ``dense_attention`` / ``blockwise_attention``).
* ``noncausal_attention`` — the encoder-decoder's encoder self-attention
  and cross-attention: every query over every key, ``Sq`` and ``Skv``
  free, through ``ops.flash_attention(causal=False)``, with the zero keys
  the JAX package's blockwise branch adds (:func:`blockwise_kv_pad`).
* ``paged_decode_attention`` — the Libra fast path: write the incoming
  token's K/V into its anchored page, then attend over the anchored pages
  (optionally over a sliding window) in place through
  ``ops.paged_attention``.
* ``prefill_write_pages`` — anchor a prompt's K/V into its pages.

The K/V writes stay plain PyTorch (one ``index_put_`` of fixed shape,
:class:`WriteIndex`, the counterpart of ``.at[].set(mode="drop")``), as
the JAX package does them outside any kernel. The pool is updated in place; JAX donates it instead.
Every placement arrives as int32 metadata from the control plane
(the Libra mechanism / policy split).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.common.sharding import (
    all_reduce,
    axis_index,
    contiguous_grad,
    is_distributed,
    mesh_axis_names,
    mesh_axis_sizes,
    placements_for,
)
from repro_torch.kernels import ops

NEG_INF = -1e30
#: the shard of the block tables whose pages this device holds
SHARD = 0



def _gqa_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qg [B, Sq, Hkv, G, hd], k [B, Skv, Hkv, hd] -> float32 scores
    [B, Hkv, G, Sq, Skv]. The operands are widened to float32 first, so
    that bfloat16 inputs give exact products summed in float32 (the
    reference's ``preferred_element_type=float32``)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def _mask_bias(pos_q: torch.Tensor, pos_kv: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """pos_q [B, Sq], pos_kv [B, Skv] -> float32 additive bias
    [B, 1, 1, Sq, Skv]: 0 where a key is kept (by causality and the window
    only), ``NEG_INF`` elsewhere."""
    dq = pos_q[:, :, None]
    dk = pos_kv[:, None, :]
    ok = torch.ones((dq.shape[0], dq.shape[1], dk.shape[2]),
                    dtype=torch.bool, device=pos_q.device)
    if causal:
        ok = ok & (dq >= dk)
    if window > 0:
        ok = ok & (dq - dk < window)
    return torch.where(ok, 0.0, NEG_INF)[:, None, None]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention. q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd]. The scores
    and the softmax are float32; the probabilities are cast to ``v``'s
    dtype for the second product, as in the reference. Nothing is written
    in place, so autograd differentiates it. DTensor inputs run per rank
    on their local batch and heads (:func:`head_parallel`)."""
    if is_distributed(q):
        rows = (pos_q, pos_kv) + ((kv_valid,) if kv_valid is not None else ())
        return head_parallel(
            lambda a, b, c, pq, pk, *kvv: dense_attention(
                a, b, c, pq, pk, causal=causal, window=window,
                kv_valid=kvv[0] if kvv else None), q, k, v, *rows)
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(hd))).reshape(b, sq, hkv, g, hd)
    scores = _gqa_scores(qg, k)                             # [B,Hkv,G,Sq,Skv]
    scores = scores + _mask_bias(pos_q, pos_kv, causal, window)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, impl: str = "auto") -> torch.Tensor:
    """Causal attention of a prompt at positions ``arange(S)``:
    q [B,S,Hq,hd], k/v [B,S,Hkv,hd] -> [B,S,Hq,hd], through
    ``ops.flash_attention`` on the ``[B, H, S, hd]`` layout. ``window > 0``
    keeps only keys with ``iq - ik < window`` (the reference's sliding
    window); 0 is global attention. DTensor inputs run per rank on their
    local batch and heads (:func:`head_parallel`)."""
    if is_distributed(q):
        return head_parallel(lambda a, b, c: prefill_attention(
            a, b, c, window=window, impl=impl), q, k, v)
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(),
                              causal=True, window=window, impl=impl)
    return out.transpose(1, 2)


#: the JAX package's encoder-decoder attends with ``blockwise_attention``
#: above this many queries or keys, with ``dense_attention`` up to it
#: (``repro/models/encdec.py:109-112``, 274-279)
BLOCKWISE_ABOVE = 1024
#: ``blockwise_attention``'s default key chunk
BLOCKWISE_KV_CHUNK = 512


def blockwise_kv_pad(sq: int, skv: int) -> int:
    """Zero key rows the JAX package's non-causal attention of ``sq``
    queries over ``skv`` keys attends to beyond the real ones.

    Above :data:`BLOCKWISE_ABOVE` it takes ``blockwise_attention``, whose
    ``_blockwise_fwd_impl`` pads K/V with zero rows up to a multiple of
    its key chunk, ``min(512, Skv)``, and gives them position ``2**30``
    (``repro/models/attention.py:150-158``). Its mask (``_mask_bias``)
    keeps a key by causality and window only, so a non-causal call keeps
    the padded keys: each adds ``exp(0 - m)`` to the softmax denominator
    and nothing to the numerator (a fault of the reference, carried; at
    whisper's 1500 frames 36 such keys of 1536). A causal call masks them
    at ``2**30``, so this is for non-causal calls only."""
    if max(sq, skv) <= BLOCKWISE_ABOVE:
        return 0
    return _chunk_pad(skv, BLOCKWISE_KV_CHUNK)


def _chunk_pad(n: int, chunk: int) -> int:
    """Rows :func:`blockwise_attention` adds to ``n`` rows to reach a
    multiple of its chunk, ``min(chunk, n)``."""
    return -n % min(chunk, n)


def _block_pairs(nq: int, nkv: int, causal: bool, window_blocks: int):
    """The (q chunk, kv block) pairs that can hold unmasked entries, in the
    reference's order (q chunk major): causal attention visits
    n(n+1)/2 tiles and windowed attention only its band."""
    pairs = []
    for i in range(nq):
        for j in range(nkv):
            if causal and j > i:
                continue
            if window_blocks > 0 and j < i - window_blocks:
                continue
            pairs.append((i, j))
    return pairs


def _pad_rows(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``x`` with ``n`` rows of ``fill`` appended along dim 1."""
    if not n:
        return x
    pad = x.new_full((x.shape[0], n) + tuple(x.shape[2:]), fill)
    return torch.cat([x, pad], dim=1)


class _Tiles(NamedTuple):
    """The tile grid of one blockwise call: chunk sizes, the rows padded
    onto Q, the (q chunk, kv block) pairs in the reference's order, and
    the inputs padded to whole chunks (pad queries at position
    ``-2**30``, pad keys zero at ``2**30``); ``qg`` is the scaled queries
    in groups, ``[B, Sq_p, Hkv, G, hd]``."""
    qc: int
    kc: int
    pad_q: int
    pairs: List[Tuple[int, int]]
    qg: torch.Tensor
    kp: torch.Tensor
    vp: torch.Tensor
    pos_q: torch.Tensor
    pos_kv: torch.Tensor

    def scores(self, qs: slice, ks: slice, causal: bool, window: int
               ) -> torch.Tensor:
        """Float32 masked scores of one tile, ``[B, Hkv, G, cq, ck]``."""
        return (_gqa_scores(self.qg[:, qs], self.kp[:, ks])
                + _mask_bias(self.pos_q[:, qs], self.pos_kv[:, ks], causal,
                             window))


def _tiles(q, k, v, pos_q, pos_kv, causal: bool, window: int, q_chunk: int,
           kv_chunk: int) -> _Tiles:
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    pad_q, pad_kv = _chunk_pad(sq, qc), _chunk_pad(skv, kc)
    qg = (_pad_rows(q, pad_q) * (1.0 / math.sqrt(hd))).reshape(
        b, sq + pad_q, hkv, hq // hkv, hd)
    wblocks = -(-window // kc) + 1 if window > 0 else 0
    pairs = _block_pairs((sq + pad_q) // qc, (skv + pad_kv) // kc, causal,
                         wblocks)
    return _Tiles(qc, kc, pad_q, pairs, qg, _pad_rows(k, pad_kv),
                  _pad_rows(v, pad_kv), _pad_rows(pos_q, pad_q, -(2 ** 30)),
                  _pad_rows(pos_kv, pad_kv, 2 ** 30))


class _Blockwise(torch.autograd.Function):
    """Online-softmax attention over (q chunk x kv block) tiles, never
    materialising ``[Sq, Skv]``, with a flash-attention backward: the
    forward saves only its inputs, its output and the row log-sum-exp
    ``lse``, and the backward recomputes each tile's scores from
    ``(q, k, lse)``. The counterpart of the reference's ``custom_vjp``
    (``_blockwise_fwd_impl`` / ``_blockwise_bwd``), tile for tile and in
    its order; its ``lax.scan`` over the tile list is a Python loop here.
    Plain PyTorch: the reference's is jnp, with no kernel behind it."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_kv, causal: bool, window: int,
                q_chunk: int, kv_chunk: int):
        t = _tiles(q, k, v, pos_q, pos_kv, causal, window, q_chunk, kv_chunk)
        b, sq_p, hkv, g, hd = t.qg.shape
        nq = sq_p // t.qc
        f32 = dict(dtype=torch.float32, device=q.device)
        m = [torch.full((b, hkv, g, t.qc), NEG_INF, **f32) for _ in range(nq)]
        l = [torch.zeros((b, hkv, g, t.qc), **f32) for _ in range(nq)]
        acc = [torch.zeros((b, hkv, g, t.qc, hd), **f32) for _ in range(nq)]
        for i, j in t.pairs:
            qs = slice(i * t.qc, (i + 1) * t.qc)
            ks = slice(j * t.kc, (j + 1) * t.kc)
            vb = t.vp[:, ks]
            s = t.scores(qs, ks, causal, window)
            m_new = torch.maximum(m[i], s.amax(dim=-1))
            alpha = torch.exp(m[i] - m_new)
            p = torch.exp(s - m_new[..., None])
            l[i] = l[i] * alpha + p.sum(dim=-1)
            acc[i] = acc[i] * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).float()
            m[i] = m_new
        m, l, acc = (torch.cat(x, dim=3) for x in (m, l, acc))
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_p, hkv * g, hd)
        out = out[:, :q.shape[1]].to(q.dtype)
        lse = m + torch.log(torch.clamp(l, min=1e-30))      # [B,Hkv,G,Sq_p]
        ctx.save_for_backward(q, k, v, pos_q, pos_kv, out, lse)
        ctx.cfg = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos_q, pos_kv, out, lse = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk = ctx.cfg
        t = _tiles(q, k, v, pos_q, pos_kv, causal, window, q_chunk, kv_chunk)
        b, sq_p, hkv, g, hd = t.qg.shape
        scale = 1.0 / math.sqrt(hd)
        dog = _pad_rows(dout, t.pad_q).reshape(t.qg.shape)
        og = _pad_rows(out, t.pad_q).reshape(t.qg.shape)
        # D_i = rowsum(dout * out)
        delta = (dog.float() * og.float()).sum(dim=-1).permute(0, 2, 3, 1)
        dq = torch.zeros((b, sq_p, hkv * g, hd), dtype=torch.float32,
                         device=q.device)
        dk = torch.zeros(t.kp.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for i, j in t.pairs:
            qs = slice(i * t.qc, (i + 1) * t.qc)
            ks = slice(j * t.kc, (j + 1) * t.kc)
            qb, dob = t.qg[:, qs], dog[:, qs].float()
            kb, vb = t.kp[:, ks].float(), t.vp[:, ks].float()
            p = torch.exp(t.scores(qs, ks, causal, window)
                          - lse[..., qs, None])               # [B,H,G,cq,ck]
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
            ds = p * (dp - delta[..., qs, None])
            dq[:, qs] += (torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
                          * scale).reshape(b, t.qc, hkv * g, hd)
            dk[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb.float())
            dv[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
        sq, skv = q.shape[1], k.shape[1]
        return (dq[:, :sq].to(q.dtype), dk[:, :skv].to(k.dtype),
                dv[:, :skv].to(v.dtype), None, None, None, None, None, None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512
                        ) -> torch.Tensor:
    """Memory-efficient attention, q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd] ->
    [B,Sq,Hq,hd], differentiable through its own backward
    (:class:`_Blockwise`). Q and K/V are padded to whole chunks, the keys
    with zero rows at position ``2**30``, as in the reference; a
    non-causal call keeps those keys (F5, :func:`blockwise_kv_pad`).
    ``window`` is a Python int (the tile list is fixed per call). DTensor
    inputs run per rank on their local batch and heads
    (:func:`head_parallel`)."""
    if is_distributed(q):
        return head_parallel(
            lambda a, b, c, pq, pk: blockwise_attention(
                a, b, c, pq, pk, causal=causal, window=window,
                q_chunk=q_chunk, kv_chunk=kv_chunk), q, k, v, pos_q, pos_kv)
    return _Blockwise.apply(q, k, v, pos_q, pos_kv, causal, int(window),
                            q_chunk, kv_chunk)


def dense_or_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                       causal: bool, window: int = 0) -> torch.Tensor:
    """The reference models' training attention: :func:`dense_attention`
    up to :data:`BLOCKWISE_ABOVE` queries and keys, and
    :func:`blockwise_attention` above (``transformer.py:165-171``,
    ``encdec.py:109-112``). Neither reaches a kernel: the CUDA kernels of
    ``ops`` are forward only."""
    if max(q.shape[1], k.shape[1]) <= BLOCKWISE_ABOVE:
        return dense_attention(q, k, v, pos_q, pos_kv, causal=causal,
                               window=window)
    return blockwise_attention(q, k, v, pos_q, pos_kv, causal=causal,
                               window=window)


def noncausal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, impl: str = "auto") -> torch.Tensor:
    """Every query over every key: q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd] ->
    [B,Sq,Hq,hd], through ``ops.flash_attention(causal=False)`` on the
    ``[B, H, S, hd]`` layout, where the JAX package takes
    ``dense_attention`` / ``blockwise_attention``. The keys are first
    padded with :func:`blockwise_kv_pad`'s zero rows, so that the function
    is the JAX package's on either of its branches. DTensor inputs run
    per rank on their local batch and heads (:func:`head_parallel`)."""
    if is_distributed(q):
        return head_parallel(lambda a, b, c: noncausal_attention(
            a, b, c, impl=impl), q, k, v)
    pad = blockwise_kv_pad(q.shape[1], k.shape[1])
    k, v = (torch.nn.functional.pad(t.transpose(1, 2), (0, 0, 0, pad))
            .contiguous() for t in (k, v))
    out = ops.flash_attention(q.transpose(1, 2).contiguous(), k, v,
                              causal=False, impl=impl)
    return out.transpose(1, 2)


class WriteIndex(NamedTuple):
    """Where the rows of a K/V write land, in fixed shapes (no host sync):
    for every ``i``, row ``src[i]`` of the K/V goes to slot
    ``(pid[i], off[i])`` of the pool; nothing is written when ``kept`` is
    false. Made by :func:`_write_index`, applied by :func:`write_rows`."""
    src: torch.Tensor   # [N] int64
    pid: torch.Tensor   # [N] int64
    off: torch.Tensor   # [N] int64
    kept: torch.Tensor  # [] bool: some row is written


def _write_index(ok: torch.Tensor, pid: torch.Tensor,
                 off: torch.Tensor) -> WriteIndex:
    """Rows ``ok`` keeps go to ``(pid, off)``; the JAX package drops the
    others (``.at[].set(mode="drop")``), which has no fixed-shape
    counterpart in PyTorch. Here a dropped row writes the first kept row's
    value into that row's slot once more, so that every slot written
    receives a single value; when no row is kept, every row goes to slot
    ``(0, 0)`` and :func:`write_rows` writes back what that slot holds."""
    kept = ok.any()
    first = ok.to(torch.int32).argmax()            # 0 when no row is kept
    src = torch.where(ok, torch.arange(ok.shape[0], device=ok.device), first)
    zero = torch.zeros((), dtype=torch.long, device=ok.device)
    return WriteIndex(src, torch.where(kept, pid.long()[src], zero),
                      torch.where(kept, off.long()[src], zero), kept)


def write_rows(pool: torch.Tensor, index: WriteIndex,
               kv: torch.Tensor) -> None:
    """``pool[pid[i], off[i]] = kv[src[i]]`` in place, for every ``i`` of
    ``index`` (:class:`WriteIndex`): one static ``index_put_``."""
    vals = kv[index.src].to(pool.dtype)
    pool.index_put_((index.pid, index.off),
                    torch.where(index.kept, vals, pool[0, 0]))


def _local_rows(mesh, batch_axis, *ts) -> tuple:
    """``ts`` as this rank's rows: a DTensor placed batch over
    ``batch_axis`` (as the mesh regions take it) and taken local; a plain
    tensor, or any tensor without a mesh, unchanged."""
    if mesh is None:
        return ts
    bpl = batch_placements(mesh, batch_axis)
    return tuple(t.redistribute(mesh, bpl).to_local() if is_distributed(t)
                 else t for t in ts)


def _own_shard(mesh, combine_axes: Sequence[str]) -> int:
    """The shard of the block tables whose pages this device holds:
    :data:`SHARD` without a mesh, else this rank's index among
    ``combine_axes`` (:func:`combined_axis_index`)."""
    if mesh is None:
        return SHARD
    return combined_axis_index(mesh, tuple(combine_axes))


def decode_write_index(block_tables: torch.Tensor, page_pos: torch.Tensor,
                       seq_lens: torch.Tensor, write_shard: torch.Tensor,
                       write_slot: torch.Tensor, page_size: int, *,
                       mesh=None, batch_axis=None,
                       combine_axes: Sequence[str] = ()) -> WriteIndex:
    """Where each incoming decode token's K/V lands: the rows whose write
    page is on this device's shard (:func:`_own_shard`), exists and covers
    ``seq_lens``; the JAX package drops the others (``mode="drop"``). With
    a ``mesh``, over this rank's rows of the batch. The same for every
    layer of a step, so a step computes it once."""
    block_tables, page_pos, seq_lens, write_shard, write_slot = _local_rows(
        mesh, batch_axis, block_tables, page_pos, seq_lens, write_shard,
        write_slot)
    b = seq_lens.shape[0]
    rows = torch.arange(b, device=seq_lens.device)
    slot = write_slot.long()[:, None]
    pid = block_tables[rows, write_shard.long()].gather(1, slot)[:, 0]
    base = page_pos[rows, write_shard.long()].gather(1, slot)[:, 0]
    off = seq_lens - base
    ok = ((write_shard == _own_shard(mesh, combine_axes)) & (pid >= 0)
          & (off >= 0) & (off < page_size))
    return _write_index(ok, pid, off)


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, hd]
    k_new: torch.Tensor,         # [B, Hkv, hd] current token's K
    v_new: torch.Tensor,         # [B, Hkv, hd]
    pool: torch.Tensor,          # [P, page, 2, Hkv, hd] one layer, in place
    block_tables: torch.Tensor,  # [B, n_shards, pps] page ids, -1 unused
    page_pos: torch.Tensor,      # [B, n_shards, pps] base position of a page
    seq_lens: torch.Tensor,      # [B] position of the incoming token
    write_shard: torch.Tensor,   # [B]
    write_slot: torch.Tensor,    # [B]
    *,
    window: int = 0,
    impl: str = "auto",
    write_index: Optional[WriteIndex] = None,
    mesh=None,
    batch_axis=None,
    combine_axes: Sequence[str] = (),
) -> torch.Tensor:
    """Write the new token's KV into its anchored page (in place), then
    attend over all anchored pages. Returns attn_out [B, Hq, hd].
    ``window > 0`` keeps only keys with ``seq_lens - pos < window`` (the
    reference's sliding window); 0 is global attention. ``write_index`` is
    :func:`decode_write_index` of these arguments (and mesh keywords),
    computed here when not given.

    With a ``mesh`` this rank holds shard :func:`combined_axis_index` of
    ``combine_axes`` of the pool's pages; the partial softmax of every
    shard is combined across them (flash-decode; see the module's
    docstring)."""
    combine_axes = tuple(combine_axes)
    if write_index is None:
        write_index = decode_write_index(
            block_tables, page_pos, seq_lens, write_shard, write_slot,
            pool.shape[1], mesh=mesh, batch_axis=batch_axis,
            combine_axes=combine_axes)

    def local(q, k_new, v_new, pool, tables, page_pos, seq_lens):
        shard = _own_shard(mesh, combine_axes)
        write_rows(pool, write_index, torch.stack([k_new, v_new], dim=1))
        acc, m, l = ops.paged_attention(
            q.contiguous(), pool, tables[:, shard].contiguous(),
            page_pos[:, shard].contiguous(), seq_lens, window=window,
            impl=impl)
        if combine_axes:
            m_g = all_reduce(m, "max", mesh, combine_axes)
            scale = torch.exp(m - m_g)
            l = all_reduce(l * scale, "sum", mesh, combine_axes)
            acc = all_reduce(acc * scale[..., None], "sum", mesh,
                             combine_axes)
        return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)

    args = (q, k_new, v_new, pool, block_tables, page_pos, seq_lens)
    if not is_distributed(pool):
        return local(*args)
    from torch.distributed.tensor.experimental import local_map

    bpl = batch_placements(mesh, batch_axis)
    return local_map(local, out_placements=list(bpl),
                     in_placements=(bpl, bpl, bpl, pool_placements(mesh))
                     + (bpl,) * 3,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def prefill_write_index(block_tables: torch.Tensor, token_shard: torch.Tensor,
                        token_slot: torch.Tensor, token_off: torch.Tensor,
                        token_valid: torch.Tensor, *, mesh=None,
                        batch_axis=None, combine_axes: Sequence[str] = ()
                        ) -> WriteIndex:
    """Where each prompt token's K/V lands, as flat ``b * S + s`` token
    rows: the valid tokens whose page is on this device's shard
    (:func:`_own_shard`) and exists. With a ``mesh``, over this rank's
    rows of the batch."""
    block_tables, token_shard, token_slot, token_off, token_valid = \
        _local_rows(mesh, batch_axis, block_tables, token_shard, token_slot,
                    token_off, token_valid)
    b, s = token_shard.shape
    rows = torch.arange(b, device=token_shard.device)[:, None]
    pid = block_tables[rows, token_shard.long()].gather(
        2, token_slot.long()[..., None])[..., 0]              # [B, S]
    ok = ((token_shard == _own_shard(mesh, combine_axes)) & token_valid
          & (pid >= 0))
    return _write_index(ok.reshape(-1), pid.reshape(-1),
                        token_off.reshape(-1))


def prefill_write_pages(
    k: torch.Tensor,             # [B, S, Hkv, hd]
    v: torch.Tensor,
    pool: torch.Tensor,          # [P, page, 2, Hkv, hd] one layer, in place
    block_tables: torch.Tensor,  # [B, n_shards, pps]
    token_shard: torch.Tensor,   # [B, S] owner shard per token
    token_slot: torch.Tensor,    # [B, S] table slot per token
    token_off: torch.Tensor,     # [B, S] in-page offset per token
    token_valid: torch.Tensor,   # [B, S] bool
    *,
    write_index: Optional[WriteIndex] = None,
    mesh=None,
    batch_axis=None,
    combine_axes: Sequence[str] = (),
) -> torch.Tensor:
    """Anchor a full prompt's KV into its pages (ingress path), in place.
    ``write_index`` is :func:`prefill_write_index` of these arguments (and
    mesh keywords), computed here when not given. Returns ``pool``. With a
    ``mesh`` each rank writes only the pages of its shard (shard
    :func:`combined_axis_index` of ``combine_axes``): no payload crosses
    devices."""
    if write_index is None:
        write_index = prefill_write_index(
            block_tables, token_shard, token_slot, token_off, token_valid,
            mesh=mesh, batch_axis=batch_axis, combine_axes=combine_axes)

    def local(k, v, pool):
        b, s, hkv, hd = k.shape
        write_rows(pool, write_index,
                   torch.stack([k, v], dim=2).reshape(b * s, 2, hkv, hd))
        return pool

    if not is_distributed(pool):
        return local(k, v, pool)
    from torch.distributed.tensor.experimental import local_map

    bpl = batch_placements(mesh, batch_axis)
    ppl = pool_placements(mesh)
    return local_map(local, out_placements=list(ppl),
                     in_placements=(bpl, bpl, ppl), device_mesh=mesh,
                     redistribute_inputs=True)(k, v, pool)


# ---------------------------------------------------------------------------
# the mesh: decode sharding plan, shard indices, head-parallel regions
# ---------------------------------------------------------------------------

def plan_decode_sharding(global_batch: int, mesh
                         ) -> Tuple[Optional[object], Tuple[str, ...]]:
    """Decide batch sharding axis + softmax combine axes for decode.

    Requests are sharded over the data axes when divisible; each request's
    pages stripe over the remaining (combine) axes and partial softmax
    stats are all-reduced — flash-decode. Tiny batches (long_500k)
    replicate the batch and stripe pages over every axis.
    """
    sizes = mesh_axis_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dsize = math.prod([sizes[a] for a in data_axes]) if data_axes else 1
    if data_axes and global_batch % dsize == 0:
        return (data_axes if len(data_axes) > 1 else data_axes[0],
                ("model",) if "model" in sizes else ())
    return None, tuple(mesh_axis_names(mesh))


def num_combine_shards(mesh, combine_axes: Tuple[str, ...]) -> int:
    sizes = mesh_axis_sizes(mesh)
    return math.prod([sizes[a] for a in combine_axes]) if combine_axes else 1


def combined_axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard among ``axes`` taken together, the first axis
    major (the reference's ``_combined_axis_index``)."""
    sizes = mesh_axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + axis_index(mesh, a)
    return idx


def batch_placements(mesh, batch_axis) -> tuple:
    """Placements of a tensor whose dim 0 is the batch, sharded over
    ``batch_axis`` (``None``, an axis or a tuple of axes) and replicated
    over the rest (the reference's ``P(batch_axis)``)."""
    return placements_for((batch_axis,), mesh)


def pool_placements(mesh) -> tuple:
    """Placements of one layer's pool ``[P, ...]``: pages over every axis
    (the reference's ``P(tuple(mesh.axis_names))``)."""
    return placements_for((tuple(mesh_axis_names(mesh)),), mesh)


def head_parallel(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` on each rank's local shards of DTensors q
    ``[B, Sq, Hq, hd]``, k/v ``[B, Skv, Hkv, hd]``: batch as q's dim 0 is
    sharded, heads over the axes q's dim 2 is sharded on (the
    ``act_heads`` constraint; a ``shard_map`` over batch and heads in the
    reference's terms). When ``Hkv`` does not divide among those ranks,
    k/v are gathered whole and each rank takes the KV heads its query
    heads read (their gradient is then partial over those axes).
    ``rows`` are per-batch-row tensors (positions), sharded like q's batch
    (a plain tensor is sliced to this rank's rows). Returns a DTensor
    placed as q."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    qpl = tuple(q.placements)
    if not all(p in (Shard(0), Shard(2), Replicate()) for p in qpl):
        raise ValueError(f"head_parallel: q placed {qpl}")
    names = mesh_axis_names(mesh)
    head_axes = tuple(a for a, p in zip(names, qpl) if p == Shard(2))
    batch_axes = tuple(a for a, p in zip(names, qpl) if p == Shard(0))
    n = num_combine_shards(mesh, head_axes)
    hq, hkv = q.shape[2], k.shape[2]
    kv_split = hkv % n == 0
    kvpl = qpl if kv_split else tuple(
        Replicate() if p == Shard(2) else p for p in qpl)
    kv_grad = kvpl if kv_split else tuple(
        Partial() if p == Shard(2) else p for p in qpl)
    rowpl = tuple(p if p == Shard(0) else Replicate() for p in qpl)
    nb = num_combine_shards(mesh, batch_axes)
    b0 = combined_axis_index(mesh, batch_axes) * (q.shape[0] // nb)
    rows = tuple(r if isinstance(r, DTensor) or not batch_axes
                 else r[b0:b0 + q.shape[0] // nb] for r in rows)

    def local(ql, kl, vl, *rl):
        ql, kl, vl = (contiguous_grad(t) for t in (ql, kl, vl))
        if head_axes and not kv_split:
            g = hq // hkv
            h0 = combined_axis_index(mesh, head_axes) * (hq // n)
            kvh = (h0 + torch.arange(hq // n, device=kl.device)) // g
            kl, vl = kl[:, :, kvh], vl[:, :, kvh]
        return fn(ql, kl, vl, *rl)

    dist_rows = tuple(isinstance(r, DTensor) for r in rows)
    # a single output's placements go as a list (a tuple lists outputs)
    return local_map(
        local, out_placements=list(qpl),
        in_placements=(qpl, kvpl, kvpl) + tuple(
            rowpl if d else None for d in dist_rows),
        in_grad_placements=(qpl, kv_grad, kv_grad) + tuple(
            rowpl if d else None for d in dist_rows),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, *rows)
