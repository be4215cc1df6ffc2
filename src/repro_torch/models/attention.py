"""Attention paths of serving and training, on one device.

PyTorch twins of the JAX package's ``repro.models.attention``, with no mesh
and no ``shard_map``: one device plays shard ``SHARD`` (0) of the
flash-decode layout, as the JAX package's one-device mesh does, so the
combine across chips reduces to ``acc / max(l, 1e-30)``. With the engine's
one-shard stack that device owns every page; under a stack of more shards
the pages of the others are neither written nor read, as in JAX.

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

The K/V writes stay plain PyTorch (a masked ``index_put_``, the
counterpart of ``.at[].set(mode="drop")``), as the JAX package does them
outside any kernel. The pool is updated in place; JAX donates it instead.
Every placement arrives as int32 metadata from the control plane
(the Libra mechanism / policy split).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30
#: the shard of the block tables whose pages this device holds
SHARD = 0

#: (batch rows, page ids, in-page offsets) of the K/V a write lands on
WriteIndex = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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
    in place, so autograd differentiates it."""
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
    window); 0 is global attention."""
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
    ``window`` is a Python int (the tile list is fixed per call)."""
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
    is the JAX package's on either of its branches."""
    pad = blockwise_kv_pad(q.shape[1], k.shape[1])
    k, v = (torch.nn.functional.pad(t.transpose(1, 2), (0, 0, 0, pad))
            .contiguous() for t in (k, v))
    out = ops.flash_attention(q.transpose(1, 2).contiguous(), k, v,
                              causal=False, impl=impl)
    return out.transpose(1, 2)


def decode_write_index(block_tables: torch.Tensor, page_pos: torch.Tensor,
                       seq_lens: torch.Tensor, write_shard: torch.Tensor,
                       write_slot: torch.Tensor, page_size: int) -> WriteIndex:
    """Where each incoming decode token's K/V lands: the rows whose write
    page is on ``SHARD``, exists and covers ``seq_lens``; the JAX package
    drops the others (``mode="drop"``). The same for every layer of a
    step, so a step computes it once."""
    b = seq_lens.shape[0]
    rows = torch.arange(b, device=seq_lens.device)
    slot = write_slot.long()[:, None]
    pid = block_tables[rows, write_shard.long()].gather(1, slot)[:, 0]
    base = page_pos[rows, write_shard.long()].gather(1, slot)[:, 0]
    off = seq_lens - base
    ok = (write_shard == SHARD) & (pid >= 0) & (off >= 0) & (off < page_size)
    keep = ok.nonzero().squeeze(1)
    return keep, pid[keep].long(), off[keep].long()


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
) -> torch.Tensor:
    """Write the new token's KV into its anchored page (in place), then
    attend over all anchored pages. Returns attn_out [B, Hq, hd].
    ``window > 0`` keeps only keys with ``seq_lens - pos < window`` (the
    reference's sliding window); 0 is global attention. ``write_index`` is
    :func:`decode_write_index` of these arguments, computed here when not
    given."""
    if write_index is None:
        write_index = decode_write_index(block_tables, page_pos, seq_lens,
                                         write_shard, write_slot,
                                         pool.shape[1])
    rows, pid, off = write_index
    kv = torch.stack([k_new, v_new], dim=1).to(pool.dtype)  # [B, 2, Hkv, hd]
    pool.index_put_((pid, off), kv[rows])
    acc, _m, l = ops.paged_attention(
        q.contiguous(), pool, block_tables[:, SHARD].contiguous(),
        page_pos[:, SHARD].contiguous(), seq_lens, window=window, impl=impl)
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def prefill_write_index(block_tables: torch.Tensor, token_shard: torch.Tensor,
                        token_slot: torch.Tensor, token_off: torch.Tensor,
                        token_valid: torch.Tensor) -> WriteIndex:
    """Where each prompt token's K/V lands, as flat ``b * S + s`` token
    rows: the valid tokens whose page is on ``SHARD`` and exists."""
    b, s = token_shard.shape
    rows = torch.arange(b, device=token_shard.device)[:, None]
    pid = block_tables[rows, token_shard.long()].gather(
        2, token_slot.long()[..., None])[..., 0]              # [B, S]
    ok = (token_shard == SHARD) & token_valid & (pid >= 0)
    keep = ok.reshape(-1).nonzero().squeeze(1)
    return keep, pid.reshape(-1)[keep].long(), \
        token_off.reshape(-1)[keep].long()


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
) -> torch.Tensor:
    """Anchor a full prompt's KV into its pages (ingress path), in place.
    ``write_index`` is :func:`prefill_write_index` of these arguments,
    computed here when not given. Returns ``pool``."""
    if write_index is None:
        write_index = prefill_write_index(block_tables, token_shard,
                                          token_slot, token_off, token_valid)
    rows, pid, off = write_index
    b, s, hkv, hd = k.shape
    kv = torch.stack([k, v], dim=2).to(pool.dtype).reshape(b * s, 2, hkv, hd)
    pool.index_put_((pid, off), kv[rows])
    return pool
