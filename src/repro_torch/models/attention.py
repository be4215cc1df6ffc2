"""Attention paths of the serving slice, on one device.

PyTorch twins of the JAX package's ``repro.models.attention``, with no mesh
and no ``shard_map``: one device plays shard ``SHARD`` (0) of the
flash-decode layout, as the JAX package's one-device mesh does, so the
combine across chips reduces to ``acc / max(l, 1e-30)``. With the engine's
one-shard stack that device owns every page; under a stack of more shards
the pages of the others are neither written nor read, as in JAX.

* ``dense_attention`` — the plain reference path the tests hold the
  kernels against.
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
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30
#: the shard of the block tables whose pages this device holds
SHARD = 0

#: (batch rows, page ids, in-page offsets) of the K/V a write lands on
WriteIndex = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention. q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd]."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(hd))).reshape(b, sq, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)       # [B,Hkv,G,Sq,Skv]
    dq = pos_q[:, :, None]
    dk = pos_kv[:, None, :]
    ok = torch.ones((b, sq, pos_kv.shape[1]), dtype=torch.bool,
                    device=q.device)
    if causal:
        ok = ok & (dq >= dk)
    if window > 0:
        ok = ok & (dq - dk < window)
    scores = scores + torch.where(ok, 0.0, NEG_INF)[:, None, None]
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
    return -skv % min(BLOCKWISE_KV_CHUNK, skv)


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
