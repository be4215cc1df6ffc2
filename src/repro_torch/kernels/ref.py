"""Plain-PyTorch versions of the kernels (the contract).

Each function states the semantics its CUDA kernel in ``csrc/`` reproduces
and mirrors the jnp oracle of the same name in the JAX package line for
line. The CPU tests run these; ``chip_smoke.py`` compares each kernel with
them on the card. The four datapath kernels are int32 and bit-identical to
these; the two attention kernels are float32 and agree to rounding
(``atol = rtol = 1e-4``, the JAX package's bar), and so does the mLSTM
scan (``atol = rtol = 5e-4``, 3e-3 at gate extremes, as the JAX package's
tests hold its Pallas kernel). The MoE experts' grouped kernel has no
Pallas kernel and no jnp oracle (the JAX package's experts are einsums
over a capacity buffer): :func:`moe_experts_ref` states it, and the kernel
agrees to float32 rounding. The kTLS-analogue bench's two kernels
mirror the bench's formulas (``benchmarks/bench_ktls_analogue.py``; no
Pallas kernel): the dequantise pass bit for bit, its attention to
``1e-4``.

Differences of idiom from the jnp oracles of the datapath:

* indices are clamped explicitly before ``torch.gather`` / advanced
  indexing (``take_along_axis`` clamps for you);
* the pool update ``.at[flat].set(..., mode="drop")`` is a masked
  ``index_put_`` on ``pool.view(-1)`` **in place**: the returned pool is the
  tensor that was passed in (same ``data_ptr()``);
* floor division and modulo of negative payload-relative positions use
  ``torch.div(..., rounding_mode="floor")`` and ``torch.remainder`` (those
  lanes are masked, but their indices must stay in range).

Data stays int32 end to end; index tensors are int64.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

I32 = torch.int32
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, hd]`` over ``k``/``v [B, Hkv, Skv, hd]``
    at the implicit positions ``arange``: query head ``h`` reads KV head
    ``h // (Hq // Hkv)``. Masked scores are ``NEG_INF``; ``causal`` keeps
    ``iq >= ik``, ``window > 0`` keeps ``iq - ik < window``. Computed in
    float32, returned in the dtype of ``q``."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, sq, hd).float() / math.sqrt(hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    iq = torch.arange(sq, device=q.device)[:, None]
    ik = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (iq >= ik)
    if window > 0:
        ok = ok & (iq - ik < window)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, pool: torch.Tensor,
                        tables: torch.Tensor, page_pos: torch.Tensor,
                        seq_lens: torch.Tensor, *, window: int = 0,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial-softmax decode attention of ``q [B, Hq, hd]`` over the pages
    ``tables [B, pps]`` names in ``pool [P, page, 2, Hkv, hd]`` (``-1``
    slots skipped). Key ``t`` of slot ``j`` sits at position ``page_pos[b,
    j] + t`` and is valid when that is ``<= seq_lens[b]`` (inclusive) and,
    for ``window > 0``, ``seq_lens[b] - pos < window``. Returns float32
    ``(acc [B, Hq, hd], m [B, Hq], l [B, Hq])``: the running max, the sum
    of ``exp(s - m)`` over valid keys and the weighted sum of V, so the
    output is ``acc / max(l, 1e-30)`` (partials combine across shards)."""
    b, hq, hd = q.shape
    _p, page, _two, hkv, _hd = pool.shape
    pps = tables.shape[1]
    g = hq // hkv
    pages = pool[tables.long().clamp(min=0)]          # [B, pps, page, 2, Hkv, hd]
    kk = pages[:, :, :, 0].reshape(b, pps * page, hkv, hd)
    vv = pages[:, :, :, 1].reshape(b, pps * page, hkv, hd)
    pos = (page_pos[:, :, None].long()
           + torch.arange(page, device=q.device)[None, None, :])
    sl = seq_lens.long()[:, None, None]
    valid = (tables[:, :, None] >= 0) & (pos <= sl)
    if window > 0:
        valid = valid & (sl - pos < window)
    valid = valid.reshape(b, 1, 1, pps * page)
    qg = q.reshape(b, hkv, g, hd).float() / math.sqrt(hd)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kk.float())
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgt,bthd->bhgd", p, vv.float())
    return acc.reshape(b, hq, hd), m.reshape(b, hq), l.reshape(b, hq)


def ktls_dequant_ref(q: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """``float(q) * amax / 127`` of int8 ``q [..., hd]`` and ``amax [...,
    1]``, in float32: the JAX package's ``_dequant``
    (``benchmarks/bench_ktls_analogue.py:29``) in its order of operations.
    The divisor is a one-element tensor on ``q``'s device: torch divides a
    CUDA tensor by a Python scalar as a product with the scalar's float32
    reciprocal, which rounds otherwise than the division that the kernel,
    the CPU and the JAX package's eager ``_dequant`` compute."""
    return q.float() * amax / amax.new_full((1,), 127.0)


def ktls_attention_ref(q: torch.Tensor, kv: torch.Tensor,
                       amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(q k^T) v`` of ``q [B, Hq, hd]`` over every key of ``kv
    [B, ctx, 2, Hkv, hd]`` (K at index 0 of the third axis, V at 1), with
    no ``1/sqrt(hd)`` scale and no mask, as the kTLS-analogue bench
    attends; query head ``h`` reads KV head ``h // (Hq // Hkv)``. With
    ``amax [B, ctx, 2, Hkv, 1]``, ``kv`` is int8 and dequantised first
    (:func:`ktls_dequant_ref`). Float32."""
    if amax is not None:
        kv = ktls_dequant_ref(kv, amax)
    b, hq, hd = q.shape
    hkv = kv.shape[3]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bhgd,bthd->bhgt", qg, kv[:, :, 0])
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, kv[:, :, 1])
    return o.reshape(b, hq, hd)


def _meta_block(stream: torch.Tensor, meta_len: torch.Tensor,
                meta_max: int) -> torch.Tensor:
    """Compact each row's metadata prefix into ``[B, meta_max]``; lanes at
    or past ``meta_len`` are zero."""
    b, s = stream.shape
    idx = torch.arange(meta_max, device=stream.device)
    src = torch.clamp(idx, max=max(s - 1, 0)).expand(b, meta_max)
    vals = torch.gather(stream, 1, src)
    return torch.where(idx[None, :] < meta_len[:, None], vals,
                       torch.zeros_like(vals))


def _anchor(pool: torch.Tensor, vals: torch.Tensor, meta_len: torch.Tensor,
            total_len: torch.Tensor, tables: torch.Tensor) -> None:
    """Scatter payload token ``t`` (stream position ``meta_len + t``) into
    ``pool[tables[b, t // page], t % page]`` in place. Lanes outside the
    payload, ``-1`` table entries and rows past the pool are dropped."""
    b, s = vals.shape
    p_, page = pool.shape
    pps = tables.shape[1]
    if b == 0 or s == 0 or pps == 0:
        return
    t = torch.arange(s, device=vals.device)
    rel = t[None, :] - meta_len[:, None].long()               # [B, S]
    valid = (rel >= 0) & (t[None, :] < total_len[:, None])
    pg = torch.clamp(torch.div(rel, page, rounding_mode="floor"), 0, pps - 1)
    dest_page = torch.gather(tables.long(), 1, pg)
    dest_off = torch.remainder(rel, page)
    ok = valid & (dest_page >= 0) & (dest_page < p_)
    flat = dest_page * page + dest_off
    pool.view(-1).index_put_((flat[ok],), vals[ok])


def selective_copy_ref(stream: torch.Tensor, meta_len: torch.Tensor,
                       total_len: torch.Tensor, pool: torch.Tensor,
                       tables: torch.Tensor, *, meta_max: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RX data plane: compact metadata into ``[B, meta_max]`` and anchor
    the payload into the pool pages ``tables`` names (in place). Returns
    ``(meta, pool)``."""
    meta = _meta_block(stream, meta_len, meta_max)
    _anchor(pool, stream, meta_len, total_len, tables)
    return meta, pool


def selective_copy_crypto_ref(stream: torch.Tensor, meta_len: torch.Tensor,
                              total_len: torch.Tensor, pool: torch.Tensor,
                              tables: torch.Tensor, keystream: torch.Tensor,
                              *, meta_max: int,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hw-kTLS RX data plane: as :func:`selective_copy_ref`, with payload
    tokens XORed with ``keystream`` inside the anchoring scatter. The
    metadata compaction stays raw."""
    meta = _meta_block(stream, meta_len, meta_max)
    _anchor(pool, torch.bitwise_xor(stream, keystream), meta_len, total_len,
            tables)
    return meta, pool


def selective_gather_ref(pool: torch.Tensor, tables: torch.Tensor,
                         lengths: torch.Tensor,
                         keystream: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """TX data plane: ``out[i, j*page:(j+1)*page] = pool[tables[i, j]]``;
    lanes past ``lengths[i]`` and lanes of ``-1`` table slots are zero.
    ``keystream`` ([B, pps*page]) is XORed in (TX encrypt)."""
    p_, page = pool.shape
    b, pps = tables.shape
    out = pool[torch.clamp(tables.long(), 0, p_ - 1)].reshape(b, pps * page)
    pos = torch.arange(pps * page, device=pool.device)
    valid = (torch.repeat_interleave(tables >= 0, page, dim=1)
             & (pos[None, :] < lengths[:, None]))
    if keystream is not None:
        out = torch.bitwise_xor(out, keystream)
    return torch.where(valid, out, torch.zeros_like(out))


def policy_match_ref(meta: torch.Tensor, meta_len: torch.Tensor,
                     cond_off: torch.Tensor, cond_lo: torch.Tensor,
                     cond_hi: torch.Tensor,
                     keystream: Optional[torch.Tensor] = None,
                     live: Optional[torch.Tensor] = None,
                     payload: Optional[torch.Tensor] = None,
                     payload_len: Optional[torch.Tensor] = None,
                     ) -> torch.Tensor:
    """L7 policy first match. A condition holds iff its offset is padding
    (``-1``); or ``0 <= off < min(meta_len, M)`` and ``lo <= meta[off] <=
    hi``; or, for ``off <= -2`` (payload position ``-off - 2``), the
    position is inside both the payload and the window and the window token
    is in bounds. A rule matches when all K conditions hold (and it is
    ``live``). Returns the first matching rule per row, ``R`` when none
    does, as ``[B]`` int32."""
    b, mm = meta.shape
    r, k = cond_off.shape
    m = meta if keystream is None else torch.bitwise_xor(meta, keystream)
    off = cond_off.long()
    vals = m[:, torch.clamp(off, 0, max(mm - 1, 0))]               # [B, R, K]
    pad = cond_off == -1
    present = ((off >= 0)[None] & (off[None] < meta_len[:, None, None])
               & (off < mm)[None])
    ok = pad[None] | (present & (vals >= cond_lo[None])
                      & (vals <= cond_hi[None]))
    if payload is not None:
        w = payload.shape[1]
        ppos = -off - 2                                              # [R, K]
        pvals = payload[:, torch.clamp(ppos, 0, max(w - 1, 0))]      # [B, R, K]
        pay_ok = ((off <= -2)[None] & (ppos[None] < payload_len[:, None, None])
                  & (ppos < w)[None]
                  & (pvals >= cond_lo[None]) & (pvals <= cond_hi[None]))
        ok = ok | pay_ok
    rule_ok = ok.all(dim=2)                                          # [B, R]
    if live is not None:
        rule_ok = rule_ok & (live.reshape(1, r) > 0)
    ridx = torch.arange(r, dtype=I32, device=meta.device)
    cand = torch.where(rule_ok, ridx[None, :], torch.full_like(ridx, r))
    none = torch.full((b, 1), r, dtype=I32, device=meta.device)
    return torch.cat([cand, none], dim=1).amin(dim=1)


def fused_round_ref(stream: torch.Tensor, meta_len: torch.Tensor,
                    total_len: torch.Tensor, pool: torch.Tensor,
                    tables: torch.Tensor, *, meta_max: int,
                    keystream: Optional[torch.Tensor] = None,
                    tx_keystream: Optional[torch.Tensor] = None,
                    cond_off: Optional[torch.Tensor] = None,
                    cond_lo: Optional[torch.Tensor] = None,
                    cond_hi: Optional[torch.Tensor] = None,
                    live: Optional[torch.Tensor] = None,
                    meta_ks: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor], torch.Tensor]:
    """One scheduling round: selective copy (with the RX keystream XOR),
    the policy first match over the metadata row (XOR ``meta_ks``) and the
    RX-decrypted first-page window, and the egress gather of the anchored
    payload (XOR ``tx_keystream``). Returns ``(meta, pool, verdict | None,
    out)``; the pool is updated in place."""
    if keystream is None:
        meta, pool = selective_copy_ref(stream, meta_len, total_len, pool,
                                        tables, meta_max=meta_max)
        plain = stream
    else:
        meta, pool = selective_copy_crypto_ref(
            stream, meta_len, total_len, pool, tables, keystream,
            meta_max=meta_max)
        plain = torch.bitwise_xor(stream, keystream)
    plen = total_len - meta_len
    verdict = None
    if cond_off is not None:
        s = stream.shape[1]
        page = pool.shape[1]
        # first-page window: payload positions [0, page), clamped in-stream
        # (lanes past the payload are gated off inside the match)
        idx = torch.clamp(meta_len[:, None].long()
                          + torch.arange(page, device=stream.device)[None, :],
                          max=s - 1)
        window = torch.gather(plain, 1, idx)
        mrow = meta if meta_ks is None else torch.bitwise_xor(meta, meta_ks)
        verdict = policy_match_ref(mrow, meta_len, cond_off, cond_lo, cond_hi,
                                   None, live, payload=window,
                                   payload_len=plen)
    out = selective_gather_ref(pool, tables, plen, tx_keystream)
    return meta, pool, verdict, out


def mlstm_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_i: torch.Tensor, log_f: torch.Tensor, *,
                      chunk: int = 64,
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]]:
    """Stabilised chunkwise-parallel mLSTM from the zero state,
    :func:`repro_torch.models.ssm.mlstm_cell_chunked` (the twin of the JAX
    package's ``models.ssm.mlstm_cell_chunked``) in the kernel's layout:
    ``q``/``k``/``v [B, H, S, dh]``, ``log_i``/``log_f [B, H, S]``
    (``log_f`` log-sigmoided). Returns ``(h [B, H, S, dh], (C [B, H, dh,
    dh], n [B, H, dh], m [B, H]))``, computed in float32 (float64 for
    float64 inputs)."""
    from repro_torch.models.ssm import mlstm_cell_chunked

    h, state = mlstm_cell_chunked(
        *(x.transpose(1, 2) for x in (q, k, v, log_i, log_f)), chunk=chunk)
    return h.transpose(1, 2), state


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_i: torch.Tensor, log_f: torch.Tensor) -> torch.Tensor:
    """Sequential mLSTM oracle. q/k/v [B, H, S, dh]; gates [B, H, S].
    Returns h [B, H, S, dh]."""
    from repro_torch.models.ssm import mlstm_cell_sequential

    h, _ = mlstm_cell_sequential(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        log_i.transpose(1, 2), log_f.transpose(1, 2))
    return h.transpose(1, 2)


def moe_experts_ref(xs: torch.Tensor, offsets: torch.Tensor,
                    gates: torch.Tensor, dest: torch.Tensor,
                    w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor,
                    shared_gate: Optional[torch.Tensor] = None,
                    shared_up: Optional[torch.Tensor] = None,
                    shared_down: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The grouped SwiGLU experts of ``csrc/moe_experts.cu``: ``y [N, D]``.

    ``xs [N, D]`` holds entries sorted by group, group ``g`` in rows
    ``offsets[g]`` to ``offsets[g + 1] - 1`` (``offsets [E + S + 1]``
    int32). Group ``g < E`` is expert ``g`` of ``w_gate``, ``w_up [E, D,
    F]`` and ``w_down [E, F, D]``; group ``E + s`` is block ``s`` of the
    shared expert, columns ``s F`` to ``(s + 1) F - 1`` of ``shared_gate``,
    ``shared_up [D, S F]`` and rows of ``shared_down [S F, D]``. Entry ``r``
    gives ``gates[r] * (silu(xs[r] w_gate) * (xs[r] w_up)) w_down`` to row
    ``dest[r]`` of ``y`` (``dest [N]`` int64, a permutation of its rows);
    the rows of the entries from ``offsets[-1]`` on are zero (the kernel
    leaves them unwritten)."""
    e, _d, f = w_gate.shape
    y = xs.new_zeros(xs.shape)
    off = offsets.tolist()
    for g in range(len(off) - 1):
        a, b = off[g], off[g + 1]
        if a == b:
            continue
        if g < e:
            wg, wu, wd = w_gate[g], w_up[g], w_down[g]
        else:
            cols = slice((g - e) * f, (g - e + 1) * f)
            wg, wu, wd = shared_gate[:, cols], shared_up[:, cols], \
                shared_down[cols]
        x = xs[a:b]
        h = torch.nn.functional.silu(x @ wg) * (x @ wu)
        y[dest[a:b]] = (h @ wd) * gates[a:b, None]
    return y



def router_topk_ref(logits: torch.Tensor, num_experts: int, top_k: int,
                    norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[T, Ep]`` router logits -> ``(gates [T, k], ids [T, k])``: the
    ``top_k`` experts of highest softmax probability (float32), experts
    from ``num_experts`` on masked out first so that they are never
    chosen, gated by their probability, renormalised to sum to 1 with
    ``norm_topk``."""
    ep = logits.shape[-1]
    if ep > num_experts:
        pad = torch.arange(ep, device=logits.device) >= num_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    gates, ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    if norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gates, ids


def moe_route_ref(logits: torch.Tensor, x: torch.Tensor,
                  gate_proj: Optional[torch.Tensor],
                  valid: Optional[torch.Tensor], *, num_experts: int,
                  top_k: int, num_shared: int, norm_topk: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The entries of :func:`moe_experts_ref` for a dropless MoE layer:
    ``(xs, offsets, gates, dest)``. Each row of ``x [T, D]`` where ``valid
    [T]`` (every row without it) makes ``top_k`` entries, its experts of
    highest softmax probability over the router's ``logits [T, Ep]``
    (experts from ``num_experts`` on are padding, never chosen), gated by
    that probability (renormalised over the ``top_k`` with ``norm_topk``),
    then one entry for each of the shared expert's ``num_shared`` blocks
    (groups ``Ep`` to ``Ep + num_shared - 1``), gated by ``sigmoid(x
    gate_proj)``. The entries are sorted by group (stably here; in any
    order within a group in the kernel): ``offsets [Ep + num_shared + 1]``
    int32 bound the groups, ``xs`` holds each entry's row of ``x``,
    ``gates`` its gate and ``dest`` its place in token order, ``row * width
    + j`` (``width = top_k + num_shared``). Entries of rows not routed sort
    past the last group; their ``xs``, ``gates`` and ``dest`` are
    unspecified (the kernel leaves them unwritten)."""
    t, ep = logits.shape
    s = num_shared
    gates, ids = router_topk_ref(logits, num_experts, top_k, norm_topk)
    if s:
        blocks = torch.arange(ep, ep + s, device=x.device)
        ids = torch.cat([ids, blocks.expand(t, s)], dim=1)
        gates = torch.cat([gates, torch.sigmoid(x @ gate_proj).expand(t, s)],
                          dim=1)
    if valid is not None:           # rows not routed sort past every group
        ids = torch.where(valid[:, None], ids, ep + s)
    sorted_ids, dest = torch.sort(ids.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(ep + s + 1, device=x.device,
                                 dtype=sorted_ids.dtype), out_int32=True)
    return x[dest // (top_k + s)], offsets, gates.reshape(-1)[dest], dest
