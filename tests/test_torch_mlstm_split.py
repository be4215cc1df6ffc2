"""The numerics of the CUDA ``mlstm_scan``'s split-TF32 products, on the CPU.

The kernel takes each float32 product on the tensor cores as three TF32
products: ``x = hi + lo`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``cvt.rna``: a 10-bit mantissa, round to nearest, ties away from zero),
and ``a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b``. This file holds a chunked
mLSTM whose four products (``q kT``, ``q C``, ``P v``, ``(k w)T v``) go
through the TF32 emulation of ``_tf32_emulation.py``, and checks that the
split keeps the scan within the JAX package's bar for its Pallas kernel
(``atol = rtol = 5e-4``) of the plain float32 ``mlstm_chunked_ref`` at
xlstm-350m's head dim, where one TF32 pass does not."""
import math

import numpy as np
import pytest
import torch

from _tf32_emulation import mm_one_pass, mm_split, split, tf32
from repro_torch.kernels.ref import NEG_INF, mlstm_chunked_ref

BAR = dict(atol=5e-4, rtol=5e-4)


def chunked(q, k, v, log_i, log_f, chunk, mm):
    """The stabilised chunkwise mLSTM of ``mlstm_chunked_ref``, float32,
    with its four products taken by ``mm`` as the kernel takes them (``k``
    scaled by 1/sqrt(dh) before ``q kT``)."""
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (q, k, v))
        log_i = torch.nn.functional.pad(log_i, (0, pad), value=NEG_INF)
        log_f = torch.nn.functional.pad(log_f, (0, pad))
    C = torch.zeros((b, h, dh, dh))
    n = torch.zeros((b, h, dh))
    m = torch.full((b, h), NEG_INF)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    hs = []
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        qc, kc, vc = q[:, :, sl], k[:, :, sl], v[:, :, sl]
        li, lf = log_i[:, :, sl], log_f[:, :, sl]
        A = torch.cumsum(lf, dim=-1)
        W = A[..., :, None] - A[..., None, :] + li[..., None, :]
        W = torch.where(causal, W, torch.full_like(W, NEG_INF))
        binter = A + m[..., None]
        m_loc = torch.maximum(W.amax(dim=-1), binter)
        P = torch.exp(W - m_loc[..., None]) * mm(qc, (kc * scale)
                                                 .transpose(-1, -2))
        e_inter = torch.exp(binter - m_loc)
        num = mm(P, vc) + e_inter[..., None] * mm(qc, C)
        den = P.sum(dim=-1) + e_inter * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_loc))[..., None])
        A_T = A[..., -1]
        w_end = A_T[..., None] - A + li
        m_new = torch.maximum(A_T + m, w_end.amax(dim=-1))
        kw = kc * scale * torch.exp(w_end - m_new[..., None])[..., None]
        decay = torch.exp(A_T + m - m_new)
        C = decay[..., None, None] * C + mm(kw.transpose(-1, -2), vc)
        n = decay[..., None] * n + kw.sum(dim=-2)
        m = m_new
    return torch.cat(hs, dim=2)[:, :, :s], (C, n, m)


def _inputs(seed, b, h, s, dh):
    """q, k, v ~ N(0, 1), log_i ~ N(0, 1), log_f = logsigmoid(N(2, 1)), as
    the JAX package's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh))
                                .astype(np.float32)) for _ in range(3))
    li = torch.from_numpy(rng.standard_normal((b, h, s)).astype(np.float32))
    x = rng.standard_normal((b, h, s)) + 2
    lf = torch.from_numpy(np.log(1 / (1 + np.exp(-x))).astype(np.float32))
    return q, k, v, li, lf


def _max_errs(got, want):
    gh, (gc, gn, gm) = got
    wh, (wc, wn, wm) = want
    return {name: float((a - b).abs().max())
            for name, a, b in (("h", gh, wh), ("C", gc, wc), ("n", gn, wn),
                               ("m", gm, wm))}


def _within_bar(got, want):
    gh, gs = got
    wh, ws = want
    return all(torch.allclose(a, b, **BAR)
               for a, b in zip((gh, *gs), (wh, *ws)))


# (B, H, S, dh, chunk): xlstm-350m's head dim at the three chunk lengths
# the kernel takes, one S ragged; and a narrow head
SPLIT_CASES = [(1, 2, 512, 512, 64), (1, 1, 200, 512, 32),
               (1, 1, 96, 512, 16), (2, 2, 160, 64, 32)]


@pytest.mark.parametrize("b,h,s,dh,chunk", SPLIT_CASES)
def test_split_tf32_scan_holds_the_bar(b, h, s, dh, chunk):
    """h and the final (C, n, m) of the split-product scan lie within
    5e-4 of the plain float32 version."""
    args = _inputs(7, b, h, s, dh)
    want = mlstm_chunked_ref(*args, chunk=chunk)
    got = chunked(*args, chunk, mm_split)
    assert _within_bar(got, want), _max_errs(got, want)


@pytest.mark.parametrize("b,h,s,dh,chunk", SPLIT_CASES[:2])
def test_one_tf32_pass_misses_the_bar(b, h, s, dh, chunk):
    """One TF32 pass per product is not within the bar at dh 512, and its
    h lies at least 10x farther from the plain version than the split's."""
    args = _inputs(7, b, h, s, dh)
    want = mlstm_chunked_ref(*args, chunk=chunk)
    one = chunked(*args, chunk, mm_one_pass)
    three = chunked(*args, chunk, mm_split)
    assert not _within_bar(one, want)
    assert _max_errs(one, want)["h"] >= 10 * _max_errs(three, want)["h"]


@pytest.mark.parametrize("log10_scale", [-20, -3, 0, 3, 20])
def test_split_error_bound(log10_scale):
    """|x - (hi + lo)| <= 2^-21 |x| on random float32 values, and hi and lo
    are TF32 values (their low 13 mantissa bits are 0)."""
    rng = np.random.default_rng(log10_scale + 100)
    x = torch.from_numpy((rng.standard_normal(1 << 16)
                          * 10.0 ** log10_scale).astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_tf32_rounds_to_nearest_ties_away():
    """1 + 2^-11 (a tie) rounds up to 1 + 2^-10, -(1 + 2^-11) down; just
    below the tie rounds to 1."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11
                      - 2.0 ** -23, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32(x), want)
