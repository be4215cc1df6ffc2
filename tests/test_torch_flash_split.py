"""The numerics of the CUDA ``flash_attention``'s split-TF32 products, on
the CPU.

The kernel (``csrc/flash_attention.cu``) walks 32-key tiles of K and V
for 128-row query tiles, with an online softmax in float32, and takes
both products on the tensor cores as three TF32 products (the emulation
of ``_tf32_emulation.py``): ``q kT`` in slices of at most 64 head dims,
each into zeroed accumulators added in float32, and ``P v`` with its
contraction permuted so that ``P`` goes from the score accumulators into
the A fragments without a shuffle. This file holds a blockwise flash that
does the same on the CPU and checks that the split keeps it within the
kernel's bar (``atol = rtol = 1e-4``, the JAX package's) of the plain
``flash_attention_ref``, where one TF32 pass does not, and that the
permuted contraction, taken through the lanes' fragments as the kernel
takes it, equals the plain one."""
import math

import numpy as np
import pytest
import torch

from _tf32_emulation import mm_one_pass, mm_split
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

BAR = dict(atol=1e-4, rtol=1e-4)
BQ, BK = 128, 32                       # query rows, keys a tile
#: the order of the 8 keys of a k-step in P v's contraction: k = t is key
#: 2t, k = t + 4 is key 2t + 1
KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


def _slice_dims(hd: int) -> int:
    return hd if hd <= 64 else hd // 2


def flash_blockwise(q, k, v, *, causal, window, mm):
    """``flash_attention_ref``'s function computed as the kernel computes
    it: per query tile, the key tiles it reads, ``q kT`` by ``mm`` per slice
    of head dims, the masked online softmax, and ``P v`` by ``mm`` in the
    kernel's key order, added to the rescaled output as one fused
    multiply-add."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qs = q * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    sl = _slice_dims(hd)
    out = torch.zeros_like(q)
    for q0 in range(0, sq, BQ):
        q_last = min(q0 + BQ, sq) - 1
        qt = qs[:, :, q0:q_last + 1]
        kt_end = -(-skv // BK)
        if causal:
            kt_end = min(kt_end, q_last // BK + 1)
        kt_begin = 0
        if window > 0 and q0 - window - (BK - 1) >= 0:
            kt_begin = (q0 - window - (BK - 1)) // BK + 1
        rows = qt.shape[2]
        m = torch.full((b, hq, rows), NEG_INF)
        l = torch.zeros((b, hq, rows))
        o = torch.zeros((b, hq, rows, hd))
        iq = torch.arange(q0, q0 + rows)[:, None]
        for kt in range(kt_begin, kt_end):
            k0 = kt * BK
            kt_k = torch.zeros((b, hq, BK, hd))
            kt_v = torch.zeros((b, hq, BK, hd))
            n = min(BK, skv - k0)
            kt_k[:, :, :n] = kk[:, :, k0:k0 + n]
            kt_v[:, :, :n] = vv[:, :, k0:k0 + n]
            s = None
            for d0 in range(0, hd, sl):
                part = mm(qt[..., d0:d0 + sl],
                          kt_k[..., d0:d0 + sl].transpose(-1, -2))
                s = part if s is None else s + part
            ik = torch.arange(k0, k0 + BK)[None, :]
            ok = ik < skv
            if causal:
                ok = ok & (iq >= ik)
            if window > 0:
                ok = ok & (iq - ik < window)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            mx = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - mx)
            p = torch.where(ok, torch.exp(s - mx[..., None]),
                            torch.zeros_like(s))
            l = l * alpha + p.sum(dim=-1)
            m = mx
            perm = (torch.arange(0, BK, 8)[:, None]
                    + torch.tensor(KEY_ORDER)[None, :]).reshape(-1)
            pv = mm(p[..., perm], kt_v[..., perm, :])
            o = (o.double() * alpha.double()[..., None]
                 + pv.double()).float()
        out[:, :, q0:q_last + 1] = o / torch.clamp(l, min=1e-30)[..., None]
    return out


def _inputs(seed, b, hq, hkv, s, hd):
    """q, k, v ~ N(0, 1), as chip_smoke.py draws them on the card."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32))
                 for shape in ((b, hq, s, hd), (b, hkv, s, hd),
                               (b, hkv, s, hd)))


def _err(got, want) -> float:
    return float((got - want).abs().max())


# (label, B, Hq, Hkv, S, hd, causal, window): GQA 1 to 3, head dims 128,
# 64 and the narrow ones, windows, S no multiple of a tile, non-causal
CASES = [
    ("g3-hd128-tail", 1, 6, 2, 300, 128, True, 0),
    ("g1-hd64", 1, 4, 4, 256, 64, True, 0),
    ("g3-hd64-window", 1, 6, 2, 300, 64, True, 100),
    ("g1-hd128-noncausal", 1, 2, 2, 130, 128, False, 0),
    ("g3-hd128-window-tail", 1, 3, 1, 333, 128, True, 150),
    ("g3-hd96-window-tail", 1, 6, 2, 200, 96, True, 70),
    ("g2-hd16-tail", 2, 4, 2, 40, 16, True, 0),
]


@pytest.mark.parametrize("label,b,hq,hkv,s,hd,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_split_tf32_flash_holds_the_bar(label, b, hq, hkv, s, hd, causal,
                                        window):
    """The split-product blockwise flash lies within 1e-4 of the plain
    float32 version."""
    q, k, v = _inputs(3, b, hq, hkv, s, hd)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    got = flash_blockwise(q, k, v, causal=causal, window=window, mm=mm_split)
    assert torch.allclose(got, want, **BAR), _err(got, want)


@pytest.mark.parametrize("label,b,hq,hkv,s,hd,causal,window", CASES[:3],
                         ids=[c[0] for c in CASES[:3]])
def test_one_tf32_pass_misses_the_bar(label, b, hq, hkv, s, hd, causal,
                                      window):
    """One TF32 pass per product misses the bar, and lies at least 10x
    farther from the plain version than the split."""
    q, k, v = _inputs(3, b, hq, hkv, s, hd)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    one = flash_blockwise(q, k, v, causal=causal, window=window,
                          mm=mm_one_pass)
    three = flash_blockwise(q, k, v, causal=causal, window=window,
                            mm=mm_split)
    assert not torch.allclose(one, want, **BAR)
    assert _err(one, want) >= 10 * _err(three, want)


def _mma_m16n8k8(a_frag, b_frag):
    """D = A B of one mma.sync m16n8k8 from the 32 lanes' fragments (lane
    = 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B
    (t, g), (t + 4, g))."""
    a = torch.zeros((16, 8), dtype=torch.float64)
    bm = torch.zeros((8, 8), dtype=torch.float64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_frag[lane]
        bm[t, g], bm[t + 4, g] = b_frag[lane]
    return a @ bm


@pytest.mark.parametrize("seed", [0, 1])
def test_permuted_contraction_equals_plain_order(seed):
    """P [16, 32] v [32, 16] through the lanes as the kernel takes it: the
    A fragment {c0, c2, c1, c3} of each 8-key score tile's C fragment (c0
    = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1)),
    the B fragment from key rows 8j + 2t and 8j + 2t + 1. Integer values:
    both orders are exact, so they must be equal."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.integers(-8, 9, (16, BK)).astype(np.float64))
    v = torch.from_numpy(rng.integers(-8, 9, (BK, 16)).astype(np.float64))
    out = torch.zeros((16, 16), dtype=torch.float64)
    for j in range(BK // 8):
        a_frag = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            c = (p[g, 8 * j + 2 * t], p[g, 8 * j + 2 * t + 1],
                 p[g + 8, 8 * j + 2 * t], p[g + 8, 8 * j + 2 * t + 1])
            a_frag.append((c[0], c[2], c[1], c[3]))
        for n0 in (0, 8):
            b_frag = [(v[8 * j + 2 * (lane & 3), n0 + (lane >> 2)],
                       v[8 * j + 2 * (lane & 3) + 1, n0 + (lane >> 2)])
                      for lane in range(32)]
            out[:, n0:n0 + 8] += _mma_m16n8k8(a_frag, b_frag)
    assert torch.equal(out, p @ v)
    perm = (torch.arange(0, BK, 8)[:, None]
            + torch.tensor(KEY_ORDER)[None, :]).reshape(-1)
    assert torch.equal(p[:, perm] @ v[perm], p @ v)
