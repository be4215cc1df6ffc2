#!/usr/bin/env python
"""CI gate: the port's datapath CUDA kernels against their plain PyTorch
versions, on the card.

The counterpart of ``scripts/check_kernel_parity.py``, over the same shape
sweeps and seeds (the seeded case generators of
:mod:`repro_torch.kernels.testing`):

1. **Parity** — at each shape, the kernel (``impl='cuda'``) and its plain
   version (``impl='ref'``) on copies of the same operands must agree bit
   for bit (``torch.equal``, the whole pool after the in-place anchor
   included): ``selective_copy`` plain and with the hw-kTLS keystream,
   ``selective_gather`` with and without the TX keystream,
   ``policy_match`` with every combination of keystream and live column
   (and of the payload-prefix window), and ``fused_round`` across its
   crypto / policy matrix at ring depths 0 and 2 (and 4 with every
   operand). The reference's legacy (grown-pool) mode has no counterpart:
   the port's pool always carries its scratch row.
2. **The kernel audit** — every shape's call goes through
   :func:`repro_torch.analysis.kernel_audit.assert_fused`: one launch of
   its kernel (the fused round is ONE launch), no pool-sized copy or
   allocation, int32 in and out, no copy across the boundary, and the
   pool updated in place.

It needs a CUDA device and raises at once without one.

Run: ``PYTHONPATH=src python scripts/check_kernel_parity_torch.py``
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.analysis.kernel_audit import assert_fused, op_call  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    fused_round_case,
    policy_case,
    policy_live_column,
    policy_payload_case,
    selcopy_case,
    selcopy_crypto_case,
    selgather_case,
    to_torch,
)

SELCOPY_SHAPES = [(1, 8, 2, 8), (2, 8, 4, 16), (3, 16, 4, 16), (2, 16, 3, 32)]
GATHER_SHAPES = [(1, 8, 2), (2, 8, 4), (3, 16, 4), (2, 16, 3)]
POLICY_SHAPES = [(1, 8, 2, 1), (4, 16, 6, 3), (3, 32, 8, 2), (8, 16, 4, 4)]
PAYLOAD_SHAPES = [(1, 8, 2, 1, 8), (4, 16, 6, 3, 8), (3, 16, 8, 2, 16)]
FUSED_SHAPES = [(1, 8, 2, 8), (2, 8, 4, 16)]


def _outs(result):
    return result if isinstance(result, tuple) else (result,)


def parity(call, tag) -> None:
    """The call's kernel and its plain version on copies of its pool (the
    other operands are only read): every output bit-identical."""
    def on_copy(fn):
        args = list(call.args)
        if call.pool is not None:
            args[call.pool] = args[call.pool].clone()
        return _outs(fn(*args, **call.kwargs))

    got, want = on_copy(call.fn), on_copy(call.plain)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        same = (g is None and w is None) or (
            g is not None and w is not None and torch.equal(g, w))
        assert same, (tag, "output", i)


def check_selcopy(dev) -> list:
    calls = []
    for crypto, seed in ((False, 42), (True, 43)):
        rng = np.random.default_rng(seed)
        for b, page, pps, meta_max in SELCOPY_SHAPES:
            if crypto:
                stream, ml, tl, pool, tables, ks = to_torch(
                    selcopy_crypto_case(rng, b=b, page=page, pps=pps,
                                        meta_max=meta_max), dev)
                kw = dict(meta_max=meta_max, keystream=ks)
            else:
                stream, ml, tl, pool, tables = to_torch(selcopy_case(
                    rng, b=b, page=page, pps=pps, meta_max=meta_max), dev)
                kw = dict(meta_max=meta_max)
            tag = f"selective_copy[{b},{page},{pps},{meta_max},ks={crypto}]"
            calls.append(op_call(tag, ops.selective_copy, "cuda",
                                 (stream, ml, tl, pool, tables), kw, pool=3,
                                 pool_out=1, index_bound=b * pps))
    return calls


def check_gather(dev) -> list:
    calls = []
    rng = np.random.default_rng(44)
    for b, page, pps in GATHER_SHAPES:
        pool, tables, lengths, ks = to_torch(
            selgather_case(rng, b=b, page=page, pps=pps), dev)
        for k in (None, ks):
            tag = f"selective_gather[{b},{page},{pps},ks={k is not None}]"
            calls.append(op_call(tag, ops.selective_gather, "cuda",
                                 (pool, tables, lengths), dict(keystream=k),
                                 pool=0, index_bound=b * pps))
    return calls


def _policy_calls(tag0, base, kk_all, lv_all, extra) -> list:
    meta, ml, off, lo, hi = base
    calls = []
    for kk in (None, kk_all):
        for lv in (None, lv_all):
            m = meta if kk is None else torch.bitwise_xor(meta, kk)
            tag = f"{tag0},ks={kk is not None},live={lv is not None}]"
            calls.append(op_call(tag, ops.policy_match, "cuda",
                                 (m, ml, off, lo, hi),
                                 dict(keystream=kk, live=lv, **extra)))
    return calls


def check_policy(dev) -> list:
    calls = []
    rng = np.random.default_rng(45)
    for b, meta_max, r, k in POLICY_SHAPES:
        meta, ml, off, lo, hi, ks = to_torch(
            policy_case(rng, b=b, meta_max=meta_max, r=r, k=k), dev)
        live = to_torch(policy_live_column(rng, r), dev)
        calls += _policy_calls(f"policy_match[{b},{meta_max},{r},{k}",
                               (meta, ml, off, lo, hi), ks, live, {})
    rng = np.random.default_rng(46)
    for b, meta_max, r, k, w in PAYLOAD_SHAPES:
        meta, ml, off, lo, hi, ks, pay, plen = to_torch(policy_payload_case(
            rng, b=b, meta_max=meta_max, r=r, k=k, w=w), dev)
        live = to_torch(policy_live_column(rng, r), dev)
        calls += _policy_calls(
            f"policy_match[payload,{b},{meta_max},{r},{k},{w}",
            (meta, ml, off, lo, hi), ks, live,
            dict(payload=pay, payload_len=plen))
    return calls


def check_fused(dev) -> list:
    calls = []
    rng = np.random.default_rng(47)
    for b, page, pps, meta_max in FUSED_SHAPES:
        case = to_torch(fused_round_case(rng, b=b, page=page, pps=pps,
                                         meta_max=meta_max), dev)
        base = (case["stream"], case["meta_len"], case["total_len"],
                case["pool"], case["tables"])
        for crypto in (False, True):
            for policy in (False, True):
                kw = dict(meta_max=meta_max)
                if crypto:
                    kw.update(keystream=case["keystream"],
                              tx_keystream=case["tx_keystream"])
                if policy:
                    kw.update(cond_off=case["cond_off"],
                              cond_lo=case["cond_lo"],
                              cond_hi=case["cond_hi"], live=case["live"])
                    if crypto:
                        kw.update(meta_ks=case["meta_ks"])
                for n_buffers in ((0, 2, 4) if crypto and policy
                                  else (0, 2)):
                    tag = (f"fused_round[{b},{page},{pps},{meta_max},"
                           f"crypto={crypto},policy={policy},"
                           f"nb={n_buffers}]")
                    calls.append(op_call(
                        tag, ops.fused_round, "cuda", base,
                        dict(kw, n_buffers=n_buffers), pool=3, pool_out=1,
                        index_bound=b * pps))
    return calls


CHECKS = (("selective_copy", check_selcopy), ("selective_gather",
                                             check_gather),
          ("policy_match", check_policy), ("fused_round", check_fused))


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        raise RuntimeError("check_kernel_parity_torch needs a CUDA device: "
                           "the kernels run only on the card")
    dev = torch.device("cuda", torch.cuda.current_device())
    for name, check in CHECKS:
        calls = check(dev)
        for call in calls:
            parity(call, call.name)
        assert_fused(calls, dev)
        print(f"{name}: {len(calls)} shapes, kernel == plain version "
              f"(bit-exact), one launch each, no pool copy, int32, no "
              f"boundary copy, pool in place")
    print("check_kernel_parity_torch: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
