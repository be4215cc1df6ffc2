"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The ``impl`` strings read as in the JAX package, so the stack's
``batch_impl`` values (``'ref'``, ``'auto'``, ``'fused-round[:impl]'``)
mean the same in both:

========== ===============================================================
``'ref'``  the plain PyTorch version (:mod:`repro_torch.kernels.ref`)
``'cuda'`` the CUDA kernel (:mod:`repro_torch.kernels.selective_copy`);
           raises for a tensor that is not on a CUDA device
``'auto'`` the kernel for CUDA tensors, the plain version for CPU tensors
========== ===============================================================

``'interpret'`` and ``'pallas'`` name TPU execution modes and raise
``ValueError``. A CUDA tensor never reaches the plain version through
``'auto'``, and a failed kernel launch raises: there is no fallback.

The pool is updated in place by both impls (the kernels write it, the
plain version uses ``index_put_``), so ``donate_pool`` is accepted for
signature parity with the JAX package and changes nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import selective_copy as _k

IMPLS = ("ref", "cuda", "auto")


def checked_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names a CUDA device and no
    GPU is present: device rounds never carry on on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested, but no CUDA "
                           "device is available")
    return dev


def resolve(impl: str, t: torch.Tensor) -> str:
    """``'ref'`` or ``'cuda'`` for an impl string and the tensor the call
    runs on."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS}; "
                         f"'interpret' and 'pallas' are TPU modes)")
    if impl == "auto":
        return "cuda" if t.device.type == "cuda" else "ref"
    return impl


def selective_copy(stream, meta_len, total_len, pool, tables, *, meta_max,
                   impl="auto", keystream=None, donate_pool=False,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RX plane over the resident pool: ``(meta, pool)``, the pool updated
    in place. ``keystream`` ([B, S] int32, zero outside the payload) fuses
    the hw-kTLS RX decrypt into the anchoring pass."""
    del donate_pool
    if resolve(impl, pool) == "cuda":
        return _k.selective_copy(stream, meta_len, total_len, pool, tables,
                                 meta_max=meta_max, keystream=keystream)
    if keystream is None:
        return _ref.selective_copy_ref(stream, meta_len, total_len, pool,
                                       tables, meta_max=meta_max)
    return _ref.selective_copy_crypto_ref(stream, meta_len, total_len, pool,
                                          tables, keystream,
                                          meta_max=meta_max)


def selective_gather(pool, tables, lengths, *, impl="auto",
                     keystream=None) -> torch.Tensor:
    """TX plane: ``[B, pps*page]`` gathered from the pool, zero past each
    length; ``keystream`` fuses the hw-kTLS TX encrypt."""
    if resolve(impl, pool) == "cuda":
        return _k.selective_gather(pool, tables, lengths, keystream=keystream)
    return _ref.selective_gather_ref(pool, tables, lengths, keystream)


def policy_match(meta, meta_len, cond_off, cond_lo, cond_hi, *, impl="auto",
                 keystream=None, live=None, payload=None,
                 payload_len=None) -> torch.Tensor:
    """First matching rule of the dense ``[R, K]`` table per message
    (``R`` = none). ``keystream`` is XORed into the metadata, ``live``
    masks dead rules, ``payload``/``payload_len`` serve payload-prefix
    conditions."""
    if resolve(impl, meta) == "cuda":
        return _k.policy_match(meta, meta_len, cond_off, cond_lo, cond_hi,
                               keystream=keystream, live=live,
                               payload=payload, payload_len=payload_len)
    return _ref.policy_match_ref(meta, meta_len, cond_off, cond_lo, cond_hi,
                                 keystream, live, payload=payload,
                                 payload_len=payload_len)


def fused_round(stream, meta_len, total_len, pool, tables, *, meta_max,
                impl="auto", keystream=None, tx_keystream=None,
                cond_off=None, cond_lo=None, cond_hi=None, live=None,
                meta_ks=None, n_buffers=0, donate_pool=False,
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor], torch.Tensor]:
    """The one-launch scheduling round: ``(meta, pool, verdict | None,
    out)``. ``n_buffers`` (the TPU kernel's VMEM ring depth) is accepted
    and ignored, as the plain version ignores it."""
    del n_buffers, donate_pool
    kw = dict(meta_max=meta_max, keystream=keystream,
              tx_keystream=tx_keystream, cond_off=cond_off, cond_lo=cond_lo,
              cond_hi=cond_hi, live=live, meta_ks=meta_ks)
    if resolve(impl, pool) == "cuda":
        return _k.fused_round(stream, meta_len, total_len, pool, tables, **kw)
    return _ref.fused_round_ref(stream, meta_len, total_len, pool, tables,
                                **kw)
