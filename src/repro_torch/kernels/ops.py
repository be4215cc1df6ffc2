"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The ``impl`` strings read as in the JAX package, so the stack's
``batch_impl`` values (``'ref'``, ``'auto'``, ``'fused-round[:impl]'``)
mean the same in both:

========== ===============================================================
``'ref'``  the plain PyTorch version (:mod:`repro_torch.kernels.ref`;
           ``linear_f32``'s is ``torch.matmul``)
``'cuda'`` the CUDA kernel (:mod:`repro_torch.kernels.selective_copy`,
           :mod:`repro_torch.kernels.attention`,
           :mod:`repro_torch.kernels.mlstm_scan`,
           :mod:`repro_torch.kernels.ktls_attention`,
           :mod:`repro_torch.kernels.linear_f32`); raises for a tensor
           that is not on a CUDA device
``'auto'`` the kernel for CUDA tensors, the plain version for CPU tensors
========== ===============================================================

``'interpret'`` and ``'pallas'`` name TPU execution modes and raise
``ValueError``. A CUDA tensor never reaches the plain version through
``'auto'``, and a failed kernel launch raises: there is no fallback.

The attention and mLSTM kernels are forward only, as the Pallas kernels
are, and so is ``linear_f32``: on the ``'cuda'`` route they raise
``RuntimeError`` when gradients are enabled and an input requires them,
before any other check, so that a gradient never vanishes in silence.
Training differentiates the models' plain functions
(``models.attention.dense_or_blockwise``, ``models.ssm.mlstm_cell_chunked``)
instead.

The pool is updated in place by both impls (the kernels write it, the
plain version uses ``index_put_``), so ``donate_pool`` is accepted for
signature parity with the JAX package and changes nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import attention as _attn
from repro_torch.kernels import ktls_attention as _ktls
from repro_torch.kernels import linear_f32 as _lin
from repro_torch.kernels import mlstm_scan as _mlstm
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


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` if gradients are enabled and one of
    ``tensors`` requires them: kernel ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel is forward only and an "
                           "input requires grad; differentiate the model's "
                           "plain function, or call it under torch.no_grad()")


def flash_attention(q, k, v, *, causal=True, window=0,
                    impl="auto") -> torch.Tensor:
    """Prefill attention ``[B, Hq, Sq, hd]`` of ``q [B, Hq, Sq, hd]`` over
    ``k``/``v [B, Hkv, Skv, hd]`` (GQA, causal, sliding window)."""
    if resolve(impl, q) == "cuda":
        forward_only("flash_attention", q, k, v)
        return _attn.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def linear_f32(x, w, *, impl="auto") -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` in float32: the split-TF32 tensor-core
    kernel (the prefill's projections), or as plain version
    ``torch.matmul``, the library's float32 product (TF32 off)."""
    if resolve(impl, x) == "cuda":
        forward_only("linear_f32", x, w)
        return _lin.linear_f32(x, w)
    return torch.matmul(x, w)


def paged_attention(q, pool, tables, page_pos, seq_lens, *, window=0,
                    impl="auto"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial ``(acc, m, l)`` of decode attention over the anchored pages
    ``tables [B, pps]`` names in one layer's pool ``[P, page, 2, Hkv,
    hd]``."""
    if resolve(impl, q) == "cuda":
        forward_only("paged_attention", q, pool)
        return _attn.paged_attention(q, pool, tables, page_pos, seq_lens,
                                     window=window)
    return _ref.paged_attention_ref(q, pool, tables, page_pos, seq_lens,
                                    window=window)


def ktls_attention(q, kv, amax=None, *, impl="auto") -> torch.Tensor:
    """The kTLS-analogue bench's decode attention ``softmax(q k^T) v`` of
    ``q [B, Hq, hd]`` over every key of ``kv [B, ctx, 2, Hkv, hd]``, no
    scale, no mask; int8 ``kv`` with ``amax [B, ctx, 2, Hkv, 1]`` is
    dequantised inside the kernel's read."""
    if resolve(impl, q) == "cuda":
        forward_only("ktls_attention", q, kv)
        return _ktls.ktls_attention(q, kv, amax)
    return _ref.ktls_attention_ref(q, kv, amax)


def ktls_dequant(kq, amax, *, impl="auto") -> torch.Tensor:
    """``float(kq) * amax / 127`` into a new float32 tensor: the bench's
    separate dequantise pass."""
    if resolve(impl, kq) == "cuda":
        return _ktls.ktls_dequant(kq, amax)
    return _ref.ktls_dequant_ref(kq, amax)


def mlstm_scan(q, k, v, log_i, log_f, *, chunk=64, impl="auto",
               return_state=False):
    """Stabilised chunkwise mLSTM from the zero state: ``h [B, H, S, dh]``
    of ``q``/``k``/``v [B, H, S, dh]`` and the gates ``log_i``/``log_f
    [B, H, S]`` (``log_f`` log-sigmoided), and with ``return_state`` also
    the final ``(C [B, H, dh, dh], n [B, H, dh], m [B, H])``. ``'ref'`` is
    the plain chunked version; the JAX package's ``'ref'`` is the
    sequential oracle, which is :func:`ref.mlstm_scan_ref` here."""
    if resolve(impl, q) == "cuda":
        forward_only("mlstm_scan", q, k, v, log_i, log_f)
        out, state = _mlstm.mlstm_scan(q, k, v, log_i, log_f, chunk=chunk)
    else:
        out, state = _ref.mlstm_chunked_ref(q, k, v, log_i, log_f,
                                            chunk=chunk)
    return (out, state) if return_state else out


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
    out)``. ``n_buffers`` is the kernel's ring depth, as it is the TPU
    kernel's VMEM staging depth: 0 runs the kernel's default depth, 2 and
    up that many slots; 1 and negative values raise ``ValueError`` on
    every device. The plain version computes the same at any depth."""
    del donate_pool
    _k.ring_depth(n_buffers)
    kw = dict(meta_max=meta_max, keystream=keystream,
              tx_keystream=tx_keystream, cond_off=cond_off, cond_lo=cond_lo,
              cond_hi=cond_hi, live=live, meta_ks=meta_ks)
    if resolve(impl, pool) == "cuda":
        return _k.fused_round(stream, meta_len, total_len, pool, tables,
                              n_buffers=n_buffers, **kw)
    return _ref.fused_round_ref(stream, meta_len, total_len, pool, tables,
                                **kw)
