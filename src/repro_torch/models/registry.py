"""Model registry of the port: config -> model instance, plus the
dry-run input contract.

The dense, ``moe``, ``hybrid`` and ``vlm`` families build a
``TransformerLM``, the ``ssm`` family (xLSTM) an ``XLSTMModel`` and the
``encdec`` family (whisper) an ``EncDecModel``.

``input_specs(cfg, shape, mesh)`` returns meta-device tensors (the
counterpart of JAX's ``ShapeDtypeStruct``) for every input of the step
function a dry-run cell runs: the reference's shapes and dtypes, no
allocation.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.types import MeshSpec, ModelConfig, ShapeSpec

PAGE_SIZE = 64  # tokens per anchored KV page (A.5 granularity matching)


def build_model(cfg: ModelConfig, page_size: int = PAGE_SIZE,
                attn_impl: str = "auto", mlstm_impl: str = "auto"):
    """``page_size`` and ``attn_impl`` (the attention kernels' ``ops``
    impl) apply to the ``TransformerLM`` and ``EncDecModel`` families,
    ``mlstm_impl`` (the mLSTM scan's) to the ``ssm`` family."""
    if cfg.family == "ssm":
        from repro_torch.models.xlstm_model import XLSTMModel

        return XLSTMModel(cfg, mlstm_impl=mlstm_impl)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecModel

        return EncDecModel(cfg, page_size, attn_impl=attn_impl)
    from repro_torch.models.transformer import TransformerLM

    return TransformerLM(cfg, page_size, attn_impl=attn_impl)


def count_params_from_config(cfg: ModelConfig,
                             active_only: bool = False) -> int:
    """Parameters of ``cfg``'s model; with ``active_only``, a ``moe``
    config counts only the ``top_k`` routed experts a token reaches (the
    padded experts are inactive too), as the JAX package counts."""
    total = build_model(cfg).param_count()
    if active_only and cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        total -= (cfg.padded_experts - cfg.top_k) * per_expert * cfg.num_layers
    return total


# ---------------------------------------------------------------------------
# dry-run input specs
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def decode_layout(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshSpec,
                  page_size: int = PAGE_SIZE) -> Dict[str, int]:
    """Static paged-pool geometry for a decode cell."""
    data = mesh.axis_size("pod") * mesh.axis_size("data")
    model_ax = mesh.axis_size("model")
    if shape.global_batch % max(data, 1) == 0 and data > 1:
        n_shards = model_ax
    else:
        n_shards = mesh.num_devices
    pages_per_seq = -(-shape.seq_len // page_size) + 1  # +1 for the new token
    pps = -(-pages_per_seq // n_shards)
    total_pages = shape.global_batch * n_shards * pps
    # round up so every device gets an equal slice
    total_pages = -(-total_pages // mesh.num_devices) * mesh.num_devices
    return {"n_shards": n_shards, "pps": pps, "total_pages": total_pages,
            "page_size": page_size}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshSpec,
                page_size: int = PAGE_SIZE) -> Dict[str, Any]:
    """Meta-tensor tree for the step function of (cfg, shape)."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16

    if shape.kind == "train":
        if cfg.family == "vlm":
            st = s - cfg.img_tokens
            return {"tokens": _sds((b, st), i32), "labels": _sds((b, st), i32),
                    "img_embeds": _sds((b, cfg.img_tokens, cfg.d_model), bf16)}
        if cfg.family == "encdec":
            return {"tokens": _sds((b, s), i32), "labels": _sds((b, s), i32),
                    "frames": _sds((b, cfg.enc_frames, cfg.d_model), bf16)}
        return {"tokens": _sds((b, s), i32), "labels": _sds((b, s), i32)}

    model = build_model(cfg, page_size)

    if cfg.family == "ssm":
        state = {k: _sds(v, f32)
                 for k, v in model.decode_state_shapes(b).items()}
        if shape.kind == "prefill":
            return {"tokens": _sds((b, s), i32), "seq_lens": _sds((b,), i32)}
        return {"tokens": _sds((b,), i32), "seq_lens": _sds((b,), i32),
                "state": state}

    lay = decode_layout(cfg, shape, mesh, page_size)
    nsh, pps, total = lay["n_shards"], lay["pps"], lay["total_pages"]
    pool = _sds(model.kv_pool_shape(total), bf16)
    tables = _sds((b, nsh, pps), i32)

    if shape.kind == "prefill":
        specs = {
            "tokens": _sds((b, s if cfg.family != "vlm"
                            else s - cfg.img_tokens), i32),
            "seq_lens": _sds((b,), i32),
            "pool": pool,
            "tables": tables,
            "token_shard": _sds((b, s), i32),
            "token_slot": _sds((b, s), i32),
            "token_off": _sds((b, s), i32),
            "token_valid": _sds((b, s), torch.bool),
        }
        if cfg.family == "vlm":
            specs["img_embeds"] = _sds((b, cfg.img_tokens, cfg.d_model), bf16)
        if cfg.family == "encdec":
            specs["frames"] = _sds((b, cfg.enc_frames, cfg.d_model), bf16)
        return specs

    # decode
    specs = {
        "tokens": _sds((b,), i32),
        "seq_lens": _sds((b,), i32),
        "pool": pool,
        "tables": tables,
        "page_pos": _sds((b, nsh, pps), i32),
        "write_shard": _sds((b,), i32),
        "write_slot": _sds((b,), i32),
    }
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        specs["ssm_state"] = {
            "ssm": _sds((cfg.num_layers, b, d_inner, cfg.ssm_state), f32),
            "conv": _sds((cfg.num_layers, b, cfg.ssm_conv - 1, d_inner), f32),
        }
    if cfg.family == "encdec":
        specs["cross_kv"] = _sds(model.cross_kv_shape(b), bf16)
    return specs
