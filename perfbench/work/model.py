"""The model's operations for a token, for ``step_mfu_pct``: every layer's
matrix products and attention over the token's context, and the head for
each token served. A ``moe`` layer counts its router over the real experts,
the ``top_k`` routed experts and the shared expert with its gate; never
the capacity slots or the padded experts."""
from __future__ import annotations


def layer_matmul_params(m) -> float:
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (2 * m["num_heads"] + 2 * m["num_kv_heads"])
    if m["family"] == "moe":
        f = m["expert_d_ff"]
        ffn = (d * m["num_experts"] + m["top_k"] * 3 * d * f
               + 3 * d * f * m["num_shared_experts"] + d)
    else:
        ffn = 3 * d * m["d_ff"]
    return float(attn + ffn)


def token_flops(m, ctx: int) -> float:
    """One token through every layer, attending over ``ctx`` positions."""
    per_layer = 2 * layer_matmul_params(m) + 4.0 * ctx * m["num_heads"] * m["head_dim"]
    return m["num_layers"] * per_layer


def head_flops(m) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]
