"""Shared inputs of ``tests/test_torch_mesh.py``'s two-device cases: the
JAX side (``_mesh_jax.py``) and the port's ranks (``_mesh_ranks.py``) read
the same ``inputs.npz``. Imports neither jax nor torch."""
import numpy as np

DECODE_ARCH = "phi3-mini-3.8b"
MOE_ARCH = "qwen2-moe-a2.7b"
PAGE = 8
#: pages a shard holds, of the two shards of the ``model`` axis
PAGES_PER_SHARD = 12
LENS = [13, 20]
#: the trainer case: reduced libra-proxy, its batches and AdamW
TRAIN_ARCH = "libra-proxy-125m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 32, 3
TRAIN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=200)
#: the JAX trainer's checkpoint at step 0, under the case directory
JAX_CKPT = "jax_ckpt"


def decode_layout(anchor_pool_cls):
    """``(lens, seqs, alloc)``: two prompts' pages striped over the two
    shards, each with room for three decode steps."""
    alloc = anchor_pool_cls(2, PAGES_PER_SHARD, PAGE)
    seqs = [alloc.alloc_sequence(n + 3) for n in LENS]
    return LENS, seqs, alloc


def flatten(tree, prefix=""):
    """``{"a/b": leaf}`` of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *path, last = key.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[last] = v
    return out


def make_inputs(anchor_pool_cls, dec_params, moe_params, vocab: int,
                d_model: int):
    """The cases' numpy inputs from a seed (``dec_params`` / ``moe_params``
    are numpy trees of the reduced models' weights)."""
    rng = np.random.default_rng(29)
    lens, seqs, alloc = decode_layout(anchor_pool_cls)
    tables, page_pos = alloc.tables_for(seqs, 3)
    pos = np.array(lens, np.int32)
    wsh, wsl = anchor_pool_cls.write_coords(seqs, pos.tolist(), 2, PAGE)
    hq, hkv, hd = 4, 2, 16
    inp = {
        "attn_q": rng.standard_normal((2, hq, hd)).astype(np.float32),
        "attn_k": rng.standard_normal((2, hkv, hd)).astype(np.float32),
        "attn_v": rng.standard_normal((2, hkv, hd)).astype(np.float32),
        "attn_pool": rng.standard_normal(
            (alloc.total_pages, PAGE, 2, hkv, hd)).astype(np.float32),
        "attn_tables": tables, "attn_page_pos": page_pos,
        "attn_seq_lens": pos, "attn_wsh": wsh, "attn_wsl": wsl,
        "dec_tokens": np.stack([
            np.pad(rng.integers(1, vocab - 1, n), (0, 24 - n))
            for n in lens]).astype(np.int32),
        "moe_x": rng.standard_normal((16, d_model)).astype(np.float32),
        "cp_g": rng.standard_normal((2, 64, 64)).astype(np.float32),
    }
    inp.update({f"dec_p/{k}": v for k, v in flatten(dec_params).items()})
    inp.update({f"moe_p/{k}": v for k, v in flatten(moe_params).items()})
    return inp
