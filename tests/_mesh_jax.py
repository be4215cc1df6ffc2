"""The JAX package's side of ``tests/test_torch_mesh.py``, on two forced
host devices. Run as a script in its own process (the device count is
fixed when jax starts)::

    python tests/_mesh_jax.py <case dir>

It reads ``inputs.npz`` (made by the test), runs each case on a
``(data=1, model=2)`` mesh (a 2-wide ``pod`` axis for ``compressed_psum``,
``(data=2, model=1)`` for the ``Trainer``) and writes ``jax.npz``."""
import functools
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from _mesh_cases import (  # noqa: E402
    DECODE_ARCH,
    MOE_ARCH,
    PAGE,
    TRAIN_ARCH,
    TRAIN_BATCH,
    TRAIN_OPT,
    TRAIN_SEQ,
    TRAIN_STEPS,
    decode_layout,
    unflatten,
)
from repro.common.sharding import (  # noqa: E402
    DEFAULT_RULES,
    make_mesh,
    shard_map,
    tree_shardings,
)
from repro.configs import get_reduced  # noqa: E402
from repro.core.anchor_pool import AnchorPool  # noqa: E402
from repro.data.pipeline import DataPipeline, SyntheticCorpus  # noqa: E402
from repro.models import attention as attn  # noqa: E402
from repro.models.moe import moe_ffn  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.training.optimizer import AdamWConfig, compressed_psum  # noqa: E402
from repro.training.train_loop import Trainer  # noqa: E402


def main(case_dir: str) -> None:
    inp = dict(np.load(os.path.join(case_dir, "inputs.npz")))
    out = {}
    mesh = make_mesh((1, 2), ("data", "model"))
    serve_rules = dict(DEFAULT_RULES)
    serve_rules["fsdp"] = ()

    # -- the flash-decode combine: one paged_decode_attention call -------
    b_axis, combine = attn.plan_decode_sharding(2, mesh)
    with mesh:
        o, pool = jax.jit(lambda *a: attn.paged_decode_attention(
            *a, mesh=mesh, batch_axis=b_axis, combine_axes=combine))(
            *(jnp.asarray(inp[f"attn_{k}"]) for k in (
                "q", "k", "v", "pool", "tables", "page_pos", "seq_lens",
                "wsh", "wsl")))
    out["attn_out"], out["attn_pool"] = np.asarray(o), np.asarray(pool)

    # -- prefill + three decode steps of the reduced dense model ---------
    cfg = get_reduced(DECODE_ARCH)
    model = build_model(cfg, page_size=PAGE)
    params = unflatten({k[len("dec_p/"):]: v for k, v in inp.items()
                        if k.startswith("dec_p/")})
    p_sh = tree_shardings(model.abstract_params(jnp.float32),
                          model.param_axes(), mesh, rules=serve_rules)
    params = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                          params, p_sh)
    lens, seqs, alloc = decode_layout(AnchorPool)
    tables, page_pos = alloc.tables_for(seqs, 3)
    pool = jnp.zeros(model.kv_pool_shape(alloc.total_pages), jnp.float32)
    pool = jax.device_put(pool, NamedSharding(mesh, P(None, ("data", "model"))))
    kw = dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine,
              compute_dtype=jnp.float32)
    with mesh:
        first, pool = jax.jit(lambda p, *a: model.prefill(p, *a, **kw))(
            params, inp["dec_tokens"], np.array(lens, np.int32), pool,
            tables, *alloc.token_coords(seqs, inp["dec_tokens"].shape[1]))
        cur = np.asarray(first).astype(np.int32)
        toks = [cur]
        step = jax.jit(lambda p, *a: model.decode_step(p, *a, **kw))
        for i in range(3):
            pos = np.array(lens, np.int32) + i
            wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 2, PAGE)
            nxt, pool, _ = step(params, cur, pos, pool, tables, page_pos,
                                wsh, wsl)
            cur = np.asarray(nxt).astype(np.int32)
            toks.append(cur)
    out["dec_tokens_out"] = np.stack(toks)
    out["dec_pool"] = np.asarray(pool)

    # -- the expert-parallel MoE FFN --------------------------------------
    mcfg = get_reduced(MOE_ARCH)
    mp = unflatten({k[len("moe_p/"):]: v for k, v in inp.items()
                    if k.startswith("moe_p/")})
    with mesh:
        out["moe_out"] = np.asarray(jax.jit(lambda p, x: moe_ffn(
            p, x, mcfg, capacity_factor=2.0))(mp, jnp.asarray(inp["moe_x"])))

    # -- compressed_psum over a 2-wide pod axis ---------------------------
    pod = make_mesh((2,), ("pod",))
    g = {"w": jnp.asarray(inp["cp_g"])}             # [2, 64, 64], a row a device
    err = {"w": jnp.zeros_like(g["w"])}

    def f(g, e):
        g = {"w": g["w"][0]}
        e = {"w": e["w"][0]}
        red, new_e = compressed_psum(g, "pod", e)
        return {"w": red["w"][None]}, {"w": new_e["w"][None]}

    red, new_e = shard_map(f, mesh=pod, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"), P("pod")),
                           check_vma=False)(g, err)
    out["cp_mean"], out["cp_err"] = np.asarray(red["w"]), np.asarray(new_e["w"])

    # -- the Trainer on (data=2, model=1), every product in float32 -----
    tmodel = build_model(get_reduced(TRAIN_ARCH))
    tmodel.forward = functools.partial(tmodel.forward,
                                       compute_dtype=jnp.float32)
    logits = tmodel.logits
    tmodel.logits = lambda p, h, compute_dtype=None: logits(p, h, jnp.float32)
    pipe = DataPipeline(SyntheticCorpus(tmodel.cfg.vocab_size, seed=1),
                        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    trainer = Trainer(tmodel, AdamWConfig(**TRAIN_OPT), pipe,
                      mesh=make_mesh((2, 1), ("data", "model")), seed=0)
    out["train_f32_jax"] = np.array(
        [h["loss"] for h in trainer.train(TRAIN_STEPS)])
    np.savez(os.path.join(case_dir, "jax.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
