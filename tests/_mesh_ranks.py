"""The port's side of ``tests/test_torch_mesh.py``: one of two ``gloo``
ranks on the CPU. Run as a script, once a rank::

    python tests/_mesh_ranks.py <rank> <port> <case dir>

It reads ``inputs.npz``, runs each case on a ``(data=1, model=2)`` mesh
(and the trainer on ``(data=2, model=1)``), and rank 0 writes
``torch.npz`` and ``torch.json``."""
import datetime
import functools
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from _mesh_cases import (
    DECODE_ARCH,
    JAX_CKPT,
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
import repro_torch.configs as tconfigs
from repro_torch.common.sharding import (
    DEFAULT_RULES,
    distribute_tree,
    make_mesh,
    tree_shardings,
    use_mesh,
)
from repro_torch.core.anchor_pool import AnchorPool
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.models import attention as attn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import param_axes, tree_map
from repro_torch.models.moe import moe_ffn, moe_template
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig, compressed_psum
from repro_torch.training.train_loop import Trainer


def _dt(x, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.as_tensor(x), mesh, placements)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def attention_case(inp, mesh, out):
    """One sharded ``paged_decode_attention`` call: DTensor inputs, and
    this rank's local shards."""
    b_axis, combine = attn.plan_decode_sharding(2, mesh)
    bpl = attn.batch_placements(mesh, b_axis)
    names = ("q", "k", "v", "pool", "tables", "page_pos", "seq_lens", "wsh",
             "wsl")
    args = [inp[f"attn_{n}"] for n in names]
    d_args = [_dt(a, mesh, attn.pool_placements(mesh) if n == "pool"
                  else bpl) for n, a in zip(names, args)]
    with torch.no_grad():
        o = attn.paged_decode_attention(*d_args, mesh=mesh, batch_axis=b_axis,
                                        combine_axes=combine)
    out["attn_out"] = _full(o).numpy()
    out["attn_pool"] = _full(d_args[3]).numpy()
    # the same on plain tensors: this rank's pages only
    r = dist.get_rank()
    n = args[3].shape[0] // 2
    local = [torch.as_tensor(a) for a in args]
    local[3] = local[3][r * n:(r + 1) * n].clone()
    with torch.no_grad():
        o2 = attn.paged_decode_attention(*local, mesh=mesh,
                                         batch_axis=b_axis,
                                         combine_axes=combine)
    out["attn_out_local"] = o2.numpy()


def decode_case(inp, mesh, out):
    """Prefill and three decode steps of the reduced dense model on
    DTensors (the parameters tensor-parallel over ``model``)."""
    cfg = tconfigs.get_reduced(DECODE_ARCH)
    model = build_model(cfg, page_size=PAGE, attn_impl="ref")
    jp = unflatten({k[len("dec_p/"):]: v for k, v in inp.items()
                    if k.startswith("dec_p/")})
    serve = dict(DEFAULT_RULES)
    serve["fsdp"] = ()
    params = distribute_tree(
        params_from_jax(jp, model, device="cpu"),
        tree_shardings(model.abstract_params(), model.param_axes(), mesh,
                       serve), mesh)
    b_axis, combine = attn.plan_decode_sharding(2, mesh)
    bpl = attn.batch_placements(mesh, b_axis)
    lens, seqs, alloc = decode_layout(AnchorPool)
    tables, page_pos = alloc.tables_for(seqs, 3)
    from repro_torch.common.sharding import placements_for

    pool = _dt(torch.zeros(model.kv_pool_shape(alloc.total_pages)), mesh,
               placements_for((None, ("data", "model")), mesh))
    kw = dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine)
    tok = inp["dec_tokens"]
    coords = alloc.token_coords(seqs, tok.shape[1])
    first = model.prefill(params, _dt(tok, mesh, bpl),
                          _dt(np.array(lens, np.int32), mesh, bpl), pool,
                          _dt(tables, mesh, bpl),
                          *(_dt(c, mesh, bpl) for c in coords), **kw)
    cur = _full(first).numpy().astype(np.int32)
    toks = [cur]
    for i in range(3):
        pos = np.array(lens, np.int32) + i
        wsh, wsl = AnchorPool.write_coords(seqs, pos.tolist(), 2, PAGE)
        nxt = model.decode_step(params, *(_dt(a, mesh, bpl) for a in (
            cur, pos)), pool, *(_dt(a, mesh, bpl) for a in (
                tables, page_pos, wsh, wsl)), **kw)
        cur = _full(nxt).numpy().astype(np.int32)
        toks.append(cur)
    out["dec_tokens_out"] = np.stack(toks)
    out["dec_pool"] = _full(pool).numpy()


def moe_case(inp, mesh, out):
    """The expert-parallel ``moe_ffn`` (experts over ``model``), and the
    one-device path on the same inputs."""
    cfg = tconfigs.get_reduced(MOE_ARCH)
    p = tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                 unflatten({k[len("moe_p/"):]: v for k, v in inp.items()
                            if k.startswith("moe_p/")}))
    x = torch.from_numpy(inp["moe_x"])
    tmpl = moe_template(cfg)
    dp = distribute_tree(p, tree_shardings(
        tree_map(lambda s: torch.empty(s.shape, device="meta"), tmpl),
        param_axes(tmpl), mesh), mesh)
    from torch.distributed.tensor import Replicate

    with torch.no_grad(), use_mesh(mesh):
        o = moe_ffn(dp, _dt(x, mesh, [Replicate(), Replicate()]), cfg,
                    capacity_factor=2.0)
    out["moe_out"] = _full(o).numpy()
    with torch.no_grad():
        out["moe_out_one_device"] = moe_ffn(p, x, cfg,
                                            capacity_factor=2.0).numpy()


def compression_case(inp, out):
    g = {"w": torch.from_numpy(inp["cp_g"][dist.get_rank()])}
    red, err = compressed_psum(g, None, {"w": torch.zeros_like(g["w"])})
    out["cp_mean"] = red["w"].numpy()
    out["cp_err"] = err["w"].numpy()


def _trainer(mesh, f32: bool, ckpt=None):
    cfg = tconfigs.get_reduced(TRAIN_ARCH)
    model = build_model(cfg)
    if f32:   # the same steps with every product in float32
        model.forward = functools.partial(model.forward,
                                          compute_dtype=torch.float32)
        logits = model.logits
        model.logits = lambda p, h, **kw: logits(p, h)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab_size, seed=1),
                        batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    return Trainer(model, AdamWConfig(**TRAIN_OPT), pipe, seed=0,
                   checkpoint_dir=ckpt, device="cpu", mesh=mesh)


def trainer_case(out_json, case_dir):
    """The ``(data=2, model=1)`` trainer against the one-device run, in
    bfloat16 and in float32, and in float32 from the JAX trainer's
    checkpoint at step 0 (its parameters), resumed onto the mesh."""
    mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
    for f32 in (False, True):
        tag = "f32" if f32 else "bf16"
        t = _trainer(mesh, f32)
        out_json[f"train_{tag}_mesh"] = [h["loss"] for h in
                                         t.train(TRAIN_STEPS)]
        out_json[f"train_{tag}_placements"] = str(
            t.params["layers"]["wq"].placements)
        t1 = _trainer(None, f32)
        out_json[f"train_{tag}_one"] = [h["loss"] for h in
                                        t1.train(TRAIN_STEPS)]
    t = _trainer(mesh, True, ckpt=os.path.join(case_dir, JAX_CKPT))
    assert t.resume() and t.step == 0
    out_json["train_f32_mesh_from_jax"] = [h["loss"] for h in
                                           t.train(TRAIN_STEPS)]


def main(rank: int, port: int, case_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = dict(np.load(os.path.join(case_dir, "inputs.npz")))
        mesh = make_mesh((1, 2), ("data", "model"), device_type="cpu")
        out, out_json = {}, {}
        attention_case(inp, mesh, out)
        decode_case(inp, mesh, out)
        moe_case(inp, mesh, out)
        compression_case(inp, out)
        out[f"cp_mean_rank{rank}"] = out["cp_mean"]
        out[f"cp_err_rank{rank}"] = out["cp_err"]
        trainer_case(out_json, case_dir)
        np.savez(os.path.join(case_dir, f"torch{rank}.npz"), **out)
        if rank == 0:
            with open(os.path.join(case_dir, "torch.json"), "w") as f:
                json.dump(out_json, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
