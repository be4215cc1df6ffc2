"""Multi-pod dry-run.

For every (architecture × input shape × mesh) cell this runs the real step
function (a training step for train shapes, prefill or a decode step for
serving shapes) once on rank 0 of the production mesh, single-pod (16×16
= 256 devices) or multi-pod (2×16×16 = 512 devices), and records, per
device, its memory, the operations it ran (FLOPs, HBM bytes, collective
bytes; ``roofline/op_analysis``) and the roofline terms on an H100
(``roofline/hw``) into one JSON per cell.

How the 512 devices are simulated. The JAX package lowers and compiles
the step on 512 placeholder host devices without running it. Here the
default process group is PyTorch's fake group (:func:`fake_process_group`:
rank 0 of ``world_size`` ranks that do not exist; a collective returns at
once and moves nothing), and every tensor is a fake CPU tensor
(``FakeTensorMode``: shapes, dtypes and placements, no storage). The
parameters and inputs are DTensors placed by the same rules as the
reference's shardings, so every operation runs at the local shapes of
rank 0 and every collective DTensor needs is issued. Being CPU tensors,
the attention kernels take their plain versions (``impl='auto'``), as the
reference's CPU lowering counts its jnp oracles. This is the dry-run's
design, not a fallback: on cards the same code runs the CUDA kernels over
NCCL. Memory comes from ``MemTracker``: ``argument_bytes`` (the local
parameters, optimizer state and inputs), ``temp_bytes`` (its peak less
the arguments), ``output_bytes`` (the returned tensors and the donated
inputs the step writes in place) and ``alias_bytes`` (those donated
inputs).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape decode_32k --multipod single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod both] [--skip-existing]
"""
import argparse
import contextlib
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.sharding import (
    DEFAULT_RULES,
    STRATEGIES,
    mesh_axis_names,
    mesh_size,
    placements_for,
    spec_for,
    tree_shardings,
    use_mesh,
    use_rules,
)
from repro_torch.common.types import (
    SHAPES_BY_NAME,
    MeshSpec,
    ModelConfig,
    ShapeSpec,
)
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.attention import plan_decode_sharding
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.registry import build_model, input_specs
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.op_analysis import OpCounter, in_dtensor_propagation
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_update
from repro_torch.training.train_loop import _grad_as_param

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """The default process group as rank 0 of ``world_size`` simulated
    ranks (PyTorch's fake backend), destroyed on exit. Collectives on it
    return at once. The one place the port reaches into
    ``torch.testing._internal``, where PyTorch keeps the fake store."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.name == "long_500k" and cfg.has_full_attention:
        return ("full-attention architecture: long_500k requires sub-quadratic "
                "attention (skip recorded per assignment; see DESIGN.md)")
    return None


def cell_strategy(cfg: ModelConfig, shape: ShapeSpec, n_devices: int) -> str:
    """A cell's sharding strategy (a key of ``STRATEGIES``): serving shapes
    take ``fsdp_tp``; a train shape takes ``REPRO_SHARDING`` when set, by
    default ``fsdp2d`` where the batch gives each device a sample (else
    the model axis replicates it) and the family is not ``moe`` (whose
    experts need the model axis), and ``fsdp_tp`` otherwise."""
    if shape.kind != "train":
        return "fsdp_tp"
    fits_2d = shape.global_batch % n_devices == 0
    default = "fsdp_tp" if (cfg.family == "moe" or not fits_2d) else "fsdp2d"
    return os.environ.get("REPRO_SHARDING", default)


def _batch_shardings(specs: Dict[str, Any], mesh, batch_axis,
                     rules=None) -> Dict[str, Any]:
    """Placements for a dry-run input-spec dict (batch dim 0 unless
    pool)."""
    all_axes = tuple(mesh_axis_names(mesh))

    def batch_spec(sds):
        if rules is not None:
            return placements_for(spec_for(
                sds.shape, ("batch",) + (None,) * (len(sds.shape) - 1), mesh,
                rules), mesh)
        return placements_for((batch_axis,), mesh)

    def shard_one(key, sds):
        if key == "pool":
            return placements_for((None, all_axes), mesh)
        if key == "cross_kv":  # layer-stacked [L, B, ...]: batch is dim 1
            return placements_for((None, batch_axis), mesh)
        if key in ("state", "ssm_state"):  # handled a level up
            return None
        return batch_spec(sds)

    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out[k] = {kk: placements_for((None, batch_axis), mesh) for kk in v}
        else:
            out[k] = shard_one(k, v)
    return out


def _abstract_adamw(abs_params) -> AdamWState:
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      tree_map(lambda p: torch.empty_like(p, dtype=torch.float32),
                               abs_params),
                      tree_map(lambda p: torch.empty_like(p, dtype=torch.float32),
                               abs_params))


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple:
    """Returns ``(fn, args, placements, donate)``: the step function, its
    arguments as meta tensors (trees), their placements (matching trees)
    and the positions of the arguments it writes in place."""
    model = build_model(cfg)
    names = tuple(mesh_axis_names(mesh))
    mesh_spec = MeshSpec(tuple(mesh.shape), names)
    tp = mesh_spec.axis_size("model")
    specs = input_specs(cfg, shape, mesh_spec)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    batch_axis = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    if shape.kind == "train":
        rules = STRATEGIES[cell_strategy(cfg, shape, mesh_size(mesh))]()
        abs_params = model.abstract_params(torch.float32)
        p_sh = tree_shardings(abs_params, model.param_axes(), mesh, rules=rules)
        opt = _abstract_adamw(abs_params)
        o_sh = AdamWState(placements_for((), mesh), p_sh, p_sh)
        b_sh = _batch_shardings(specs, mesh, batch_axis, rules=rules)
        opt_cfg = AdamWConfig(schedule=cfg.lr_schedule)
        remat = os.environ.get("REPRO_REMAT", "full")

        def train_step(params, opt_state, batch):
            for p in tree_leaves(params):
                p.requires_grad_(True)
            loss, metrics = model.loss_fn(params, batch, remat=remat,
                                          tp_size=tp)
            loss.backward()
            grads = tree_map(_grad_as_param, params)
            with torch.no_grad():
                _p, _o, om = adamw_update(opt_cfg, params, grads, opt_state)
            return {"loss": metrics["loss"].detach(), **om}

        return (train_step, (abs_params, opt, specs), (p_sh, o_sh, b_sh),
                (0, 1))

    # serving cells use bf16 params with pure tensor-parallel sharding:
    # FSDP weight all-gathers are amortised over a whole batch in training
    # but are pure overhead per decode step
    serve_rules = dict(DEFAULT_RULES)
    serve_rules["fsdp"] = ()
    abs_params = model.abstract_params(torch.bfloat16)
    p_sh = tree_shardings(abs_params, model.param_axes(), mesh,
                          rules=serve_rules)
    b_axis, combine = plan_decode_sharding(shape.global_batch, mesh)
    sh = _batch_shardings(specs, mesh, b_axis)
    kw = dict(mesh=mesh, batch_axis=b_axis, combine_axes=combine)

    if cfg.family == "ssm":
        if shape.kind == "prefill":
            def fn(params, tokens, seq_lens):
                return model.prefill(params, tokens, seq_lens)
            args = (abs_params, specs["tokens"], specs["seq_lens"])
            return (fn, args, (p_sh, sh["tokens"], sh["seq_lens"]), ())

        def fn(params, tokens, seq_lens, state):
            return model.decode_step(params, tokens, seq_lens, state)
        args = (abs_params, specs["tokens"], specs["seq_lens"], specs["state"])
        return (fn, args, (p_sh, sh["tokens"], sh["seq_lens"], sh["state"]),
                (3,))

    if shape.kind == "prefill":
        names = ["tokens", "seq_lens", "pool", "tables", "token_shard",
                 "token_slot", "token_off", "token_valid"]
        extra = []
        if cfg.family == "vlm":
            extra = ["img_embeds"]
        if cfg.family == "encdec":
            extra = ["frames"]

        def fn(params, *a):
            kwa = dict(zip(names + extra, a))
            pos = [kwa[n] for n in names]
            if cfg.family == "vlm":
                return model.prefill(params, *pos, img_embeds=kwa["img_embeds"],
                                     tp_size=tp, **kw)
            if cfg.family == "encdec":
                return model.prefill(params, *pos, kwa["frames"], tp_size=tp,
                                     **kw)
            return model.prefill(params, *pos, tp_size=tp, **kw)

        args = (abs_params,) + tuple(specs[n] for n in names + extra)
        shards = (p_sh,) + tuple(sh[n] for n in names + extra)
        return (fn, args, shards, (3,))  # the pool, written in place

    # decode
    names = ["tokens", "seq_lens", "pool", "tables", "page_pos",
             "write_shard", "write_slot"]
    if cfg.family == "encdec":
        def fn(params, tokens, seq_lens, pool, tables, page_pos, wsh, wsl,
               cross_kv):
            return model.decode_step(params, tokens, seq_lens, pool, tables,
                                     page_pos, wsh, wsl, cross_kv, **kw)
        names = names + ["cross_kv"]
        donate = (3,)
    elif cfg.family == "hybrid":
        def fn(params, tokens, seq_lens, pool, tables, page_pos, wsh, wsl,
               ssm_state):
            return model.decode_step(params, tokens, seq_lens, pool, tables,
                                     page_pos, wsh, wsl, ssm_state=ssm_state,
                                     **kw)
        names = names + ["ssm_state"]
        donate = (3, 8)
    else:
        def fn(params, tokens, seq_lens, pool, tables, page_pos, wsh, wsl):
            return model.decode_step(params, tokens, seq_lens, pool, tables,
                                     page_pos, wsh, wsl, **kw)
        donate = (3,)
    args = (abs_params,) + tuple(specs[n] for n in names)
    shards = (p_sh,) + tuple(sh[n] for n in names)
    return (fn, args, shards, donate)


def build_dense_baseline(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple:
    """The paper's 'standard stack' at production scale: contiguous KV
    [L, B, Smax, 2, Hkv, hd] re-materialised every step (undonated) + full
    logits shipped to the host. Sharded (batch->data, seq->model) — the
    best the dense layout can do."""
    model = build_model(cfg)
    serve_rules = dict(DEFAULT_RULES)
    serve_rules["fsdp"] = ()
    abs_params = model.abstract_params(torch.bfloat16)
    p_sh = tree_shardings(abs_params, model.param_axes(), mesh,
                          rules=serve_rules)
    b, s = shape.global_batch, shape.seq_len
    names = tuple(mesh_axis_names(mesh))
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    batch_axis = data_axes if len(data_axes) > 1 else data_axes[0]
    cache = torch.empty((cfg.num_layers, b, s + 128, 2, cfg.num_kv_heads,
                         cfg.head_dim), dtype=torch.bfloat16, device="meta")
    cache_sh = placements_for((None, batch_axis, "model"), mesh)
    tok_sh = placements_for((batch_axis,), mesh)

    def fn(params, tokens, seq_lens, kv_cache):
        # undonated: the copy tax
        return model.decode_step_dense(params, tokens, seq_lens, kv_cache)

    tok = torch.empty((b,), dtype=torch.int32, device="meta")
    return (fn, (abs_params, tok, tok, cache), (p_sh, tok_sh, tok_sh, cache_sh),
            ())


# ---------------------------------------------------------------------------
# running a cell
# ---------------------------------------------------------------------------

def _map2(fn, tree, placements):
    """``fn(leaf, placements)`` over a tree of dicts and ``NamedTuple``s."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], placements[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, a, b) for a, b in zip(tree, placements)))
    return fn(tree, placements)


def materialize(arg, placements, mesh):
    """A meta-tensor tree as fake DTensors on ``mesh`` (call under the
    dry-run's ``FakeTensorMode``)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, pl):
        return distribute_tensor(torch.zeros(x.shape, dtype=x.dtype), mesh, pl)

    return _map2(one, arg, placements)


def _flat(x) -> list:
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in _flat(a)]
    return [x] if isinstance(x, torch.Tensor) else []


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _flat(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _mem_tracker():
    """A ``MemTracker`` that skips DTensor's shape inference (see
    ``op_analysis.marking_dtensor_propagation``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if in_dtensor_propagation():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def run_step(fn, args, placements, donate, mesh) -> Dict[str, Any]:
    """Run one step on fake DTensors: ``{"costs", "memory", "trace_s"}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as fake:
        real_args = tuple(materialize(a, p, mesh)
                          for a, p in zip(args, placements))
        arg_bytes = _local_bytes(real_args)
        donated = _local_bytes([real_args[i] for i in donate])
        tracker = _mem_tracker()
        tracker.track_external(*_flat(real_args))
        counter = OpCounter(fake)
        t0 = time.time()
        with counter, tracker, use_mesh(mesh):
            out = fn(*real_args)
        trace_s = time.time() - t0
        peak = max((snap["Total"] for snap in
                    tracker.get_tracker_snapshot("peak").values()), default=0)
        out_bytes = _local_bytes(out)
    temp = max(peak - arg_bytes, 0)
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes + donated,
        "temp_bytes": temp,
        "alias_bytes": donated,
        # arguments + outputs + temporaries - aliased, as the reference's
        "peak_estimate_bytes": arg_bytes + out_bytes + temp,
    }
    return {"costs": counter.costs, "memory": memory, "trace_s": trace_s}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = RESULTS_DIR, dense_baseline: bool = False) -> Dict:
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    pod = "multipod" if multi_pod else "singlepod"
    cell = f"{arch}__{shape_name}__{pod}"
    if dense_baseline:
        cell += "__dense-baseline"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell + ".json")
    # DTensor's choice of collectives, and so the counted collective
    # bytes, differ between torch versions
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": pod,
                           "torch": torch.__version__, "ok": False}

    reason = skip_reason(cfg, shape)
    if reason:
        rec.update({"ok": True, "skipped": True, "reason": reason})
        _write(rec, out_path)
        return rec

    try:
        with fake_process_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            strategy = cell_strategy(cfg, shape, mesh_size(mesh))
            with use_rules(STRATEGIES[strategy]()):
                if dense_baseline:
                    fn, args, shards, donate = build_dense_baseline(
                        cfg, shape, mesh)
                else:
                    fn, args, shards, donate = build_cell(cfg, shape, mesh)
                res = run_step(fn, args, shards, donate, mesh)
            n_chips = mesh_size(mesh)
        rec["sharding_strategy"] = strategy
        rec["remat"] = os.environ.get("REPRO_REMAT", "full") \
            if shape.kind == "train" else None
        costs = res["costs"]
        mf = model_flops(cfg, shape)
        terms = roofline_terms(costs, mf, n_chips)
        rec.update({
            "ok": True,
            "trace_s": round(res["trace_s"], 2),
            "n_chips": int(n_chips),
            "memory": res["memory"],
            # the reference's key for the per-device counts; here they
            # come from the op counter, not from HLO
            "hlo": {
                "flops_per_device": costs.flops,
                "hbm_bytes_per_device": costs.hbm_bytes,
                "collective_bytes_naive": costs.collective_naive,
                "collective_bytes_ring": costs.collective_ring,
                "collective_breakdown": costs.collective_breakdown,
                "collective_count": costs.collective_count,
            },
            "roofline": terms.as_dict(),
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    _write(rec, out_path)
    return rec


def _write(rec: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + ["all"],
                    help="architecture id")
    ap.add_argument("--shape", default="all",
                    choices=list(SHAPES_BY_NAME) + ["all"])
    ap.add_argument("--multipod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--dense-baseline", action="store_true",
                    help="run the standard-stack dense decode instead")
    args = ap.parse_args(argv)
    # DTensor warns at every redistribution over two mesh axes at once
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    archs = ARCHS if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multipod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                cell = f"{arch}__{shape}__{'multipod' if mp else 'singlepod'}"
                path = os.path.join(args.out, cell + ".json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("ok"):
                        print(f"[skip] {cell}")
                        continue
                t0 = time.time()
                rec = run_cell(arch, shape, mp, args.out,
                               dense_baseline=args.dense_baseline)
                status = "SKIP" if rec.get("skipped") else (
                    "OK" if rec["ok"] else "FAIL")
                extra = ""
                if rec.get("roofline"):
                    r = rec["roofline"]
                    extra = (f" dom={r['dominant']} comp={r['compute_s']:.4f}s"
                             f" mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s"
                             f" useful={r['useful_ratio']:.2f}")
                if not rec["ok"]:
                    failures += 1
                    extra = " " + rec.get("error", "")[:160]
                print(f"[{status}] {cell} ({time.time()-t0:.0f}s){extra}",
                      flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
