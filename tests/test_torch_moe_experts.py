"""The serving paths' dropless MoE layer (``models/moe.moe_ffn_dropless``)
and its grouped expert kernel (``ops.moe_experts``, ``csrc/moe_experts.cu``).

On the CPU: the plain version (``ref.moe_experts_ref``) against a loop over
tokens, the shared expert taken whole there and as its blocks here; an
overload planted on one expert, which the capacity dispatch drops and the
dropless layer does not; a group prefill whose padding rows take no entry,
read from the ``model.moe`` span's counters; the router's unnormalised
gates; the q/k/v biases. On the card (the tests skip without a CUDA
device): the kernel against a float64 oracle at ragged groups, within 4x
of the float32 plain version's error; one launch a layer a prefill and a
decode step; the wrapper's refusals."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.common import tracing
from repro_torch.common.types import ModelConfig
from repro_torch.kernels import moe_experts as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import LibraEngine

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = ModelConfig(name="moe-small", family="moe", num_layers=2, d_model=32,
                  num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=128,
                  expert_d_ff=16, num_experts=6, num_shared_experts=2,
                  top_k=2, qkv_bias=True, norm_topk=False)


def _layer(cfg, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(s.shape, generator=g) / s.shape[-2] ** 0.5
                ).to(device) for k, s in tmoe.moe_template(cfg).items()}


def _route(p, x, cfg, valid=None, impl="auto"):
    """``ops.moe_route`` of one layer: ``(xs, offsets, gates, dest)``."""
    s = cfg.num_shared_experts
    return ops.moe_route(x @ p["router"], x,
                         p["shared_gate_proj"] if s else None, valid,
                         num_experts=cfg.num_experts, top_k=cfg.top_k,
                         num_shared=s, norm_topk=cfg.norm_topk, impl=impl)


def _per_token(p, x, cfg):
    """Each token alone: its ``top_k`` experts by the router, weighted by
    their probabilities, and the whole shared expert (``_shared_expert``,
    one product over its ``S F`` width)."""
    out = []
    for row in x:
        probs = torch.softmax((row @ p["router"])[:cfg.num_experts], -1)
        g, ids = probs.topk(cfg.top_k)
        if cfg.norm_topk:
            g = g / g.sum()
        y = sum(gi * (F.silu(row @ p["w_gate"][e]) * (row @ p["w_up"][e]))
                @ p["w_down"][e] for gi, e in zip(g, ids.tolist()))
        if cfg.num_shared_experts:
            y = y + tmoe._shared_expert(p, row[None])[0]
        out.append(y)
    return torch.stack(out)


@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("shared", [0, 2])
def test_dropless_layer_is_each_token_alone(shared, norm_topk):
    """The plain version's groups, the shared expert's blocks and the
    combine give each token what it gets alone."""
    cfg = dataclasses.replace(CFG, num_shared_experts=shared,
                              norm_topk=norm_topk, expert_pad_to=8)
    p = _layer(cfg, 1)
    x = torch.randn(37, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = tmoe.moe_ffn_dropless(p, x, cfg)
    torch.testing.assert_close(got, _per_token(p, x, cfg), **TOL)


def test_oracle_groups_and_shared_blocks():
    """``moe_route_ref`` and ``moe_experts_ref``: group ``g < E`` is expert
    ``g``, group ``E + s`` the shared expert's block ``s``, each entry holds
    its row of x, is weighted by its gate and written to its row in token
    order."""
    p = _layer(CFG, 3)
    x = torch.randn(9, CFG.d_model, generator=torch.Generator().manual_seed(4))
    xs, offsets, gates, dest = _route(p, x, CFG)
    width = CFG.top_k + CFG.num_shared_experts
    off = offsets.tolist()
    assert off[0] == 0 and off[-1] == 9 * width
    assert torch.equal(xs, x[dest // width])
    y = ops.moe_experts(xs, offsets, gates, dest, p["w_gate"], p["w_up"],
                        p["w_down"], p["shared_gate"], p["shared_up"],
                        p["shared_down"])
    f = CFG.expert_d_ff
    for g in range(len(off) - 1):
        for r in range(off[g], off[g + 1]):
            row = xs[r]
            if g < CFG.num_experts:
                wg, wu, wd = p["w_gate"][g], p["w_up"][g], p["w_down"][g]
            else:
                cols = slice((g - CFG.num_experts) * f,
                             (g - CFG.num_experts + 1) * f)
                wg, wu, wd = (p["shared_gate"][:, cols],
                              p["shared_up"][:, cols],
                              p["shared_down"][cols])
            want = gates[r] * ((F.silu(row @ wg) * (row @ wu)) @ wd)
            torch.testing.assert_close(y[dest[r]], want, **TOL)


def test_planted_overload_drops_nothing():
    """Every row routed to the same two experts: the capacity dispatch at
    the serving factor 2.0 drops entries, the dropless layer none."""
    cfg = dataclasses.replace(CFG, num_shared_experts=0)
    p = _layer(cfg, 5)
    p["router"][:, :2] = 0.0
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(6))
    x[:, 0] = 0.0
    p["router"][0, :2] = torch.tensor([40.0, 39.0])
    x[:, 0] = 1.0          # experts 0 and 1 top every row
    _g, ids = tmoe.router_topk(x @ p["router"], cfg)
    assert (ids.sort(-1).values == torch.tensor([0, 1])).all()
    cap = tmoe.expert_capacity(64, cfg, 2.0)
    plan = tmoe.dispatch_plan(ids, cfg, cap, 0, cfg.padded_experts)
    assert int(plan.kept.sum()) == 2 * cap < 64 * cfg.top_k   # drops
    want = _per_token(p, x, cfg)
    torch.testing.assert_close(tmoe.moe_ffn_dropless(p, x, cfg), want, **TOL)
    capped = tmoe.moe_ffn(p, x, cfg, capacity_factor=2.0)
    assert (capped - want).abs().max() > 1e-2


def test_unrouted_rows_give_zeros():
    p = _layer(CFG, 7)
    x = torch.randn(10, CFG.d_model, generator=torch.Generator().manual_seed(8))
    valid = torch.arange(10) < 6
    _xs, offsets, _g, _d = _route(p, x, CFG, valid)
    assert int(offsets[-1]) == 6 * (CFG.top_k + CFG.num_shared_experts)
    got = tmoe.moe_ffn_dropless(p, x, CFG, valid=valid)
    assert (got[6:] == 0).all()
    torch.testing.assert_close(got[:6], _per_token(p, x[:6], CFG), **TOL)


def test_norm_topk_false_keeps_the_probabilities():
    logits = torch.randn(5, 6, generator=torch.Generator().manual_seed(9))
    probs = torch.softmax(logits, -1)
    raw, ids = tmoe.router_topk(logits, CFG)
    torch.testing.assert_close(raw, probs.gather(1, ids))
    normed, ids2 = tmoe.router_topk(logits,
                                    dataclasses.replace(CFG, norm_topk=True))
    assert torch.equal(ids, ids2)
    torch.testing.assert_close(normed, raw / raw.sum(-1, keepdim=True))


def test_qkv_bias_joins_the_template_and_the_products():
    model = build_model(CFG, page_size=8)
    t = model.layer_template()
    assert t["bq"].shape == (CFG.q_dim,) and t["bk"].shape == (CFG.kv_dim,)
    assert "bq" not in build_model(dataclasses.replace(
        CFG, qkv_bias=False), page_size=8).layer_template()
    params = model.init_params(0, device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items() if k != "moe"}
    h = torch.randn(3, CFG.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(3)
    q0, k0, v0 = model._qkv(lp, h, pos)
    for name in ("bq", "bk", "bv"):
        lp[name] = torch.full_like(lp[name], 0.5)
    q1, k1, v1 = model._qkv(lp, h, pos)
    torch.testing.assert_close(v1, v0 + 0.5)
    assert (q1 - q0).abs().max() > 0.1 and (k1 - k0).abs().max() > 0.1


def test_group_prefill_padding_takes_no_entry(monkeypatch):
    """A Libra group prefill of prompts of 21 and 7 tokens (padded to 24):
    on every ``model.moe`` span the real rows are routed, ``entries`` is
    ``top_k`` of them and the padding is counted as skipped; the decode
    steps route every row of the batch."""
    model = build_model(CFG, page_size=8)
    params = model.init_params(2, device="cpu")
    eng = LibraEngine(model, params, max_batch=2, max_len=48, page_size=8,
                      device="cpu")
    entries = []
    inner = ops.moe_experts

    def counted(xs, offsets, *a, **kw):
        entries.append(int(offsets[-1]))
        return inner(xs, offsets, *a, **kw)

    rng = np.random.default_rng(3)
    for n in (21, 7):
        eng.submit(rng.integers(1, 120, n).astype(np.int32), max_new_tokens=3)
    monkeypatch.setattr(ops, "moe_experts", counted)
    tracing.enable()
    try:
        tracing.drain()
        eng.run()
    finally:
        tracing.disable()
    spans = [r for r in tracing.drain() if r.name == "model.moe"]
    layers, k = CFG.num_layers, CFG.top_k
    prefill, decode = spans[:layers], spans[layers:]
    assert [s.attrs for s in prefill] == [
        {"rows": 28, "entries": 28 * k, "skipped_rows": 2 * 24 - 28}] * layers
    assert len(decode) == 2 * layers
    assert all(s.attrs == {"rows": 2, "entries": 2 * k, "skipped_rows": 0}
               for s in decode)
    width = k + CFG.num_shared_experts
    assert entries == [28 * width] * layers + [2 * width] * 2 * layers


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only there")
    return torch.device("cuda")


def _groups(sizes, shared_rows, s, dev):
    counts = torch.tensor(list(sizes) + [shared_rows] * s, device=dev)
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()


def _dest(n, dev, seed):
    """A permutation of ``n`` rows: where each entry's output goes."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed)
                          ).to(dev)


@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("rows,pad,shared", [(128, 0, 4), (3000, 64, 4),
                                              (777, 8, 0)])
def test_routing_kernels_make_the_plain_entries(card, rows, pad, shared,
                                                norm_topk):
    """The routing kernels against the plain version: the same offsets,
    each group the same entries (in any order), each entry its row of x,
    its gate and its place in token order; rows not routed make none."""
    cfg = dataclasses.replace(CFG, d_model=2048, num_experts=60,
                              expert_pad_to=60 + pad, top_k=4,
                              num_shared_experts=shared, norm_topk=norm_topk)
    p = {k: v for k, v in _layer(cfg, 17, card).items()
         if k in ("router", "shared_gate_proj")}
    g = torch.Generator(device=card).manual_seed(18)
    x = torch.randn((rows, cfg.d_model), generator=g, device=card)
    valid = torch.rand((rows,), generator=g, device=card) < 0.8
    got = _route(p, x, cfg, valid)
    want = _route(p, x, cfg, valid, impl="ref")
    assert torch.equal(got[1], want[1])
    n = int(want[1][-1])
    off = want[1].tolist()
    for a, b in zip(off, off[1:]):
        assert torch.equal(got[3][a:b].sort().values, want[3][a:b])
    order = got[3][:n].argsort()
    gd, wd = got[3][:n][order], want[3][:n].sort()
    assert torch.equal(gd, wd.values)
    torch.testing.assert_close(got[2][:n][order], want[2][:n][wd.indices],
                               atol=1e-6, rtol=1e-5)
    assert torch.equal(got[0][:n][order], want[0][:n][wd.indices])


def test_routing_notes_the_experts_reached(card):
    """Each routing call notes in the device's ring how many routed
    experts its entries reach (the groups below E with an entry), in call
    order; the shared blocks and unrouted rows count nothing."""
    cfg = dataclasses.replace(CFG, d_model=2048, num_experts=60,
                              expert_pad_to=64, top_k=4,
                              num_shared_experts=4)
    p = {k: v for k, v in _layer(cfg, 19, card).items()
         if k in ("router", "shared_gate_proj")}
    g = torch.Generator(device=card).manual_seed(20)
    want = []
    for rows in (1, 3, 128, 4096):
        x = torch.randn((rows, cfg.d_model), generator=g, device=card)
        valid = torch.arange(rows, device=card) < max(1, rows - 2)
        off = _route(p, x, cfg, valid)[1][:cfg.num_experts + 1]
        want.append(int((off[1:] > off[:-1]).sum()))
    assert want[0] == 4 and want[-1] == 60
    assert kmoe.experts_reached(4) == want
    assert kmoe.experts_reached(kmoe.RING + 1) is None


@pytest.mark.parametrize("shared", [0, 4])
@pytest.mark.parametrize("d,f", [(2048, 1408), (260, 100)])
def test_kernel_against_float64(card, d, f, shared):
    """Groups of 0, 1, 63, 64, 65 and 4096 rows (the 64-row wgmma tile's
    edges, a group over many tiles) and empty experts: within 4x of the
    float32 plain version's error from a float64 oracle."""
    e = 8
    sizes = [0, 1, 63, 64, 65, 4096, 0, 2]
    cfg = dataclasses.replace(CFG, d_model=d, expert_d_ff=f, num_experts=e,
                              num_shared_experts=shared)
    p = _layer(cfg, 11, card)
    offsets = _groups(sizes, 300, shared, card)
    g = torch.Generator(device=card).manual_seed(12)
    n = int(offsets[-1]) + 5                   # rows past the groups
    xs = torch.randn((n, d), generator=g, device=card)
    gates = torch.rand((n,), generator=g, device=card)
    dest = _dest(n, card, 15)
    sh = ((p["shared_gate"], p["shared_up"], p["shared_down"])
          if shared else ())
    args = (xs, offsets, gates, dest, p["w_gate"], p["w_up"], p["w_down"],
            *sh)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = ref.moe_experts_ref(*(t.double() if t.is_floating_point() else t
                                 for t in args))
    got = ops.moe_experts(*args)
    plain = ref.moe_experts_ref(*args)
    torch.cuda.synchronize()
    rows = dest[:n - 5]                        # the rows the groups write
    err = (got[rows].double() - want[rows]).abs().max().item()
    assert err <= 4 * (plain[rows].double() - want[rows]).abs().max().item(), \
        err


def test_serving_launches_once_a_layer(card):
    """A Libra run of the small config on the card: one launch of the
    experts a layer a prefill and a decode step (and one routing call),
    and the kernels' tokens are the plain version's."""
    model = build_model(dataclasses.replace(CFG, d_model=64, head_dim=16,
                                            expert_d_ff=32), page_size=8)
    params = model.init_params(4, device=card)
    calls = []

    def counted(kind, fn):
        def call(*a, **kw):
            n0 = dict(kmoe.LAUNCHES)
            out = fn(*a, **kw)
            n = {k: v - n0[k] for k, v in kmoe.LAUNCHES.items()}
            assert n["moe_route"] == n["moe_experts"]
            calls.append((kind, n["moe_experts"]))
            return out
        return call

    outs = {}
    for impl in ("auto", "ref"):
        model.attn_impl = impl
        model.prefill = counted(("prefill", impl),
                                type(model).prefill.__get__(model))
        model.decode_step = counted(("decode", impl),
                                    type(model).decode_step.__get__(model))
        eng = LibraEngine(model, params, max_batch=2, max_len=64, page_size=8,
                          device=card)
        rng = np.random.default_rng(5)
        reqs = [eng.submit(rng.integers(1, 120, n).astype(np.int32),
                           max_new_tokens=4) for n in (30, 11)]
        eng.run()
        outs[impl] = [r.output for r in reqs]
    layers = model.cfg.num_layers
    cuda = [c for c in calls if c[0][1] == "auto"]
    assert cuda[0] == (("prefill", "auto"), layers)
    assert all(c == (("decode", "auto"), layers) for c in cuda[1:])
    assert all(c[1] == 0 for c in calls if c[0][1] == "ref")
    assert outs["auto"] == outs["ref"]


def test_wrapper_refuses(card):
    p = _layer(CFG, 13, card)
    xs = torch.randn(6, CFG.d_model, device=card)
    offsets = _groups([2, 1, 0, 0, 0, 0], 3, 2, card)
    gates = torch.rand(6, device=card)
    dest = _dest(6, card, 16)
    sh = (p["shared_gate"], p["shared_up"], p["shared_down"])
    with pytest.raises(TypeError):
        ops.moe_experts(xs, offsets.long(), gates, dest, p["w_gate"],
                        p["w_up"], p["w_down"], *sh)
    with pytest.raises(TypeError):
        ops.moe_experts(xs, offsets, gates, dest.int(), p["w_gate"],
                        p["w_up"], p["w_down"], *sh)
    with pytest.raises(ValueError, match="shape"):
        ops.moe_experts(xs, offsets[:-1], gates, dest, p["w_gate"],
                        p["w_up"], p["w_down"], *sh)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.moe_experts(xs.clone().requires_grad_(), offsets, gates, dest,
                        p["w_gate"], p["w_up"], p["w_down"], *sh)
    odd = dataclasses.replace(CFG, expert_d_ff=18)
    q = _layer(odd, 14, card)
    with pytest.raises(ValueError, match="multiples of 4"):
        ops.moe_experts(xs, offsets, gates, dest, q["w_gate"], q["w_up"],
                        q["w_down"], q["shared_gate"], q["shared_up"],
                        q["shared_down"])
