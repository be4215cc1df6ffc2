"""The ``qwen2-moe-a2.7b`` configuration on the CPU: its file against the
port's template, the plain reference (``reference/moe.py``) against the
port's ``LibraEngine`` at a reduced size, the reference's near-tie rule,
and the grouped expert kernel's work count and metric readers on synthetic
traces."""
import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import harness, testing, weights
from perfbench.harness import Step
from perfbench.metrics import moe_experts_busy_pct, moe_experts_roofline
from perfbench.reference import moe as moe_ref
from perfbench.trace import TraceSummary
from perfbench.work import moe_experts

ROOT = Path(__file__).resolve().parents[1]
NAME = "qwen2-moe-a2.7b"
#: the reduced size: every mechanism of the published config (q/k/v bias,
#: unnormalised top-k gates, a shared expert) at the registry's reduced
#: widths, 6 experts unpadded, top-2
SMALL = {"name": NAME, "family": "moe", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 4, "head_dim": 16, "d_ff": 0,
         "expert_d_ff": 32, "num_experts": 6, "expert_pad_to": 0,
         "num_shared_experts": 2, "top_k": 2, "vocab_size": 256,
         "rope_theta": 1000000.0, "norm_eps": 1e-06,
         "tie_embeddings": False, "act": "swiglu", "qkv_bias": True,
         "norm_topk": False}


def small_config():
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model

    config = copy.deepcopy(harness.load_json("configs", NAME))
    config["model"] = dict(SMALL)
    config["params"] = testing.layout_of(
        build_model(ModelConfig(**SMALL), 16).template())
    config["check"] = {"served_logit_gap_max": 1e-4}
    return config


def test_the_file_is_the_template_at_published_widths():
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model

    config = harness.load_json("configs", NAME)
    model = build_model(ModelConfig(**config["model"]), 16)
    weights.check_layout(config["params"], model.template())
    assert model.param_count() == config["param_count"] == 7_469_058_048
    m = config["model"]
    assert (m["num_layers"], m["num_experts"], m["expert_pad_to"],
            m["top_k"], m["qkv_bias"], m["norm_topk"]) == \
        (12, 60, 0, 4, True, False)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in spec["workloads"]}[f"{NAME}.chat"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (NAME, "chat", 1)


def test_engine_logits_are_the_references(monkeypatch):
    """Each request alone through ``LibraEngine`` (prefill, then decode
    steps through the paged cache): the logits of every served token are
    the reference's full forward pass's to 1e-4, the float32 bar of the
    port's JAX twins: both compute in float32 and differ only in the order
    of their sums (grouped expert products against one loop a token's
    experts, the attention's)."""
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LibraEngine

    config = small_config()
    model = build_model(ModelConfig(**SMALL), 16)
    params = weights.draw(config["params"], 2 ** 31 + 7, "cpu")
    seen = []
    logits = model.logits

    def recorded(*a, **kw):
        out = logits(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(model, "logits", recorded)
    rng = np.random.default_rng(3)
    for n in (37, 9, 70):
        eng = LibraEngine(model, params, max_batch=1, max_len=96,
                          page_size=16, device="cpu")
        r = eng.submit(rng.integers(0, 256, n).astype(np.int32),
                       max_new_tokens=6)
        seen.clear()
        eng.run()
        got = torch.cat(seen)
        case = {"group": [r.prompt], "row": 0, "served": r.output,
                "decode_rows": 1}
        want = moe_ref.served_logits(params, config["model"],
                                     config["serving"], case)
        assert got.shape == want.shape == (6, 256)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_served_tokens_agree_with_the_reference(seed):
    """The harness's whole cell at the reduced size, groups of 4 clients:
    every judged token within 1e-5 of the reference's best."""
    out = testing.serve_cpu(small_config(), testing.tiny_mix(), seed)
    c = out["compared"]["served_logit_gap_max"]
    assert c["tokens"] >= 8 and c["requests"] == 4
    assert c["value"] <= 1e-5


def test_near_ties_keep_the_nearer_logits(monkeypatch):
    """With every routing taken as near a tie, each judged position is run
    again with its experts swapped in each layer, and every token of the
    vocabulary keeps its least gap over those routings: the served tokens
    and any other (the control's) alike. The TF32 pass, in a program's
    place, routes by its own logits."""
    config = small_config()
    params = weights.draw(config["params"], 11, "cpu")
    rng = np.random.default_rng(4)
    case = {"group": [rng.integers(0, 256, 20)], "row": 0,
            "served": rng.integers(0, 256, 5).tolist(), "decode_rows": 1}
    args = (params, config["model"], config["serving"], case)

    def gaps(logits):
        return logits.max(-1, keepdim=True).values - logits   # [n, V]

    monkeypatch.setattr(moe_ref, "SCALE", 0.0)
    moe_ref.reset_ties()
    plain_logits = moe_ref.served_logits(*args)
    plain = gaps(plain_logits)
    assert moe_ref.TIES["positions"] == 0
    monkeypatch.setattr(moe_ref, "SCALE", 1e30)
    kept_logits = moe_ref.served_logits(*args)
    kept = gaps(kept_logits)
    assert moe_ref.TIES == {"positions": 5, "layers": 5 * SMALL["num_layers"]}
    assert (kept <= plain).all() and (kept < plain).any()
    assert torch.equal(kept_logits.max(-1).values,
                       plain_logits.max(-1).values)
    with moe_ref.common.matmul_precision(True):
        control = gaps(moe_ref.served_logits(*args))
        monkeypatch.setattr(moe_ref, "SCALE", 0.0)
        control_plain = gaps(moe_ref.served_logits(*args))
    assert moe_ref.TIES["positions"] == 5
    assert torch.equal(control, control_plain)
    torch.testing.assert_close(control, plain, atol=1e-5, rtol=0)


def test_the_reference_computes_in_float64(monkeypatch):
    """Every product of the reference is in float64 from the float32
    weights, and its logits come back in float32; the control's products
    are in float32."""
    config = small_config()
    params = weights.draw(config["params"], 13, "cpu")
    rng = np.random.default_rng(5)
    case = {"group": [rng.integers(0, 256, 12)], "row": 0,
            "served": rng.integers(0, 256, 4).tolist(), "decode_rows": 1}
    seen = []
    mm = moe_ref.mm

    def recorded(x, w):
        seen.append((x.dtype, w.dtype))
        return mm(x, w)

    monkeypatch.setattr(moe_ref, "mm", recorded)
    logits = moe_ref.served_logits(params, config["model"],
                                   config["serving"], case)
    assert logits.dtype == torch.float32 and logits.shape == (4, 256)
    assert seen and set(seen) == {(torch.float64, torch.float32),
                                  (torch.float64, torch.bfloat16)}
    seen.clear()
    with moe_ref.common.matmul_precision(True):
        control = moe_ref.served_logits(params, config["model"],
                                        config["serving"], case)
    assert control.dtype == torch.float32
    assert {x for x, _w in seen} == {torch.float32}


def test_the_rule_flags_few_positions_at_float32_widths():
    """The bound at the published width (2048 terms, unit-scale rows, the
    router at 1 / sqrt(2048)): a tie within it is rare, where Higham's
    worst-case gamma_n would be 45 times wider."""
    g = torch.Generator().manual_seed(5)
    n, e, k = 2048, 60, 4
    h = torch.randn((4096, n), generator=g)
    w = torch.randn((n, e), generator=g) / math.sqrt(n)
    m = {"router": w}
    lp = {"moe": dict(m, w_gate=torch.zeros(e, n, 1), w_up=torch.zeros(
        e, n, 1), w_down=torch.zeros(e, 1, n))}
    model = {"top_k": k, "num_experts": e, "num_shared_experts": 0}
    _out, near = moe_ref.experts(lp, h, model)
    share = near.float().mean().item()
    assert 0 < share < 0.01, share
    assert moe_ref.rms_bound(n) * math.sqrt(n) == pytest.approx(n * moe_ref.U)


def test_the_reference_loads_nothing_of_the_port():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", "import sys, perfbench.reference.moe\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "repro_torch" not in res.stdout and "'repro'" not in res.stdout


# ---- the kernel's work count and readers ------------------------------------

M = {"family": "moe", "num_layers": 2, "d_model": 8, "expert_d_ff": 4,
     "num_experts": 6, "num_shared_experts": 2, "top_k": 2}
#: two prefill steps (5 and 3 + 4 real rows, the second with its decode
#: half) and a decode step of two rows
STEPS = [Step(0, 1, 1, [5], 16, []), Step(1, 2, 2, [3, 4], 16, [6]),
         Step(2, 3, 2, [], 0, [7, 5])]


def _ctx(ops, peaks, busy=0.5):
    return SimpleNamespace(model=M, steps=[], trace_steps=STEPS, peaks=peaks,
                           trace=TraceSummary(1.0, busy, ops),
                           work=lambda k: harness.module("work", k))


#: the routed experts each of the window's 8 launches reached, as the
#: port's ring would give them
REACHED = [5, 5, 6, 2, 2, 2, 3, 4]


def test_counts_by_hand(monkeypatch):
    seen = []
    monkeypatch.setattr(moe_experts, "reached",
                        lambda n: seen.append(n) or list(REACHED))
    got = moe_experts.launches(_ctx([], {}))
    assert seen == [8]
    # a launch a layer a prefill and a decode step: rows 5; 7 then 1; 2
    d, f, k, sf = 8, 4, 2, 8
    want = []
    rows = [r for r in (5, 7, 1, 2) for _layer in range(2)]
    for r, e in zip(rows, REACHED):
        flops = 6.0 * k * r * d * f + 6.0 * r * d * sf
        want.append((flops, 4.0 * (3 * d * f * e + 3 * d * sf + 2 * r * d)))
    assert got == want
    # no ring to read (no card, or a program without it): nothing counted
    monkeypatch.setattr(moe_experts, "reached", lambda n: None)
    assert moe_experts.launches(_ctx([], {})) == []


def test_the_ring_is_read_from_the_port_and_absent_on_the_cpu():
    """The port's ring exists only on a card: none on the CPU."""
    from repro_torch.kernels import moe_experts as kmoe

    assert kmoe.experts_reached(8, torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert moe_experts.reached(8) is None


def test_split_kernel_reads_at_most_a_third(monkeypatch):
    monkeypatch.setattr(moe_experts, "reached", lambda n: list(REACHED))
    peaks = {"hbm_bytes_per_s": 1e15, "tf32_flops_per_s": 1e3}
    counted = moe_experts.launches(_ctx([], peaks))
    name = "libra::moe::moe_experts_kernel(libra::moe::Params)"
    at_ceiling = [(name, 3 * fl / 1e3) for fl, _b in counted]
    share = moe_experts_roofline.read(_ctx(at_ceiling, peaks))
    assert share == pytest.approx(100 / 3)
    assert moe_experts_roofline.read(_ctx(at_ceiling[1:], peaks)) is None


def test_bytes_bound_launches_read_their_reached_experts(monkeypatch):
    """Where bytes bound every launch, the share is the reached experts'
    bytes over the time: a launch that reaches fewer experts counts fewer
    bytes, so a kernel that reads only those cannot pass 100 %."""
    monkeypatch.setattr(moe_experts, "reached", lambda n: list(REACHED))
    peaks = {"hbm_bytes_per_s": 1e3, "tf32_flops_per_s": 1e30}
    counted = moe_experts.launches(_ctx([], peaks))
    name = "libra::moe::moe_experts_kernel(libra::moe::Params)"
    at_bound = [(name, b / 1e3) for _f, b in counted]
    assert moe_experts_roofline.read(_ctx(at_bound, peaks)) == \
        pytest.approx(100.0)
    monkeypatch.setattr(moe_experts, "reached", lambda n: [6] * n)
    assert moe_experts_roofline.read(_ctx(at_bound, peaks)) > 100.0


def test_busy_share_and_a_trace_without_the_kernel():
    name = "libra::moe::moe_experts_kernel(libra::moe::Params)"
    ops = [(name, 0.1), (name, 0.05), ("paged_attention_kernel", 0.2)]
    assert moe_experts_busy_pct.read(_ctx(ops, {}, busy=0.5)) == \
        pytest.approx(30.0)
    parent = [("void libra::paged_attention_kernel<128>", 1e-3)] * 4
    peaks = {"hbm_bytes_per_s": 1e12, "tf32_flops_per_s": 1e3}
    assert moe_experts_busy_pct.read(_ctx(parent, peaks)) is None
    assert moe_experts_roofline.read(_ctx(parent, peaks)) is None
