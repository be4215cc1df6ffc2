"""Work counts against counts by hand on small cases."""
from types import SimpleNamespace

import pytest

from perfbench.harness import Step
from perfbench.metrics import (kv_pool_used_pct, profiler_slowdown,
                               roofline, step_mfu_pct)
from perfbench.trace import TraceSummary
from perfbench.work import flash_attention, model, paged_attention

M = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 4,
     "num_kv_heads": 2, "head_dim": 2, "d_ff": 16, "vocab_size": 10}


def test_paged_attention_by_hand():
    flops, moved = paged_attention.launch(M, [3, 5])
    assert flops == 4 * 3 * 4 * 2 + 4 * 5 * 4 * 2
    # K/V: 8 positions x 2 x 2 heads x 2 x 4 B; q and out: 2 rows x 4
    # heads x (2 + 2 + 2) x 4 B
    assert moved == 8 * 2 * 2 * 2 * 4 + 2 * 4 * 6 * 4


def test_flash_attention_by_hand():
    flops, moved = flash_attention.launch(M, [3])
    assert flops == 4 * 4 * 2 * (1 + 2 + 3)
    assert moved == 3 * (4 + 4 + 2 + 2) * 2 * 4


def test_model_flops_by_hand():
    # q, k, v, o: 8*2*(4+2+2+4) = 192; swiglu 3*8*16 = 384
    assert model.token_flops(M, 3) == 2 * (2 * (192 + 384) + 4 * 3 * 4 * 2)
    assert model.head_flops(M) == 2 * 8 * 10
    moe = dict(M, family="moe", expert_d_ff=4, num_experts=6, top_k=2,
               num_shared_experts=2)
    # router 8*6, 2 experts of 3*8*4, shared 3*8*8, its gate 8
    ffn = 48 + 2 * 96 + 192 + 8
    assert model.token_flops(moe, 1) == 2 * (2 * (192 + ffn) + 4 * 1 * 4 * 2)


def _ctx(steps, ops, plain=()):
    peaks = {"hbm_bytes_per_s": 100.0, "tf32_flops_per_s": 1000.0}
    from perfbench import harness
    return SimpleNamespace(model=M, steps=list(plain), trace_steps=steps,
                           peaks=peaks, trace=TraceSummary(1.0, 0.5, ops),
                           work=lambda k: harness.module("work", k))


def test_roofline_sums_bounds_over_kernel_time():
    st = Step(0, 1, 2, [], 0, [3, 5])
    flops, moved = paged_attention.launch(M, [3, 5])
    bound = max(moved / 100.0, flops / 1000.0)
    ops = [("void libra::paged_attention_kernel<2>", 4 * bound)] * 2
    assert roofline(_ctx([st], ops), "paged_attention") == pytest.approx(25.0)
    # a launch the steps do not account for: no share
    assert roofline(_ctx([st], ops[:1]), "paged_attention") is None
    assert roofline(_ctx([], []), "paged_attention") is None


def test_roofline_counts_the_profiled_steps_only():
    st = Step(0, 1, 2, [], 0, [3, 5])
    flops, moved = paged_attention.launch(M, [3, 5])
    ops = [("paged_attention_kernel", max(moved / 100.0, flops / 1000.0))] * 2
    # the measured window's steps launch under no profiler: not counted
    ctx = _ctx([st], ops, plain=[st, st])
    assert roofline(ctx, "paged_attention") == pytest.approx(100.0)


def test_profiler_slowdown_is_the_ratio_of_decode_spans():
    plain = [Step(0, 1, 2, [], 0, [3], decode_s=0.02),
             Step(1, 2, 2, [4], 16, [], prefill_s=0.5),
             Step(2, 3, 2, [], 0, [4], decode_s=0.04)]
    profiled = [Step(0, 1, 2, [], 0, [5], decode_s=0.09)]
    assert profiler_slowdown.read(_ctx(profiled, [], plain)) == \
        pytest.approx(3.0)
    assert profiler_slowdown.read(_ctx([], [], plain)) is None


def test_pool_used_is_the_mean_over_steps():
    plain = [Step(0, 1, 1, [], 0, [3], pool_used=0.5),
             Step(1, 2, 1, [], 0, [4], pool_used=1.0)]
    assert kv_pool_used_pct.read(_ctx([], [], plain)) == pytest.approx(75.0)
    assert kv_pool_used_pct.read(_ctx([], [], [])) is None


def test_step_mfu_reads_the_measured_window():
    plain = [Step(0, 1, 2, [2], 16, [3])]
    ctx = _ctx([Step(0, 1, 2, [], 0, [9] * 50)], [], plain)
    ctx.tokens, ctx.window_s = 2, 4.0
    flops = (model.token_flops(M, 1) + model.token_flops(M, 2)
             + model.token_flops(M, 3) + 2 * model.head_flops(M))
    assert step_mfu_pct.read(ctx) == pytest.approx(100 * flops / 4.0 / 1000.0)
