"""The prefill projections' work count (``work/linear_f32.py``) against a
count by hand, and ``linear_f32_roofline`` on synthetic traces."""
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.harness import Step
from perfbench.metrics import linear_f32_roofline
from perfbench.trace import TraceSummary
from perfbench.work import linear_f32

M = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 4,
     "num_kv_heads": 2, "head_dim": 2, "d_ff": 16, "vocab_size": 10,
     "act": "swiglu"}
#: two prefill steps (5 and 3 + 4 real rows) and a decode step
STEPS = [Step(0, 1, 1, [5], 16, []), Step(1, 2, 2, [3, 4], 16, [6]),
         Step(2, 3, 2, [], 0, [7, 5])]


def _ctx(ops, peaks):
    return SimpleNamespace(model=M, steps=[], trace_steps=STEPS, peaks=peaks,
                           trace=TraceSummary(1.0, 0.5, ops),
                           work=lambda k: harness.module("work", k))


def test_counts_by_hand():
    ctx = _ctx([], {})
    got = linear_f32.launches(ctx)
    # 7 launches a layer (wq, wk, wv, wo, w_gate, w_up, w_down), 2 layers,
    # 2 prefill steps; the decode step launches none
    assert len(got) == 7 * 2 * 2
    # (K, N): q 4 x 2 = 8, kv 2 x 2 = 4
    kn = [(8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)]
    want = []
    for rows in (5, 7):
        want += [(2.0 * rows * k * n, 4.0 * (rows * k + k * n + rows * n))
                 for k, n in kn] * 2
    assert got == want


def test_ffn_launches_follow_the_family():
    gelu = dict(M, act="gelu")
    moe = dict(M, family="moe")
    assert len(linear_f32.shapes(gelu)) == 6
    assert linear_f32.shapes(moe) == [(8, 8), (8, 4), (8, 4), (8, 8)]


def test_roofline_reads_nothing_without_the_kernel():
    """The parent's trace holds no linear_f32 kernel: no share, no raise."""
    ops = [("void libra::paged_attention_kernel<128>", 1e-3)] * 4
    peaks = {"hbm_bytes_per_s": 1e12, "tf32_flops_per_s": 1e3}
    assert linear_f32_roofline.read(_ctx(ops, peaks)) is None


def test_split_kernel_reads_at_most_a_third():
    """Each launch at the split-TF32 ceiling, three TF32 products at the
    peak rate, reads a third of the roofline; any slower, less."""
    peaks = {"hbm_bytes_per_s": 1e12, "tf32_flops_per_s": 1e3}
    counted = linear_f32.launches(_ctx([], peaks))
    name = "libra::lin::linear_f32_kernel(CUtensorMap_st, float*, int)"
    at_ceiling = [(name, 3 * f / 1e3) for f, _b in counted]
    share = linear_f32_roofline.read(_ctx(at_ceiling, peaks))
    assert share == pytest.approx(100 / 3)
    assert share < 33.4
    slower = [(n, 1.5 * s) for n, s in at_ceiling]
    assert linear_f32_roofline.read(_ctx(slower, peaks)) < share
    # a launch the steps do not account for: no share
    assert linear_f32_roofline.read(_ctx(at_ceiling[1:], peaks)) is None
