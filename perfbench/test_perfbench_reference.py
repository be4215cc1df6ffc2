"""The plain reference against the port's model at a tiny size on the
CPU (the tests may import both; the reference imports nothing of the
port)."""
import pytest
import torch

from perfbench import testing
from perfbench.reference import common


@pytest.mark.parametrize("pool_pages", [0, 10])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 3])
def test_served_tokens_agree_with_the_reference(seed, pool_pages):
    mix = dict(testing.tiny_mix(), pool_pages=pool_pages)
    out = testing.serve_cpu(testing.tiny_config("phi4-mini-3.8b"), mix, seed)
    c = out["compared"]["served_logit_gap_max"]
    assert c["tokens"] >= 8 and c["requests"] == 4
    assert c["value"] <= 1e-5


def test_finished_requests_judged():
    out = testing.serve_cpu(testing.tiny_config("phi4-mini-3.8b"),
                            testing.tiny_mix(check_from="finished"), 5)
    assert out["compared"]["served_logit_gap_max"]["value"] <= 1e-5


def test_rope_and_norm_against_the_port():
    from repro_torch.models.layers import apply_rope, rms_norm

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 3, 16, generator=g)
    pos = torch.arange(100, 107)
    assert torch.allclose(common.rope(x, pos, 1e6),
                          apply_rope(x, pos.expand(2, 7), 1e6), atol=1e-6)
    w = torch.randn(16, generator=g)
    assert torch.allclose(common.rms_norm(x, w, 1e-6), rms_norm(x, w, 1e-6),
                          atol=1e-6)


def test_a_traced_run_reads_its_metrics(monkeypatch):
    """A traced run on the CPU: the measured window with its spans, then a
    short profiled window; each reader finds what it reads or returns
    nothing, and the model's own methods are back afterwards."""
    from perfbench import harness

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.5)
    names = ["engine_host_ms", "boundary_bytes_per_token", "decode_step_ms",
             "prefill_ms_per_ktok", "step_mfu_pct", "kv_pool_used_pct",
             "profiler_slowdown", "device_idle_pct",
             "paged_attention_roofline"]
    mix = dict(testing.tiny_mix(), pool_pages=10)
    out = harness.serve(testing.tiny_config("phi4-mini-3.8b"), mix, 21, 1.0,
                        trace=True, device="cpu", metrics=names,
                        clock=lambda: 0.0)
    m = out["metrics"]
    assert {"engine_host_ms", "decode_step_ms", "step_mfu_pct",
            "kv_pool_used_pct", "profiler_slowdown"} <= set(m)
    assert "paged_attention_roofline" not in m     # no CUDA kernel ran
    assert m["decode_step_ms"] > 0 and 0 < m["kv_pool_used_pct"] <= 100
    assert out["trace_window_s"] > 0
    assert out["compared"]["served_logit_gap_max"]["value"] <= 1e-5
