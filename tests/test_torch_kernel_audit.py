"""The port's kernel audit (``repro_torch.analysis.kernel_audit``) on the
CPU, against the JAX package's jaxpr audit.

Each registry entry runs clean on the plain versions, and its observed
boundary element count equals the declared budget of the JAX entry of the
same name, read from ``jaxpr_audit``'s ``build()`` (which runs here
without tracing); the negative control raises ``KERN002``. Fixture pairs
hold each JAX rule against its KERN rule on the same kind of function. The
parts that only run on the card (KERN001's count of profiler kernel
events, the trace's attribution by label, the boundary crossings
``audit_rounds`` holds to ``xfer``) are fed by hand here; exact equality
throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_audit
from repro_torch import core
from repro_torch.analysis import kernel_audit as ka
from repro_torch.analysis.kernel_audit import Call, OpCall, TensorInfo

JAX_ENTRIES = {e.name: e for e in jaxpr_audit.KERNEL_ENTRIES}
#: the port's entry -> the JAX entry whose budget it has
JAX_NAME = {n: n for n in ka.KERNEL_ENTRIES}
JAX_NAME["selective_copy[cloned-pool]"] = "selective_copy[reserved]"
POLICY = ka.REPO_ROOT / "src" / "repro_torch" / "core" / "policy.py"


def _rules(findings):
    return sorted(f.rule for f in findings)


def _call(name) -> Call:
    return ka.KERNEL_ENTRIES[name](name, "cpu", "ref")


def test_registry_has_the_jax_entries_but_legacy():
    assert set(JAX_ENTRIES) - set(ka.KERNEL_ENTRIES) == {
        "selective_copy[legacy]"}
    assert set(ka.KERNEL_ENTRIES) - set(JAX_ENTRIES) == {
        "selective_copy[cloned-pool]"}


@pytest.mark.parametrize("name", list(ka.KERNEL_ENTRIES))
def test_registry_entry_clean_on_the_plain_version(name):
    findings, seen = ka.audit_calls([_call(name)], "cpu")
    assert findings == [], [f.format() for f in findings]
    assert seen[name]["boundary_elems"] == _call(name).declared


@pytest.mark.parametrize("name", list(ka.KERNEL_ENTRIES))
def test_boundary_elems_equal_the_jax_declared_budget(name):
    _fn, _args, declared = JAX_ENTRIES[JAX_NAME[name]].build()
    _findings, seen = ka.audit_call(_call(name))
    assert seen["boundary_elems"] == declared


def test_negative_control_raises_kern002():
    call = _call("selective_copy[cloned-pool]")
    raw, _ = ka.audit_call(call)
    assert "KERN002" in _rules(raw) and "KERN005" in _rules(raw)
    assert ka.audit_calls([call], "cpu")[0] == []


def test_negative_control_that_does_not_fire_is_a_finding():
    call = _call("selective_copy[reserved]")
    call.expect = ("KERN002",)
    findings, _ = ka.audit_calls([call], "cpu")
    assert _rules(findings) == ["KERN002"]
    assert "negative control broken" in findings[0].message


def test_kernels_report_on_the_cpu_says_kern001_not_run():
    rep = ka.run("cpu")
    assert rep.ok, "\n".join(rep.lines())
    assert rep.name == "kernels[cpu]"
    assert any("KERN001 not run" in line for line in rep.lines())


# ---------------------------------------------------------------------------
# fixture pairs: each JAX rule against its KERN rule
# ---------------------------------------------------------------------------

def _jax_smuggled():
    x = jnp.zeros((4,), jnp.int32)
    return jaxpr_audit.audit_fn(lambda a, b: jnp.concatenate([a, b]),
                                (x, x), name="smuggled", n_pallas=0)


def _port_smuggled():
    pool = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.ones((1, 2), dtype=torch.int32)
    return ka.audit_fn(lambda p, a: torch.cat([p, a]), (pool, x),
                       name="smuggled", pool=0)


def _jax_budget(declared):
    x = jnp.zeros((8,), jnp.int32)
    return jaxpr_audit.audit_fn(lambda a: a * 2, (x,), name="b", n_pallas=0,
                                declared_boundary=declared)


def _port_budget(declared):
    x = torch.zeros((8,), dtype=torch.int32)
    return ka.audit_fn(lambda a: a * 2, (x,), name="b", declared=declared)


def _jax_int64():
    with jax.enable_x64(True):
        x = jnp.zeros((4,), jnp.int32)
        return jaxpr_audit.audit_fn(lambda a: a.astype(jnp.int64), (x,),
                                    name="wide", n_pallas=0)


def _port_int64():
    x = torch.zeros((4,), dtype=torch.int32)
    return ka.audit_fn(lambda a: a.long(), (x,), name="wide")


def _jax_clean():
    return jaxpr_audit.audit_fn(lambda a: a + 1,
                                (jnp.zeros((4,), jnp.int32),),
                                name="clean", n_pallas=0)


def _port_clean():
    return ka.audit_fn(lambda a: a + 1, (torch.zeros((4,),
                                                     dtype=torch.int32),),
                       name="clean")


FIXTURES = {
    "smuggled-copy": (_jax_smuggled, _port_smuggled, ["KERN002"]),
    "budget-ok": (lambda: _jax_budget(16), lambda: _port_budget(16), []),
    "budget-mismatch": (lambda: _jax_budget(17), lambda: _port_budget(17),
                        ["KERN004"]),
    "int64-output": (_jax_int64, _port_int64, ["KERN003"]),
    "clean": (_jax_clean, _port_clean, []),
}


@pytest.mark.parametrize("case", list(FIXTURES))
def test_fixture_pair(case):
    jax_fn, port_fn, want = FIXTURES[case]
    jax_rules = [r.replace("JAX", "KERN") for r in _rules(jax_fn())]
    assert jax_rules == want
    assert _rules(port_fn()) == want


def test_fresh_pool_gives_kern005():
    pool = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    findings = ka.audit_fn(lambda p: (p.sum().int(), torch.zeros_like(p)),
                           (pool,), name="fresh", pool=0, pool_out=1)
    assert "KERN005" in _rules(findings)


def test_plain_version_disagreeing_pool_gives_kern005():
    pool = torch.zeros((4, 2), dtype=torch.int32)
    findings = ka.audit_fn(lambda p: (p.add_(1),), (pool,), name="inplace",
                           pool=0, pool_out=0, plain=lambda p: (p.add_(2),))
    assert _rules(findings) == ["KERN005"]


def test_new_tensor_of_the_pools_size_gives_kern002():
    pool = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.ones((2,), dtype=torch.int32)
    findings = ka.audit_fn(
        lambda p, a: (a + 1, torch.zeros(p.numel(), dtype=torch.int32)),
        (pool, x), name="alloc", pool=0)
    assert _rules(findings) == ["KERN002"]


# ---------------------------------------------------------------------------
# KERN001, fed by hand: there are no kernel events on the CPU
# ---------------------------------------------------------------------------

FUSED = "fused_round_kernel(FusedArgs)"
NAMES = {
    "one-launch": ([FUSED], {"fused_round": 1}, None, []),
    "two-launches": ([FUSED, FUSED], {"fused_round": 1}, None, ["KERN001"]),
    "mangled": (["_Z18fused_round_kernel9FusedArgs"], {"fused_round": 1},
                None, []),
    "other-kernels-ignored": (
        ["void at::native::vectorized_elementwise_kernel<4>(int)", FUSED,
         "spin_kernel(long)"], {"fused_round": 1}, None, []),
    "a-kernel-of-the-port-too-many": (
        [FUSED, "void selective_gather_kernel(int const*)"],
        {"fused_round": 1}, None, ["KERN001"]),
    "wrapper-count-disagrees": ([FUSED], {"fused_round": 1},
                                {"fused_round": 2}, ["KERN001"]),
}


@pytest.mark.parametrize("case", list(NAMES))
def test_kern001_counts_kernel_names(case):
    names, expected, launched, want = NAMES[case]
    assert _rules(ka.launch_findings("<t>", names, expected,
                                     launched)) == want


def test_port_kernel_names():
    assert ka.port_kernel("void policy_match_kernel<32>(int const*)") == \
        "policy_match"
    assert ka.port_kernel("_Z21selective_copy_kernelPKiS0_") == \
        "selective_copy"
    assert ka.port_kernel("vectorized_elementwise_kernel") is None


# ---------------------------------------------------------------------------
# a profiler trace, written by hand: attribution by label, copy bytes
# ---------------------------------------------------------------------------

def _ev(cat, name, ts, dur=1.0, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


TRACE = [
    _ev("user_annotation", ka.WINDOW_MARKER_LABEL, 10, 5),
    _ev("cuda_runtime", "cudaLaunchKernel", 11, correlation=1),
    _ev("kernel", "void at::native::fill_kernel(int)", 30, correlation=1),
    _ev("user_annotation", "kernel_audit.a", 100, 50),
    _ev("cuda_runtime", "cudaMemcpyAsync", 101, correlation=2),
    _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300,
        correlation=2, bytes=4096),
    _ev("cuda_runtime", "cudaLaunchKernel", 120, correlation=3),
    _ev("kernel", FUSED, 310, correlation=3),
    _ev("cuda_runtime", "cudaMemcpyAsync", 140, correlation=4),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 320,
        correlation=4, bytes=256),
    # no runtime event carries its id: placed by its own time
    _ev("kernel", "void selective_gather_kernel(int)", 149,
        correlation=99),
    _ev("user_annotation", "kernel_audit.b", 200, 10),
    _ev("cuda_runtime", "cudaLaunchKernel", 201, correlation=5),
    _ev("kernel", FUSED, 400, correlation=5),
]


def test_trace_attribution_by_label():
    by = ka.device_events_by_label(
        TRACE, ["kernel_audit.a", "kernel_audit.b", ka.WINDOW_MARKER_LABEL])
    assert ka.kernel_names(by["kernel_audit.a"]) == [
        FUSED, "void selective_gather_kernel(int)"]
    assert ka.kernel_names(by["kernel_audit.b"]) == [FUSED]
    assert ka.copy_bytes(by["kernel_audit.a"], "HtoD") == 4096
    assert ka.copy_bytes(by["kernel_audit.a"], "DtoH") == 256
    assert ka.copy_bytes(by["kernel_audit.b"], "HtoD") == 0
    assert ka._marker_finding("<t>", by) == []
    lost = ka.device_events_by_label(TRACE[3:], [ka.WINDOW_MARKER_LABEL])
    assert _rules(ka._marker_finding("<t>", lost)) == ["KERN001"]


# ---------------------------------------------------------------------------
# boundary crossings: counted sites, the reckoned index, waivers at a line
# ---------------------------------------------------------------------------

def _line(path, text):
    return next(i for i, t in enumerate(path.read_text().splitlines(), 1)
                if text in t)


def _copy(site, nbytes, src="cpu", dst="cuda", dtype=torch.int32):
    n = nbytes // dtype.itemsize
    return OpCall("_to_copy", [TensorInfo(1, n, dtype, src)],
                  [TensorInfo(2, n, dtype, dst)], site)


def test_uncounted_crossings_and_their_waivers():
    up_line = _line(POLICY, "return torch.from_numpy(a).to(dev)")
    down_line = _line(POLICY, "return rids.cpu().numpy()")
    ops = [
        _copy(("src/repro_torch/core/stream.py", 177, "_upload"), 400),
        _copy(("src/repro_torch/core/device_pool.py", 199, "_index"), 80,
              dtype=torch.int64),
        _copy(("src/repro_torch/core/policy.py", up_line, "up"), 64),
        _copy(("src/repro_torch/core/policy.py", up_line, "up"), 16),
        _copy(("src/repro_torch/core/policy.py", down_line, "match_batch"),
              8, src="cuda", dst="cpu"),
        _copy(("src/repro_torch/core/device_pool.py", 307,
               "fused_round_device"), 1024, src="cuda", dst="cpu"),
        _copy(("src/repro_torch/core/stack.py", 10, "somewhere"), 12),
    ]
    findings, up, down = ka.uncounted_crossings(ops)
    assert (up, down) == (64 + 16 + 12, 8)
    active, waived = ka.waive(findings)
    assert [(f.file, f.line) for f in waived] == [
        ("src/repro_torch/core/policy.py", up_line),
        ("src/repro_torch/core/policy.py", down_line)]
    assert all("ROADMAP.md" in f.waiver_reason for f in waived)
    assert [(f.file, f.rule) for f in active] == [
        ("src/repro_torch/core/stack.py", "KERN004")]


def test_recorder_names_the_counted_upload_site():
    """The dispatch record places a copy at the port's line that asked
    for it, and ``TokenPool._upload`` is the counted site it names (a copy
    to the meta device stands in for the card)."""
    stack = core.LibraStack(n_shards=1, pages_per_shard=4, page_size=8,
                            device="meta")
    rec = ka.OpRecorder()
    with rec:
        stack.pool._upload(np.arange(6, dtype=np.int64))
    sites = ka._by_site(rec.ops, "cpu", "meta")
    assert list(sites.values()) == [24]            # int32 on the way
    (file, _line, func), = sites
    assert (file, func) in ka.COUNTED_H2D


def test_audit_rounds_needs_a_resident_cuda_pool():
    stack = core.LibraStack(n_shards=1, pages_per_shard=8, page_size=8,
                            device="cpu")
    rt = core.ProxyRuntime(stack, batched=True, batch_impl="fused-round")
    with pytest.raises(RuntimeError, match="resident on a CUDA device"):
        ka.audit_rounds(rt)
    stack.pool._ensure_device()                    # resident, on the CPU
    with pytest.raises(RuntimeError, match="resident on a CUDA device"):
        ka.audit_rounds(rt)


# ---------------------------------------------------------------------------
# the two gates
# ---------------------------------------------------------------------------

def _script(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ka.REPO_ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_static_analysis_gate_passes(capsys):
    assert _script("check_static_analysis_torch").main() == 0
    out = capsys.readouterr().out
    assert "check_static_analysis_torch: OK" in out
    if not torch.cuda.is_available():
        assert "no CUDA device" in out and "KERN001 not run" in out


def test_kernel_parity_gate_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gate runs on it")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _script("check_kernel_parity_torch").main()


PARITY = _script("check_kernel_parity_torch")


@pytest.mark.parametrize("check", [c for _, c in PARITY.CHECKS],
                         ids=[n for n, _ in PARITY.CHECKS])
def test_kernel_parity_sweeps_on_the_plain_versions(check, monkeypatch):
    """The gate's sweeps, their calls pointed at the plain versions on the
    CPU: the script's own parity check and the audit pass."""
    import functools
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = check("cpu")
    for c in calls:
        assert c.fn.keywords["impl"] == "cuda"
        c.fn = functools.partial(c.fn.func, impl="ref")
        PARITY.parity(c, c.name)
    findings, _ = ka.audit_calls(calls, "cpu")
    assert findings == []
    assert len(calls) == {"check_selcopy": 8, "check_gather": 8,
                          "check_policy": 28,
                          "check_fused": 18}[check.__name__]
