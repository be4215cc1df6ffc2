"""The port's span recorder (``repro_torch.common.tracing``) and the spans
of ``LibraEngine.step`` and ``TransformerLM``, on the CPU.

Off, ``span`` is the shared no-op: no record, no clock read, no profiler
call. On, spans nest by the order they open, carry their counters, and
appear in a ``torch.profiler`` trace as ``user_annotation`` events at a
fixed offset from their records. A traced engine run holds each step's
phases as the engine's docstring lists them, and serves the same tokens,
``EngineStats`` and ``CopyCounters`` as an untraced one."""
import dataclasses
import json
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common import tracing
from repro_torch.configs import get_reduced
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import LibraEngine

PAGE = 8


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def test_off_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(tracing.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("a") is tracing.NOOP
    assert tracing.span("b", tokens=3) is tracing.NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a") as s, tracing.span("b", tokens=3):
            assert s is tracing.NOOP
    assert tracing.drain() == []


def test_on_records_nesting_parents_attrs_and_drain():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("a", tokens=3, slots=8):
            pass
        with tracing.span("b"):
            with tracing.span("c"):
                pass
    with tracing.span("next"):
        pass
    recs = tracing.drain()
    assert [r.name for r in recs] == ["a", "c", "b", "outer", "next"]
    by = {r.name: r for r in recs}
    assert len({r.id for r in recs}) == 5
    assert by["outer"].parent_id == -1 and by["next"].parent_id == -1
    assert by["a"].parent_id == by["outer"].id
    assert by["b"].parent_id == by["outer"].id
    assert by["c"].parent_id == by["b"].id
    assert by["a"].attrs == {"tokens": 3, "slots": 8}
    assert by["b"].attrs == {}
    for r in recs:
        assert r.t1_ns >= r.t0_ns
    assert by["outer"].t0_ns <= by["a"].t0_ns <= by["a"].t1_ns \
        <= by["b"].t0_ns <= by["c"].t0_ns <= by["c"].t1_ns <= by["b"].t1_ns \
        <= by["outer"].t1_ns <= by["next"].t0_ns
    assert tracing.drain() == []
    tracing.disable()
    with tracing.span("off"):
        pass
    assert tracing.drain() == []


def test_a_span_that_raises_is_recorded_and_closed():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("boom")
    with tracing.span("after"):
        pass
    recs = {r.name: r for r in tracing.drain()}
    assert recs["inner"].parent_id == recs["outer"].id
    assert recs["after"].parent_id == -1


def test_spans_appear_in_the_profiler_trace_at_a_fixed_offset(tmp_path):
    tracing.enable()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(40):
            with tracing.span(f"s{i}"):
                for _ in range(1 + i % 4):
                    x = torch.tanh(x @ x)
                if i % 3 == 0:
                    with tracing.span(f"s{i}.inner"):
                        x = x + 1
    recs = {r.name: r for r in tracing.drain()}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] in recs}
    assert set(notes) == set(recs)
    offsets = [float(notes[n]["ts"]) - r.t0_ns / 1e3 for n, r in recs.items()]
    mid = statistics.median(offsets)
    for (name, r), off in zip(recs.items(), offsets):
        assert abs(off - mid) < 500.0, name
        assert abs(float(notes[name]["dur"]) - (r.t1_ns - r.t0_ns) / 1e3) \
            < 500.0, name
    assert len({e["tid"] for e in notes.values()}) == 1


# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_params():
    m = build_model(get_reduced("phi4-mini-3.8b"), page_size=PAGE)
    return m, m.init_params(0, device="cpu")


def _serve(model_params, traced: bool, *, groups=None, pool_pages=0):
    """Serve a fixed list of requests; admission waits for slots (4) and,
    with a small ``pool_pages``, for pages."""
    m, p = model_params
    eng = LibraEngine(m, p, max_batch=4, max_len=64, page_size=PAGE,
                      pool_pages=pool_pages, device="cpu")
    if groups is not None:
        inner = eng._prefill_group

        def record(group):
            groups.append([len(r.prompt) for r in group])
            inner(group)
        eng._prefill_group = record
    rng = np.random.default_rng(5)
    for i in range(10):
        eng.submit(rng.integers(0, m.cfg.vocab_size,
                                size=int(rng.integers(9, 30))),
                   max_new_tokens=int(rng.integers(1, 7)))
    if traced:
        tracing.enable()
    done = eng.run()
    tracing.disable()
    return eng, done, tracing.drain()


def _children(recs):
    out = {r.id: [] for r in recs}
    for r in recs:
        if r.parent_id >= 0:
            out[r.parent_id].append(r)
    for kids in out.values():
        kids.sort(key=lambda r: r.t0_ns)
    return out


PHASES = {
    "engine.prefill": ["engine.prepare", "engine.upload", "model.prefill",
                       "engine.wait", "engine.finish"],
    "engine.decode": ["engine.prepare", "engine.upload", "model.decode_step",
                      "engine.wait", "engine.finish"],
}


@pytest.mark.parametrize("pool_pages", [0, 12])
def test_engine_steps_hold_their_phases(model_params, pool_pages):
    groups = []
    eng, done, recs = _serve(model_params, True, groups=groups,
                             pool_pages=pool_pages)
    assert len(done) == 10
    kids = _children(recs)
    steps = [r for r in recs if r.name == "engine.step"]
    assert all(r.parent_id == -1 for r in steps)
    assert {r.parent_id for r in recs} <= {-1} | {r.id for r in recs}
    n_prefill = n_decode = 0
    for st in steps:
        names = [k.name for k in kids[st.id]]
        assert names[0] == "engine.admit" and kids[kids[st.id][0].id] == []
        assert names[1:] in ([], ["engine.prefill"], ["engine.decode"],
                             ["engine.prefill", "engine.decode"])
        n_prefill += "engine.prefill" in names
        n_decode += "engine.decode" in names
        for k in kids[st.id][1:]:
            assert [g.name for g in kids[k.id]] == PHASES[k.name]
            assert all(kids[g.id] == [] for g in kids[k.id])
    assert n_prefill == eng.stats.prefills == len(groups)
    assert n_decode == eng.stats.steps
    for r in recs:
        inner = sum(k.t1_ns - k.t0_ns for k in kids[r.id])
        assert inner <= r.t1_ns - r.t0_ns, r.name
    prefills = [r for r in recs if r.name == "engine.prefill"]
    assert [r.attrs["tokens"] for r in prefills] == [sum(g) for g in groups]
    assert [r.attrs["slots"] for r in prefills] == [
        len(g) * max(PAGE, -(-max(g) // PAGE) * PAGE) for g in groups]
    assert any(r.attrs["slots"] > r.attrs["tokens"] for r in prefills)
    if pool_pages:   # the first admission ran out of pages, not of slots
        assert len(groups[0]) < 4


@pytest.mark.parametrize("pool_pages", [0, 12])
def test_tracing_changes_no_token_or_counter(model_params, pool_pages):
    plain, plain_done, none = _serve(model_params, False,
                                     pool_pages=pool_pages)
    assert none == []
    traced, traced_done, recs = _serve(model_params, True,
                                       pool_pages=pool_pages)
    assert recs
    assert [(r.rid, r.output) for r in traced_done] == \
        [(r.rid, r.output) for r in plain_done]
    assert dataclasses.asdict(traced.stats) == dataclasses.asdict(plain.stats)
    assert dataclasses.asdict(traced.stack.counters) == \
        dataclasses.asdict(plain.stack.counters)


def test_engine_spans_are_profiler_annotations(model_params):
    m, p = model_params
    eng = LibraEngine(m, p, max_batch=2, max_len=64, page_size=PAGE,
                      device="cpu")
    eng.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=3)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    names = sorted(r.name for r in tracing.drain())
    seen = sorted(e.name for e in prof.events()
                  if e.name.startswith(("engine.", "model.")))
    assert seen == names
    assert "model.prefill" in names and "model.decode_step" in names
