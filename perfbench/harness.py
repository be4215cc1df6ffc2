"""One cell, run once: set-up, the measured window, the reading of the
metrics and the judgement of the served tokens.

The system under test is the port's ``LibraEngine`` (``serving/engine.py``)
over ``TransformerLM`` (``models/transformer.py``), driven through its
public ``submit`` and ``step`` by a closed loop of clients: a client sends
its next request of the mix's frozen list as soon as its last one
completes. The engine's schedule follows from the frozen lengths alone, so
every seed gives the same steps, prefill groups and padding; the seed
draws only the weights and the token ids.

The window is a whole number of engine steps, from the first step after
set-up to the first step that ends ``seconds`` or more after the window
opened. A token's time is the host clock when ``step`` returned it (a
request's first token: the engine's own ``first_token_at``). A traced run
measures the same window with the benchmark's spans around the model's
calls and no profiler, then profiles a further ``TRACE_SECONDS``: the
profiler slows the host, so only the device's own readings (kernel times,
busy and idle) come from the profiled window.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import judge, traffic, weights

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())
#: seconds of the profiled window that follows a traced run's measured one
TRACE_SECONDS = 10.0


def load_json(kind: str, name: str) -> Dict:
    data = json.loads((HERE / kind / f"{name}.json").read_text())
    if data["name"] != name:
        raise ValueError(f"{kind}/{name}.json names {data['name']!r}")
    return data


def module(kind: str, name: str):
    return importlib.import_module(f"perfbench.{kind}.{name}")


@dataclass
class Record:
    """A request the loop sent: its client, its admission group (in row
    order) and the host time of each token."""
    req: object
    client: int
    group: List[object] = field(default_factory=list)
    row: int = -1
    times: List[float] = field(default_factory=list)


@dataclass
class Step:
    t0: float
    t1: float
    tokens: int
    prefill_lens: List[int]
    prefill_width: int
    decode_ctx: List[int]
    #: share of the pool's pages held (reserved at admission) after the step
    pool_used: float = 0.0
    #: share of the pool's token slots that hold a cached token
    pool_written: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ClosedLoop:
    """``clients`` callers over the mix's frozen list, each waiting for its
    reply before it sends the next request."""

    def __init__(self, eng, mix: Dict, prompts: List[np.ndarray]):
        self.eng = eng
        self.mix = mix
        self.prompts = prompts
        self.queues = [deque(traffic.client_entries(mix, c))
                       for c in range(int(mix["clients"]))]
        self.records: Dict[int, Record] = {}
        self.spans: List[tuple] = []
        #: ``torch.profiler.record_function`` in a profiled window
        self.label = None

    def submit(self, client: int) -> None:
        if not self.queues[client]:
            raise RuntimeError(f"client {client} ran out of requests: the "
                               "mix's frozen list is too short for the run")
        j = self.queues[client].popleft()
        r = self.eng.submit(self.prompts[j],
                            max_new_tokens=int(self.mix["requests"][j][1]))
        self.records[r.rid] = Record(r, client)

    def step(self) -> Step:
        eng = self.eng
        waiting = list(eng.waiting)
        live = list(eng.active) + waiting
        before = {r.rid: len(r.output) for r in live}
        done = len(eng.completed)
        self.spans.clear()
        t0 = time.perf_counter()
        if self.label is None:
            eng.step()
        else:
            with self.label("bench.step"):
                eng.step()
        t1 = time.perf_counter()
        still = {r.rid for r in eng.waiting}
        admitted = [r for r in waiting if r.rid not in still]
        for i, r in enumerate(admitted):
            rec = self.records[r.rid]
            rec.group, rec.row = admitted, i
        new, ctx = 0, []
        for r in live:
            had, have = before[r.rid], len(r.output)
            rec = self.records[r.rid]
            for k in range(had, have):
                rec.times.append(r.first_token_at if k == 0 else t1)
            new += have - had
            if have - had == 2 or (have - had == 1 and had > 0):
                ctx.append(len(r.prompt) + have - 1)   # decoded this step
        for r in eng.completed[done:]:
            self.submit(self.records[r.rid].client)
        lens = [len(r.prompt) for r in admitted]
        page = eng.page_size
        width = max(page, -(-max(lens) // page) * page) if lens else 0
        alloc = eng.pool.alloc
        cached = sum(len(r.prompt) + len(r.output) - 1 for r in eng.active)
        st = Step(t0, t1, new, lens, width, ctx, alloc.used_fraction,
                  cached / (alloc.total_pages * page))
        for label, a, b in self.spans:
            setattr(st, f"{label}_s", getattr(st, f"{label}_s") + b - a)
        return st


def traced(model, loop: ClosedLoop, name: str, label: str):
    """Wrap ``model.<name>`` in a host span that ends once the device has
    finished the call (the engine downloads the call's tokens at once, so
    this adds no wait of its own), inside the label ``bench.<label>`` while
    the loop is profiled."""
    inner = getattr(model, name)

    def call(*args, **kw):
        with (loop.label or contextlib.nullcontext)(f"bench.{label}"):
            a = time.perf_counter()
            out = inner(*args, **kw)
            if out.is_cuda:
                torch.cuda.current_stream(out.device).synchronize()
            loop.spans.append((label, a, time.perf_counter()))
        return out
    setattr(model, name, call)


def process_age() -> float:
    """Seconds since this process started, from ``/proc``."""
    tick = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = float(f.read().rsplit(")", 1)[1].split()[19]) / tick
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def setup_loop(loop: ClosedLoop, mix: Dict) -> None:
    """Set-up: each client's first request, admitted ``setup_group`` at a
    time with a step after each group; then, for ``first_completion``,
    steps until the first request completes, and ``warm_steps`` more."""
    clients = int(mix["clients"])
    group = int(mix["setup_group"]) or clients
    for start in range(0, clients, group):
        for c in range(start, min(clients, start + group)):
            loop.submit(c)
        loop.step()
    if mix["warm"] == "first_completion":
        while not loop.eng.completed:
            loop.step()
    elif mix["warm"] != "admitted":
        raise ValueError(f"unknown warm phase {mix['warm']!r}")
    for _ in range(int(mix["warm_steps"])):
        loop.step()


def run_window(loop: ClosedLoop, seconds: float) -> List[Step]:
    steps = []
    loop.cpu0 = time.thread_time()
    t0 = time.perf_counter()
    while True:
        st = loop.step()
        steps.append(st)
        if st.t1 - t0 >= seconds:
            break
    loop.cpu_s = time.thread_time() - loop.cpu0
    steps[0].t0 = t0
    return steps


def gaps_in(records, t0: float, t1: float) -> List[float]:
    out = []
    for rec in records:
        ts = rec.times
        out += [b - a for a, b in zip(ts, ts[1:]) if a >= t0 and b <= t1]
    return out


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between the two nearest ranks."""
    return float(np.percentile(np.asarray(values), 95))


def step_quartiles(steps: List[Step]) -> Dict:
    """Quartiles of the window's step times, in ms, for steps with and
    without a prefill: a look at what sets the tail."""
    out = {}
    for kind, sel in (("decode", [s for s in steps if not s.prefill_lens]),
                      ("prefill", [s for s in steps if s.prefill_lens])):
        if sel:
            ms = np.asarray([(s.t1 - s.t0) * 1e3 for s in sel])
            out[kind] = [len(sel)] + [float(np.percentile(ms, q))
                                      for q in (0, 25, 50, 75, 100)]
    return out


@dataclass
class Context:
    """What a per-layer metric reader sees: the measured window (its steps
    with their spans, its seconds, tokens and boundary bytes; no profiler
    ran in it) and the profiled window that followed (its steps and the
    reduced trace)."""
    model: Dict
    steps: List[Step]
    window_s: float
    tokens: int
    boundary_bytes: int
    trace_steps: List[Step]
    trace: Optional[object]
    peaks: Dict

    def work(self, kernel: str):
        return module("work", kernel)


def profiled_window(loop: ClosedLoop, seconds: float):
    """A window under the profiler, with the benchmark's labels around
    ``step``, ``prefill`` and ``decode_step``: ``(steps, TraceSummary)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import trace as trace_lib

    loop.label = record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with record_function("bench.window"):
        steps = run_window(loop, seconds)
    prof.stop()
    loop.label = None
    return steps, trace_lib.summarise(trace_lib.export(prof))


def serve(config: Dict, mix: Dict, seed: int, seconds: float, *,
          trace: bool, device: str, metrics: List[str],
          clock, control: bool = False) -> Dict:
    """Run the cell once and return the result's fields: with ``trace``
    the per-layer ``metrics`` named, without it the end-to-end ones; with
    ``control``, also the control's reading of the same sample
    (``judge.compare`` with ``tf32``). ``clock()`` gives the seconds since
    the process started."""
    from repro_torch.common.types import ModelConfig
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import LibraEngine

    phases = {"imports": clock()}
    cfg = ModelConfig(**config["model"])
    serving = config["serving"]
    model = build_model(cfg, page_size=serving["page_size"])
    weights.check_layout(config["params"], model.template())
    params = weights.draw(config["params"], seed, device)
    prompts = traffic.prompt_tokens(mix, seed, cfg.vocab_size)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    phases["weights"] = clock()
    eng = LibraEngine(model, params, max_batch=int(mix["slots"]),
                      max_len=max(p + o for p, o in mix["requests"]) + 8,
                      page_size=serving["page_size"],
                      pool_pages=int(mix.get("pool_pages", 0)), device=device)
    loop = ClosedLoop(eng, mix, prompts)
    phases["engine"] = clock()
    setup_loop(loop, mix)
    stats0 = eng.stats.h2d_bytes + eng.stats.d2h_bytes
    if cuda:
        torch.cuda.synchronize()
    setup_s = clock()
    if trace:
        traced(model, loop, "prefill", "prefill")
        traced(model, loop, "decode_step", "decode")
    steps = run_window(loop, seconds)
    w0, w1 = steps[0].t0, steps[-1].t1
    window_bytes = eng.stats.h2d_bytes + eng.stats.d2h_bytes - stats0
    tokens = sum(st.tokens for st in steps)
    itl = gaps_in(loop.records.values(), w0, w1)
    out = {"attempted": sum(1 for rec in loop.records.values()
                            if any(w0 <= t <= w1 for t in rec.times)),
           "failed": 0,
           "window_s": w1 - w0, "steps": len(steps), "tokens": tokens,
           "itl_gaps": len(itl), "step_ms": step_quartiles(steps),
           "host_cpu_s": loop.cpu_s,
           "pool": {"pages": eng.pool.alloc.total_pages,
                    "used_mean": float(np.mean([s.pool_used for s in steps])),
                    "used_max": max(s.pool_used for s in steps),
                    "written_mean": float(np.mean([s.pool_written
                                                   for s in steps]))},
           "setup_phases": dict(phases, traffic=setup_s)}
    if trace:
        trace_steps, summary = profiled_window(loop, TRACE_SECONDS)
        del model.prefill, model.decode_step   # the class's methods again
        ctx = Context(config["model"], steps, w1 - w0, tokens, window_bytes,
                      trace_steps, summary, PEAKS)
        values = {name: module("metrics", name).read(ctx) for name in metrics}
        out["metrics"] = {k: v for k, v in values.items() if v is not None}
        out["busy_s"] = summary.busy_s
        out["trace_window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    else:
        out["metrics"] = {"tokens_per_s": tokens / (w1 - w0),
                          "itl_p95_ms": p95(itl) * 1e3,
                          "setup_s": setup_s}
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    # the judgement, once the program's state is freed
    cases = judge.cases(loop, mix, seed, int(mix["slots"]))
    del eng, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = module("reference", config["family"])
    out["compared"] = judge.compare(ref, params, config, cases)
    if control:
        out["control"] = judge.compare(ref, params, config, cases, tf32=True)
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
