"""Twin runner: a test module of the JAX package's core, run through
``repro.core`` and through the port's ``repro_torch.core`` on the same
seeds.

:func:`load` executes a test file in a fresh module whose imports of
``repro.core`` name one package or the other, so module-level RNGs start
from their seeds again. :func:`run` calls one test of it in each package
while :func:`observe` records every stack, socket, runtime, cluster, fault
plan, policy table, health table, allocator, VPI registry, connection
and receive ring the test builds, and compares what they end with: wire
bytes, ``CopyCounters``, page counts, channel stats, cluster and steering
stats, the fault plan's summary and log, policy and health summaries,
registry sizes and stats, ring contents and fingerprints. The test's own assertions run on both
sides. Port stacks default to ``device="cpu"`` here.

A ``@given`` test runs once under hypothesis: each example goes through
both packages, the port's side replaying the draws the JAX side made.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import itertools
import re
import types
from pathlib import Path
from typing import Dict, List, Tuple

PKGS = {"jax": "repro.core", "torch": "repro_torch.core"}
TRACKED = ("LibraStack", "LibraSocket", "ProxyRuntime", "ClusterRuntime",
           "LibraCluster", "FaultPlan", "PolicyTable", "HealthTable",
           "AnchorPool", "VpiRegistry", "Connection", "RxRing")
TESTS = Path(__file__).resolve().parent


def load(path: Path, pkg: str) -> types.ModuleType:
    """``path`` executed as a fresh module, its ``repro.core`` imports
    pointed at ``PKGS[pkg]``."""
    src = Path(path).read_text()
    if pkg == "torch":
        src = re.sub(r"\brepro\.core\b", PKGS["torch"], src)
    mod = types.ModuleType(f"_twin_{pkg}_{Path(path).stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def cases(path: Path, skip=()) -> List[Tuple[str, dict]]:
    """``(test name, parameters)`` for every test function of ``path``
    and every case of its ``parametrize`` marks, in file order."""
    mod = load(path, "jax")
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or name in skip:
            continue
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names, values = mark.args[:2]
            names = [n.strip() for n in (names.split(",")
                                         if isinstance(names, str)
                                         else names)]
            grids.append([dict(zip(names, v if len(names) > 1 else (v,)))
                          for v in values])
        for combo in itertools.product(*grids):
            params = {}
            for part in combo:
                params.update(part)
            out.append((name, params))
    return out


def case_id(case: Tuple[str, dict]) -> str:
    name, params = case
    return "-".join([name] + [str(v) for v in params.values()])


def _state(obj) -> tuple:
    kind = type(obj).__name__
    if kind == "LibraStack":
        a = obj.alloc
        return (kind, dataclasses.asdict(obj.counters), a.free_pages,
                a.total_pages, a.granted_out_pages, len(obj.registry))
    if kind == "LibraSocket":
        return (kind, obj.tx_wire().tolist(), obj.closed)
    if kind == "ProxyRuntime":
        return (kind, obj.rounds, obj.messages_forwarded(),
                [(c.name, _channel(c.stats)) for c in obj.channels])
    if kind == "ClusterRuntime":
        return (kind, obj.rounds, dict(obj.stats), obj.messages_forwarded())
    if kind == "LibraCluster":
        return (kind, dict(obj.stats), obj.steering.stats,
                sorted(obj.dead_workers))
    if kind == "FaultPlan":
        return (kind, obj.summary(), list(obj.log))
    if kind in ("PolicyTable", "HealthTable"):
        return (kind, obj.summary())
    if kind == "VpiRegistry":
        return (kind, len(obj), dict(obj.stats))
    if kind == "Connection":
        return (kind, obj.tx_wire().tolist(), obj.closed)
    if kind == "RxRing":
        return (kind, obj.fingerprint(), obj.capacity,
                obj.peek(len(obj)).tolist())
    return (kind, obj.free_pages, obj.total_pages, obj.granted_out_pages)


def _channel(stats) -> dict:
    d = {f.name: getattr(stats, f.name)
         for f in dataclasses.fields(stats) if f.name != "latency"}
    d["latency_count"] = stats.latency.count
    return d


@contextlib.contextmanager
def observe(pkg: str):
    """Record every object of :data:`TRACKED` built inside the block (in
    construction order); port stacks default to ``device="cpu"``."""
    core = importlib.import_module(PKGS[pkg])
    made: list = []
    saved = []

    def wrap(cls, init):
        def __init__(self, *args, **kw):
            if pkg == "torch" and cls.__name__ == "LibraStack":
                kw.setdefault("device", "cpu")
            init(self, *args, **kw)
            made.append(self)
        return __init__

    for name in TRACKED:
        cls = getattr(core, name)
        saved.append((cls, cls.__dict__["__init__"]))
        cls.__init__ = wrap(cls, cls.__init__)
    try:
        yield made
    finally:
        for cls, init in saved:
            cls.__init__ = init


def sync_connection_ids() -> None:
    """Both packages' next connection id, set to the same value: default
    channel names (``ch<fd>``) key the fault plan's coins."""
    conns = [importlib.import_module(f"{p}.stream").Connection
             for p in PKGS.values()]
    start = max(c._next_id for c in conns)
    for c in conns:
        c._next_id = start


class _Tape:
    """A hypothesis ``data`` object that records what it draws."""

    def __init__(self, data, tape: list):
        self._data, self._tape = data, tape

    def draw(self, strategy, label=None):
        v = self._data.draw(strategy, label)
        self._tape.append(copy.deepcopy(v))
        return v


class _Replay:
    """Plays a :class:`_Tape`'s draws back in order."""

    def __init__(self, tape: list):
        self._it = iter(tape)

    def draw(self, strategy, label=None):
        return copy.deepcopy(next(self._it))


def observed(pkg: str, fn, *args, **kw) -> list:
    """What :func:`observe` records of ``fn(*args, **kw)`` run in
    ``pkg``."""
    with observe(pkg) as made:
        fn(*args, **kw)
    return [_state(o) for o in made]


def run(path: Path, name: str, **params) -> Dict[str, list]:
    """Run test ``name`` of ``path`` through both packages and assert that
    what they built ends the same. Returns the records."""
    fns = {pkg: getattr(load(path, pkg), name) for pkg in PKGS}
    if hasattr(fns["jax"], "hypothesis"):
        return _run_given(fns)
    sync_connection_ids()
    seen = {pkg: observed(pkg, fn, **copy.deepcopy(params))
            for pkg, fn in fns.items()}
    assert seen["torch"] == seen["jax"]
    return seen


def _run_given(fns) -> Dict[str, list]:
    inner = {pkg: fn.hypothesis.inner_test for pkg, fn in fns.items()}
    seen: Dict[str, list] = {"jax": [], "torch": []}

    def both(*args, **kw):
        tape: list = []
        sync_connection_ids()
        got = {}
        for pkg in PKGS:
            kw_pkg = {k: (copy.deepcopy(v) if not hasattr(v, "draw")
                          else _Tape(v, tape) if pkg == "jax"
                          else _Replay(tape))
                      for k, v in kw.items()}
            got[pkg] = observed(pkg, inner[pkg], *copy.deepcopy(args),
                                 **kw_pkg)
        assert got["torch"] == got["jax"]
        for pkg in PKGS:
            seen[pkg].extend(got[pkg])

    fns["jax"].hypothesis.inner_test = both
    fns["jax"]()
    return seen
