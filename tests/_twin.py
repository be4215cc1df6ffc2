"""Twin runner: a test module of the JAX package's core, run through
``repro.core`` and through the port's ``repro_torch.core`` on the same
seeds.

:func:`load` executes a test file in a fresh module whose imports of
``repro.core`` and ``repro.kernels`` name one package or the other, so
module-level RNGs start from their seeds again. :func:`run` calls one test
of it in each package while :func:`observe` records every stack, socket,
runtime, cluster, fault plan, policy table, health table, allocator, VPI
registry, connection and receive ring the test builds, and compares what
they end with: wire bytes, ``CopyCounters``, page counts, the pool's
``xfer`` counts (less ``donated_rounds``, which the port counts for every
round whose pool keeps its storage, and the port's own ``host_gathers``)
and ``fused_buffers``, channel stats, cluster and steering stats, the
fault plan's summary and log, policy and health summaries, registry sizes
and stats, ring contents and fingerprints. The test's own assertions run
on both sides. Port stacks, and ``PolicyTable.match_batch`` called by the
test, default to ``device="cpu"`` here.

While the JAX side runs, its ``stack._SMALL_GATHER_ROWS`` (batched gathers
of up to four rows served on the host, a shortcut sized for a TPU launch)
is 0: the port gathers every device-plane round on the device, so the two
count the same ``xfer``.

``subs`` rewrites a test file's source on one side before it runs (each
old string must occur), for the cases whose impl the port does not have
(``'interpret'``, a TPU mode) or where a documented difference changes
what the port asserts.

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
from typing import Dict, List, Optional, Sequence, Tuple

import pytest

PKGS = {"jax": "repro.core", "torch": "repro_torch.core"}
TRACKED = ("LibraStack", "LibraSocket", "ProxyRuntime", "ClusterRuntime",
           "LibraCluster", "FaultPlan", "PolicyTable", "HealthTable",
           "AnchorPool", "VpiRegistry", "Connection", "RxRing")
TESTS = Path(__file__).resolve().parent


#: a side's source rewrites: ``[(old, new), ...]``
Subs = Sequence[Tuple[str, str]]


def load(path: Path, pkg: str, subs: Subs = ()) -> types.ModuleType:
    """``path`` executed as a fresh module, ``subs`` applied to its source
    and its ``repro.core`` and ``repro.kernels`` imports pointed at
    ``PKGS[pkg]``'s package."""
    src = Path(path).read_text()
    for old, new in subs:
        assert old in src, f"{Path(path).name}: {old!r} not found"
        src = src.replace(old, new)
    if pkg == "torch":
        src = re.sub(r"\brepro\.core\b", PKGS["torch"], src)
        src = re.sub(r"\brepro\.kernels\b", "repro_torch.kernels", src)
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


#: the JAX side's impl for a port impl the JAX package names otherwise
JAX_IMPL = {"fused-round": "fused-round:ref"}
#: the port's device dispatch, run beside a JAX test's own device impls
PORT_IMPLS = ("auto", "fused-round")


def impl_cases(path: Path, skip=()) -> List[Tuple[str, dict, dict, str]]:
    """:func:`cases` as ``(name, jax_params, port_params, id)``. An
    ``impl`` of ``'interpret'`` (a TPU mode the port does not have, and
    broken on the installed jax for the anchoring kernels) runs as
    ``'ref'`` on both sides; a test whose ``impl`` grid holds a device
    impl also runs each of :data:`PORT_IMPLS` on the port against its JAX
    counterpart."""
    grid = cases(path, skip)
    out = []
    for case in grid:
        name, params = case
        impl = params.get("impl")
        if impl == "interpret":
            params = dict(params, impl="ref")
        out.append((name, params, params,
                    case_id(case) + ("-as-ref" if impl == "interpret"
                                     else "")))
    seen = set()
    for name, params in grid:
        if params.get("impl", "host") == "host" or name in seen:
            continue
        seen.add(name)
        for impl in PORT_IMPLS:
            port = dict(params, impl=impl)
            out.append((name, dict(params, impl=JAX_IMPL.get(impl, impl)),
                        port, case_id((name, port))))
    return out


def _state(obj) -> tuple:
    kind = type(obj).__name__
    if kind == "LibraStack":
        a = obj.alloc
        xfer = dict(obj.pool.xfer)
        xfer.pop("donated_rounds", None)
        xfer.pop("host_gathers", None)
        return (kind, dataclasses.asdict(obj.counters), a.free_pages,
                a.total_pages, a.granted_out_pages, len(obj.registry),
                xfer, getattr(obj.pool, "fused_buffers", None))
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
    construction order); port stacks and ``PolicyTable.match_batch``
    default to ``device="cpu"``, and the JAX package's small-gather
    shortcut is off."""
    core = importlib.import_module(PKGS[pkg])
    made: list = []
    saved = []
    mp = pytest.MonkeyPatch()
    if pkg == "jax":
        mp.setattr(core.stack, "_SMALL_GATHER_ROWS", 0)
    else:
        match = core.PolicyTable.match_batch

        def match_batch(self, *args, **kw):
            kw.setdefault("device", "cpu")
            return match(self, *args, **kw)

        mp.setattr(core.PolicyTable, "match_batch", match_batch)

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
        mp.undo()


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


def run(path: Path, name: str, *, subs: Optional[Dict[str, Subs]] = None,
        jax_params: Optional[dict] = None, **params) -> Dict[str, list]:
    """Run test ``name`` of ``path`` through both packages and assert that
    what they built ends the same. ``subs`` maps a package to its source
    rewrites; ``jax_params``, when given, are the JAX side's parameters
    (``params`` the port's). Returns the records."""
    subs = subs or {}
    fns = {pkg: getattr(load(path, pkg, subs.get(pkg, ())), name)
           for pkg in PKGS}
    if hasattr(fns["jax"], "hypothesis"):
        return _run_given(fns)
    sync_connection_ids()
    kw = {"jax": params if jax_params is None else jax_params,
          "torch": params}
    seen = {pkg: observed(pkg, fn, **copy.deepcopy(kw[pkg]))
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
