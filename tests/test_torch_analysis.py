"""The port's datapath verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``).

Every synthetic-source test of ``tests/test_analysis.py`` runs through
both packages' passes on the same source strings (read from that file's
AST), one parametrised case each: ownership (OWN001–004, waivers and stale
waivers), lockset (LOCK001 and LOCK003 on the ``synth_root`` tree, built
here as that fixture builds it, and LOCK002 drift) and concurrency
(DEAD001–003, ATOM001–003, STEAL001–002). Both give the same findings:
file, line, rule, and the message once ``repro_torch`` reads as
``repro``. Then the port's passes over its own tree, its manifests against
the JAX package's, the import graph and its waivers, the CLI, and twins
(through ``tests/_twin.py``) of the runtime ``LocksetMonitor`` tests and
the fault-injection tests of ``tests/test_analysis.py``.
"""
import ast
import importlib
import json
from pathlib import Path

import pytest
import torch

import _twin
from repro.analysis import concurrency as jconc
from repro.analysis import lockset as jlock
from repro.analysis import ownership as jown
from repro.analysis.common import build_report as jbuild
from repro_torch.analysis import concurrency as tconc
from repro_torch.analysis import importgraph as timports
from repro_torch.analysis import lockset as tlock
from repro_torch.analysis import ownership as town
from repro_torch.analysis.common import build_report as tbuild

PATH = _twin.TESTS / "test_analysis.py"
REPO = _twin.TESTS.parent
ANALYSIS = REPO / "src" / "repro_torch" / "analysis"
_TREE = ast.parse(PATH.read_text())
#: module-level source strings of test_analysis.py (WAIVED_SRC, SYNTH_CLUSTER)
CONSTS = {n.targets[0].id: n.value.value for n in _TREE.body
          if isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant)
          and isinstance(n.value.value, str)}


def _sources(callee: str):
    """``(test name, src)`` for each test of test_analysis.py that binds a
    source string to ``src`` and calls ``callee``."""
    out = []
    for fn in _TREE.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        srcs = [n.value.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and isinstance(n.value,
                                                            ast.Constant)
                and [getattr(t, "id", None) for t in n.targets] == ["src"]]
        calls = {getattr(c.func, "id", getattr(c.func, "attr", None))
                 for c in ast.walk(fn) if isinstance(c, ast.Call)}
        if srcs and callee in calls:
            out.append((fn.name, srcs[0]))
    return out


def _norm(findings):
    """Findings as comparable tuples, ``repro_torch`` read as ``repro``."""
    return [(f.file.replace("repro_torch", "repro"), f.line, f.rule,
             f.message.replace("repro_torch", "repro"), f.waived,
             f.waiver_reason) for f in findings]


def _norm_json(obj):
    return json.loads(json.dumps(obj).replace("repro_torch", "repro"))


# ---------------------------------------------------------------------------
# ownership: every source of the JAX fixtures
# ---------------------------------------------------------------------------

OWN_CASES = (
    _sources("lint_source") + _sources("_report")
    + [("test_waiver_with_reason_moves_finding_to_waived",
        CONSTS["WAIVED_SRC"]),
       ("test_waiver_without_reason_is_its_own_finding",
        CONSTS["WAIVED_SRC"].replace(" freed by caller", ""))])


def test_ownership_cases_cover_the_jax_fixtures():
    names = {n for n, _ in OWN_CASES}
    jax_tests = {fn.name for fn in _TREE.body
                 if isinstance(fn, ast.FunctionDef)
                 and fn.name.startswith(("test_own", "test_waiver",
                                         "test_stale", "test_handoff",
                                         "test_bare_pin"))}
    assert names == jax_tests
    assert len(OWN_CASES) == len(names) == 13


@pytest.mark.parametrize("case", OWN_CASES, ids=[n for n, _ in OWN_CASES])
def test_ownership_twin(case):
    _name, src = case
    got = {}
    for pkg, own, build in (("jax", jown, jbuild), ("torch", town, tbuild)):
        raw = own.lint_source(src, "fix.py")
        rep = build("ownership", raw, {"fix.py": src},
                    rules=own.OWNERSHIP_RULES)
        got[pkg] = (_norm(raw), _norm(rep.active), _norm(rep.waived))
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# lockset: the synth_root tree, and manifest drift
# ---------------------------------------------------------------------------

def _synth_root(root: Path, pkg: str) -> Path:
    """test_analysis.py's ``synth_root`` tree under ``src/<pkg>/core``."""
    core = root / "src" / pkg / "core"
    core.mkdir(parents=True)
    (core / "cluster.py").write_text(CONSTS["SYNTH_CLUSTER"])
    (core / "egress.py").write_text("")
    (core / "stack.py").write_text("")
    (core / "anchor_pool.py").write_text("class AnchorPool:\n    pass\n")
    (core / "vpi.py").write_text("class VpiRegistry:\n    pass\n")
    (core / "policy.py").write_text(
        "class HealthTable:\n"
        "    def __init__(self):\n"
        "        self.state = {}\n")
    return root


def _lock001(lock, root):
    sites, findings = lock.derive_sites(root)
    return _norm_json(sites), _norm(findings)


def _lock003(lock, root):
    return _norm(lock.check_plumbing(root))


def _lock002(lock, _root):
    derived = {"classes": {"AnchorPool": ["_free", "stats"]},
               "sites": [{"file": "a.py", "func": "f", "path": "p.q",
                          "kind": "call"}]}
    committed = {"classes": {"AnchorPool": ["_free"]}, "sites": []}
    return (_norm(lock.compare_manifest(derived, committed)),
            _norm(lock.compare_manifest(derived, derived)),
            _norm(lock.compare_manifest(derived, None)))


LOCK_CASES = {"LOCK001": _lock001, "LOCK003": _lock003, "LOCK002": _lock002}


@pytest.mark.parametrize("rule", list(LOCK_CASES))
def test_lockset_twin(rule, tmp_path):
    got = {pkg: LOCK_CASES[rule](lock, _synth_root(tmp_path / pkg, name))
           for pkg, lock, name in (("jax", jlock, "repro"),
                                   ("torch", tlock, "repro_torch"))}
    assert got["torch"] == got["jax"]
    assert any(got["jax"]), "the case must find something"


# ---------------------------------------------------------------------------
# concurrency: every source of the JAX fixtures, and hierarchy drift
# ---------------------------------------------------------------------------

CONC_CASES = _sources("_conc_scan") + _sources("derive_lock_graph")


def _conc(conc, pkg, src):
    """test_analysis.py's ``_conc_scan`` (all three scanners), plus the
    derived lock-order edges."""
    sources = {f"src/{pkg}/core/cluster.py": src}
    edges, findings = conc.derive_lock_graph(sources)
    findings += conc.check_lock_order(edges)
    findings += conc.scan_atomicity(sources)
    findings += conc.scan_steal(sources)
    return _norm_json(edges), _norm(findings)


def test_concurrency_cases_cover_the_jax_fixtures():
    jax_tests = {fn.name for fn in _TREE.body
                 if isinstance(fn, ast.FunctionDef)
                 and fn.name.startswith(("test_dead", "test_atom",
                                         "test_steal"))}
    assert {n for n, _ in CONC_CASES} | {
        "test_dead003_hierarchy_manifest_drift"} == jax_tests
    assert len(CONC_CASES) == 15


@pytest.mark.parametrize("case", CONC_CASES, ids=[n for n, _ in CONC_CASES])
def test_concurrency_twin(case):
    _name, src = case
    assert _conc(tconc, "repro_torch", src) == _conc(jconc, "repro", src)


def test_concurrency_hierarchy_drift_twin():
    def drift(conc):
        base = {"version": 1, "ranks": dict(conc.LOCK_RANKS),
                "edges": [{"src": "plane", "dst": "steering",
                           "file": "a.py", "func": "f"}]}
        grown = {**base, "edges": base["edges"] + [
            {"src": "registry", "dst": "alloc", "file": "b.py",
             "func": "g"}]}
        return [_norm(conc.compare_hierarchy(a, b)) for a, b in
                ((base, base), (base, None), (grown, base), (base, grown))]
    got = drift(tconc)
    assert got == drift(jconc)
    assert [len(x) for x in got] == [0, 1, 1, 1]


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def _kernels_cpu():
    from repro_torch.analysis import kernel_audit
    return kernel_audit.run("cpu")


REAL_PASSES = {"ownership": lambda: town.run(), "kernels": _kernels_cpu,
               "lockset": lambda: tlock.run(),
               "concurrency": lambda: tconc.run(),
               "imports": lambda: timports.run()}


@pytest.mark.parametrize("name", list(REAL_PASSES))
def test_real_tree_pass_clean(name):
    rep = REAL_PASSES[name]()
    assert rep.ok, "\n".join(rep.lines())


def _derived_manifest(name):
    if name == "shared_state_manifest":
        return tlock.derive()[0], tlock.MANIFEST_PATH
    sources = {rel: (REPO / rel).read_text()
               for rel in tconc.CONCURRENCY_FILES}
    edges, _ = tconc.derive_lock_graph(sources)
    return tconc.hierarchy_manifest(edges), tconc.HIERARCHY_PATH


MANIFESTS = ("shared_state_manifest", "lock_hierarchy_manifest")


@pytest.mark.parametrize("name", MANIFESTS)
def test_committed_manifests_are_current(name):
    derived, path = _derived_manifest(name)
    assert json.loads(path.read_text()) == derived, \
        f"{path.name} is stale: python -m repro_torch.analysis --write-manifest"


def _entries(manifest: dict) -> dict:
    """A manifest's entries by a name: each class, site and edge."""
    out = {}
    for cname, attrs in manifest.get("classes", {}).items():
        out[f"class {cname}"] = attrs
    for s in manifest.get("sites", []):
        out[f"site {s['file']}:{s['func']}:{s['path']}:{s['kind']}"] = s
    for e in manifest.get("edges", []):
        out[f"edge {e['src']}->{e['dst']} {e['file']}:{e['func']}"] = e
    for k in ("version", "ranks"):
        if k in manifest:
            out[k] = manifest[k]
    return out


@pytest.mark.parametrize("name", MANIFESTS)
def test_port_manifests_equal_the_jax_packages(name):
    port = _entries(_norm_json(json.loads(
        (ANALYSIS / f"{name}.json").read_text())))
    ref = _entries(json.loads(
        (REPO / "src" / "repro" / "analysis" / f"{name}.json").read_text()))
    only_port = sorted(set(port) - set(ref))
    only_ref = sorted(set(ref) - set(port))
    changed = sorted(k for k in set(port) & set(ref) if port[k] != ref[k])
    assert not (only_port or only_ref or changed), (
        f"{name}: only in the port {only_port}; only in the JAX package "
        f"{only_ref}; different {changed}")


# ---------------------------------------------------------------------------
# the import graph
# ---------------------------------------------------------------------------

CONFIG_WAIVERS = ("hymba", "internvl2", "libra_proxy", "minicpm",
                  "mistral_nemo", "phi3_mini", "phi4_mini", "qwen2_moe",
                  "qwen3_moe", "whisper_medium", "xlstm")


def test_import_graph_reaches_core_and_the_verifier():
    dead = timports.unreachable()
    assert "repro_torch.core" not in dead
    assert "repro_torch.core.stack" not in dead
    assert "repro_torch.core.cluster" not in dead
    assert "repro_torch.analysis.lockset" not in dead   # imported here


def test_import_graph_config_waivers_present_and_not_stale():
    rep = timports.run()
    assert rep.ok, "\n".join(rep.lines())
    assert sorted(f.file for f in rep.waived) == [
        f"src/repro_torch/configs/{m}.py" for m in CONFIG_WAIVERS]
    assert all(f.rule == "IMPORT001" and f.waiver_reason
               and "repro_torch.configs" in f.waiver_reason
               for f in rep.waived)
    assert not [f for f in rep.active if f.rule.startswith("WAIVER")]


@pytest.mark.parametrize("py", sorted(ANALYSIS.glob("*.py")),
                         ids=lambda p: p.name)
def test_analysis_imports_neither_jax_nor_the_jax_package(py):
    tree = ast.parse(py.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                    "repro")]
    assert not bad, f"{py.name} imports {bad}"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--pass", "ownership"],
                                  ["--pass", "kernels", "--device", "cpu"]],
                         ids=["ownership", "kernels-cpu"])
def test_cli_runs_selected_pass(argv):
    from repro_torch.analysis.__main__ import main
    assert main(argv) == 0


def test_cli_kernels_pass_never_falls_back_to_the_cpu():
    from repro_torch.analysis.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the pass runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pass", "kernels"])


# ---------------------------------------------------------------------------
# twins of the runtime lockset monitor and the fault-injection tests
# ---------------------------------------------------------------------------

#: the port's side imports the port's verifier (it has no jaxpr audit)
SUBS = {"torch": [
    ("from repro.analysis import (\n    concurrency,\n    importgraph,\n"
     "    jaxpr_audit,\n", "from repro_torch.analysis import (\n"
     "    concurrency,\n    importgraph,\n"),
    ("from repro.analysis.common import", "from repro_torch.analysis.common"
     " import"),
    ("from repro.analysis.ownership import", "from repro_torch.analysis."
     "ownership import"),
]}

MONITOR = ("test_monitor_clean_on_locked_cross_worker_grants",
           "test_monitor_clean_on_work_stealing",
           "test_monitor_uninstalls_cleanly")
FAULTS = ("test_ingress_write_payload_fault_returns_pages_to_pool",
          "test_recv_batch_crypto_fault_frees_whole_round",
          "test_grant_into_import_fault_releases_export_pin")


def test_port_side_imports_the_port_verifier():
    mod = _twin.load(PATH, "torch", SUBS["torch"])
    assert mod.lockset is importlib.import_module(
        "repro_torch.analysis.lockset")
    assert mod.LibraCluster.__module__.startswith("repro_torch.")


@pytest.mark.parametrize("name", MONITOR)
def test_lockset_monitor_twin(name):
    _twin.run(PATH, name, subs=SUBS)


class _SharedMonkeyPatch(pytest.MonkeyPatch):
    """One MonkeyPatch for both sides of a twin: ``_twin.run`` deep-copies
    a test's arguments, and a copy's patches could not be undone here."""

    def __deepcopy__(self, memo):
        return self


@pytest.mark.parametrize("name", FAULTS)
def test_fault_injection_twin(name):
    mp = _SharedMonkeyPatch()
    try:
        _twin.run(PATH, name, subs=SUBS, monkeypatch=mp)
    finally:
        mp.undo()
