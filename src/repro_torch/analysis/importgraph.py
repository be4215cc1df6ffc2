"""Import-graph hygiene check (``IMPORT001``).

Builds the static import graph of the ``repro_torch`` package plus the
repo's executable roots (``tests/``, ``scripts/``, ``examples/``,
``benchmarks_torch/`` and the root-level ``chip_smoke.py``, which drives
most of the package on the card) and flags any ``repro_torch`` module that
no root can reach.
Unreachable modules are dead weight: nothing tests them, nothing ships
them, and they silently rot. Intentional staging of future work is
legitimate — waive it in the module itself with the standard comment
(``libra: waive[IMPORT001] <reason>`` after a ``#``, anywhere in the
file; the finding anchors to the waiver line). A module
driven only through ``subprocess``/``importlib`` is invisible to the
static graph and needs the same waiver. The gate runs at zero unexplained
findings; a stale waiver on a module that became reachable is itself
flagged (``WAIVER002``).

Pure-AST: modules are never imported, so a module with a missing optional
dependency still participates in the graph.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set

from repro_torch.analysis.common import Finding, Report, build_report

IMPORT_RULES = ("IMPORT001",)

REPO_ROOT = Path(__file__).resolve().parents[3]
PKG_ROOT = REPO_ROOT / "src" / "repro_torch"
ENTRY_DIRS = ("tests", "scripts", "examples", "benchmarks_torch")
ENTRY_FILES = ("chip_smoke.py",)
ROOTS = "/".join(ENTRY_DIRS + ENTRY_FILES)


def _module_name(py: Path) -> str:
    rel = py.relative_to(PKG_ROOT.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports(py: Path, within: str) -> Set[str]:
    """repro_torch.* modules imported by ``py``; ``within`` resolves
    relatives."""
    try:
        tree = ast.parse(py.read_text(), filename=str(py))
    except SyntaxError:
        return set()
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names
                       if a.name.split(".")[0] == "repro_torch")
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = within.split(".")
                base = base[: len(base) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod.split(".")[0] == "repro_torch":
                out.add(mod)
                # `from repro_torch.core import cluster` names a submodule, not
                # an attribute — add both candidates; unknowns are dropped
                # when edges are resolved against the real module set
                out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def build_graph() -> Dict[str, Set[str]]:
    """module -> set of repro_torch modules it imports (package-internal only)."""
    modules = {_module_name(py): py for py in PKG_ROOT.rglob("*.py")}
    graph: Dict[str, Set[str]] = {}
    for name, py in modules.items():
        deps = set()
        for imp in _imports(py, name):
            # resolve to the longest known prefix (repro_torch.core.cluster.Foo
            # -> repro_torch.core.cluster); importing a package pulls __init__
            parts = imp.split(".")
            while parts and ".".join(parts) not in modules:
                parts.pop()
            if parts:
                deps.add(".".join(parts))
        graph[name] = deps - {name}
    return graph


def entry_imports() -> Set[str]:
    """repro_torch modules imported directly by any executable root."""
    out: Set[str] = set()
    for d in ENTRY_DIRS:
        root = REPO_ROOT / d
        if not root.is_dir():
            continue
        for py in root.rglob("*.py"):
            out |= _imports(py, "")
    for name in ENTRY_FILES:
        py = REPO_ROOT / name
        if py.is_file():
            out |= _imports(py, "")
    return out


def unreachable() -> List[str]:
    """repro_torch modules no executable root can reach, sorted."""
    graph = build_graph()
    # `python -m pkg` entry points are roots in their own right
    roots = {m for m in graph if m.rsplit(".", 1)[-1] == "__main__"}
    for imp in entry_imports():
        parts = imp.split(".")
        while parts and ".".join(parts) not in graph:
            parts.pop()
        if parts:
            roots.add(".".join(parts))
    seen: Set[str] = set()
    stack = list(roots)
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # importing repro_torch.core.cluster executes repro_torch/__init__
        # and repro_torch/core/__init__ too — packages on the dotted path count
        parts = mod.split(".")
        for i in range(1, len(parts)):
            pkg = ".".join(parts[:i])
            if pkg in graph and pkg not in seen:
                stack.append(pkg)
        stack.extend(graph.get(mod, ()))
    return sorted(m for m in graph if m not in seen)


def report_lines() -> List[str]:
    dead = unreachable()
    if not dead:
        return [f"imports: all repro_torch modules reachable from {ROOTS}"]
    lines = [f"imports: {len(dead)} module(s) unreachable from any "
             f"executable root ({ROOTS}):"]
    lines += [f"  {m}" for m in dead]
    return lines


def run() -> Report:
    """Gated report: one IMPORT001 finding per unreachable module, waived
    by a standard waiver comment anywhere inside the module."""
    modules = {_module_name(py): py for py in PKG_ROOT.rglob("*.py")}
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    for mod in unreachable():
        py = modules[mod]
        rel = str(py.relative_to(REPO_ROOT))
        text = py.read_text()
        sources[rel] = text
        # anchor the finding to the module's waiver comment if it has one
        # (the waiver mechanism is line-based; "this whole module" is not)
        line = 1
        for i, t in enumerate(text.splitlines(), start=1):
            if "waive[IMPORT001]" in t:
                line = i
                break
        findings.append(Finding(
            rel, line, "IMPORT001",
            f"module {mod} is unreachable from any executable root "
            f"({ROOTS}) — wire it into a test or entry "
            f"point, or waive it with a staging reason"))
    # reachable modules still participate in the stale-waiver sweep
    for py in PKG_ROOT.rglob("*.py"):
        rel = str(py.relative_to(REPO_ROOT))
        sources.setdefault(rel, py.read_text())
    return build_report("imports", findings, sources, rules=IMPORT_RULES)
