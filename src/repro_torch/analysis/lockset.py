"""Pass 3 — lockset checker for the cluster plane.

The ROADMAP's worker-per-thread executor turns every object reachable from
two workers into a data race. This pass derives that shared-mutable-state
map *statically* and verifies the locking discipline of
:mod:`repro_torch.core.sync` before any thread exists — the eBPF-verifier move
of the source paper applied to the repo's own control plane.

Three static checks plus a committed manifest:

- **Shared-class map** — for each class shared across workers
  (``AnchorPool``, ``VpiRegistry``, ``SteeringPolicy``, ``HealthTable``)
  derive the set of attributes its methods mutate (AST attribute-write
  analysis). This is the state a thread could corrupt.
- **Cross-worker mutation sites** (``LOCK001``) — in the plane files
  (``cluster.py``, ``egress.py``, ``stack.py``), find every statement that
  mutates *peer-rooted* state — a receiver whose provenance traces to
  another worker (``find_owner``/``pool_for_entry``/``pool_router``
  results, ``_worker_by_pool`` lookups, ``.owner_registry`` handles,
  iteration over ``.workers``, the ``dst_stack`` parameter) — and require
  it to run under a lock: lexically inside ``with <x>.lock:`` /
  ``with plane_lock(...):``, or inside a ``*_locked`` function (whose
  callers must themselves hold the lock — also checked).
- **Lock plumbing** (``LOCK003``) — ``SteeringPolicy`` and ``HealthTable``
  must be self-locking (every mutator takes ``self.lock``), and
  ``LibraCluster.__init__`` must attach the plane lock to each worker's
  ``alloc`` and ``registry``.
- **Manifest** (``LOCK002``) — the derived map is compared against the
  committed ``shared_state_manifest.json`` (line-number-free, so pure code
  motion never trips it). New shared state or a new cross-worker touch
  point must be reviewed and re-committed:
  ``python -m repro_torch.analysis --write-manifest``.

Test-time, :class:`LocksetMonitor` instruments every worker's allocator
and registry mutators, records which worker context
(``LibraCluster.current_worker``) touches each object, and emits
``LOCK004`` when a cross-worker mutation runs without the plane lock held
— the dynamic readiness gate the threaded executor must pass. Telemetry
counters (``stats`` dicts, ``resolve`` hit/miss bumps) are deliberately
out of scope: they are benign-racy by design and never feed back into
datapath decisions.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, Report, build_report

REPO_ROOT = Path(__file__).resolve().parents[3]
MANIFEST_PATH = Path(__file__).resolve().parent / "shared_state_manifest.json"

LOCKSET_RULES = ("LOCK001", "LOCK002", "LOCK003", "LOCK004")

#: classes whose instances are reachable from >= 2 workers
SHARED_CLASSES = {
    "AnchorPool": "src/repro_torch/core/anchor_pool.py",
    "VpiRegistry": "src/repro_torch/core/vpi.py",
    "SteeringPolicy": "src/repro_torch/core/cluster.py",
    "HealthTable": "src/repro_torch/core/policy.py",
}

#: files whose functions can reach a PEER worker's state
PLANE_FILES = (
    "src/repro_torch/core/cluster.py",
    "src/repro_torch/core/egress.py",
    "src/repro_torch/core/stack.py",
)

#: methods that mutate cluster-plane state when called on a peer object
PLANE_MUTATORS = frozenset({
    # AnchorPool
    "alloc_page", "alloc_sequence", "alloc_batch", "free_pages_list",
    "free_batch", "retain", "defer_free", "expire_deferred",
    "export_grant", "release_export",
    "stage_transfer", "commit_transfer", "abort_transfer",
    # VpiRegistry
    "register", "import_grant", "release", "drop", "begin_teardown",
    "expire_teardowns",
})
#: generic container mutators — a mutation when the receiver is peer-rooted
CONTAINER_MUTATORS = frozenset({
    "append", "extend", "add", "insert", "pop", "remove", "clear",
    "update", "setdefault", "sort",
})

#: provenance: names whose values reach a peer worker
PEER_PARAMS = frozenset({"dst_stack"})
PEER_RESOLVERS = frozenset({"find_owner", "pool_for_entry", "pool_router"})
PEER_ATTRS = frozenset({"owner_registry"})

#: self-locking classes: these mutators must take self.lock internally
SELF_LOCKED = {
    "SteeringPolicy": ("worker_for", "forget", "resteer", "remove_worker"),
    "HealthTable": ("note_failure", "note_success", "tick",
                    "mark_down", "mark_up"),
}


# -- shared-class attribute-write analysis ---------------------------------

def _attr_root(expr: ast.expr) -> Optional[str]:
    """Leftmost Name of an attribute/subscript/call chain."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _self_attr(expr: ast.expr) -> Optional[str]:
    """The X of a ``self.X``-rooted chain (attribute, subscript, call)."""
    node = expr
    prev = None
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        prev = node
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name) and node.id == "self" and \
            isinstance(prev, ast.Attribute):
        return prev.attr
    return None


def _mutated_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes of ``self`` that any method of ``cls`` writes."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out.add(attr)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in CONTAINER_MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                out.add(attr)
    return out


def derive_shared_classes(root: Path = REPO_ROOT) -> Dict[str, List[str]]:
    """{class name: sorted mutated attributes} for every shared class."""
    out: Dict[str, List[str]] = {}
    for name, rel in SHARED_CLASSES.items():
        tree = ast.parse((root / rel).read_text(), filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name == name:
                out[name] = sorted(_mutated_attrs(node))
    return out


# -- cross-worker mutation-site analysis -----------------------------------

def _expr_is_peer(expr: ast.expr, peers: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in peers:
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in PEER_RESOLVERS:
                return True
            if name == "get" and isinstance(f, ast.Attribute) and \
                    "_worker_by_pool" in ast.dump(f.value):
                return True
        if isinstance(node, ast.Attribute) and node.attr in PEER_ATTRS:
            return True
        if isinstance(node, ast.Attribute) and node.attr == "workers":
            return True
    return False


def _peer_names(func: ast.AST) -> Set[str]:
    """Names in ``func`` whose provenance traces to a peer worker
    (flow-insensitive union, iterated to a fixpoint)."""
    peers: Set[str] = set()
    args = getattr(func, "args", None)
    if args is not None:
        peers |= PEER_PARAMS & {a.arg for a in args.args}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            new: List[str] = []
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name) and \
                        _expr_is_peer(node.value, peers):
                    new.append(t.id)
                elif isinstance(t, ast.Tuple) and \
                        isinstance(node.value, ast.Tuple):
                    for tt, vv in zip(t.elts, node.value.elts):
                        if isinstance(tt, ast.Name) and \
                                _expr_is_peer(vv, peers):
                            new.append(tt.id)
            elif isinstance(node, ast.For) and \
                    _expr_is_peer(node.iter, peers):
                new.extend(n.id for n in ast.walk(node.target)
                           if isinstance(n, ast.Name))
            for n in new:
                if n not in peers:
                    peers.add(n)
                    changed = True
    return peers


def _is_lock_ctx(expr: ast.expr) -> bool:
    """``with self.lock:`` / ``with cluster.lock:`` /
    ``with plane_lock(...):``"""
    if isinstance(expr, ast.Attribute) and expr.attr == "lock":
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", "")
        return name == "plane_lock"
    return False


class _SiteScanner:
    """Finds cross-worker mutation sites in one function and records
    whether each runs under a lock."""

    def __init__(self, filename: str, qualname: str, func: ast.AST):
        self.filename = filename
        self.qualname = qualname
        self.func = func
        self.peers = _peer_names(func)
        self.sites: List[dict] = []
        self.findings: List[Finding] = []

    def run(self) -> None:
        if self.func.name == "__init__":
            # construction happens-before publication: an object being
            # wired up in __init__ is not yet reachable from any worker
            return
        start_locked = self.func.name.endswith("_locked")
        for stmt in self.func.body:
            self._scan(stmt, start_locked)

    def _scan(self, node: ast.AST, locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are scanned as their own functions
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locked or any(_is_lock_ctx(i.context_expr)
                                  for i in node.items)
            for item in node.items:
                self._visit_exprs(item.context_expr, locked)
            for s in node.body:
                self._scan(s, inner)
            return
        self._visit_exprs(node, locked)
        for field in ("body", "orelse", "finalbody"):
            for s in getattr(node, field, []) or []:
                self._scan(s, locked)
        for h in getattr(node, "handlers", []) or []:
            for s in h.body:
                self._scan(s, locked)

    @staticmethod
    def _walk_exprs(node: ast.AST):
        """Walk expression-level descendants only — nested statements are
        scanned by :meth:`_scan` with their own lock state."""
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                continue
            yield from _SiteScanner._walk_exprs(child)

    def _visit_exprs(self, stmt: ast.AST, locked: bool) -> None:
        for node in self._walk_exprs(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                meth = node.func.attr
                root = _attr_root(node.func.value)
                if root in self.peers and (
                        meth in PLANE_MUTATORS
                        or meth in CONTAINER_MUTATORS):
                    self._site(node, ast.unparse(node.func), "call", locked)
                elif meth.endswith("_locked") and not locked:
                    self.findings.append(Finding(
                        self.filename, node.lineno, "LOCK001",
                        f"{self.qualname}: call to {meth}() outside a "
                        f"lock-holding context — *_locked callees require "
                        f"the caller to hold the plane lock"))
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)) and \
                        _attr_root(t) in self.peers:
                    self._site(node, ast.unparse(t), "store", locked)

    def _site(self, node: ast.AST, path: str, kind: str,
              locked: bool) -> None:
        self.sites.append({"file": self.filename, "func": self.qualname,
                           "path": path, "kind": kind})
        if not locked:
            self.findings.append(Finding(
                self.filename, node.lineno, "LOCK001",
                f"{self.qualname}: unsynchronized cross-worker mutation "
                f"of peer state via '{path}' ({kind}) — wrap in the "
                f"cluster-plane lock (with <lock>: / plane_lock())"))


def _functions(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """(qualname, node) for every function, with Class.method names."""
    out: List[Tuple[str, ast.AST]] = []

    def walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((prefix + child.name, child))
                walk(child, prefix + child.name + ".")
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".")

    walk(tree, "")
    return out


def derive_sites(root: Path = REPO_ROOT
                 ) -> Tuple[List[dict], List[Finding]]:
    """All cross-worker mutation sites in the plane files, plus LOCK001
    findings for any not under a lock."""
    sites: List[dict] = []
    findings: List[Finding] = []
    for rel in PLANE_FILES:
        tree = ast.parse((root / rel).read_text(), filename=rel)
        for qualname, func in _functions(tree):
            sc = _SiteScanner(rel, qualname, func)
            sc.run()
            sites.extend(sc.sites)
            findings.extend(sc.findings)
    sites.sort(key=lambda s: (s["file"], s["func"], s["path"], s["kind"]))
    # the same dotted path may be touched on several lines of one function
    dedup = []
    for s in sites:
        if not dedup or dedup[-1] != s:
            dedup.append(s)
    return dedup, findings


# -- lock plumbing checks ---------------------------------------------------

def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


def _takes_self_lock(func: ast.FunctionDef, siblings: Sequence[str]) -> bool:
    """The method body enters ``with self.lock`` or delegates to another
    self-locked sibling."""
    for node in ast.walk(func):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Attribute) and ctx.attr == "lock" \
                        and isinstance(ctx.value, ast.Name) \
                        and ctx.value.id == "self":
                    return True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self" \
                and node.func.attr in siblings:
            return True
    return False


def check_plumbing(root: Path = REPO_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    classes: Dict[str, Tuple[str, ast.ClassDef]] = {}
    for rel in sorted(set(SHARED_CLASSES.values())):
        tree = ast.parse((root / rel).read_text(), filename=rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = (rel, node)
    # 1. self-locking classes: lock in __init__, every mutator takes it
    for cname, methods in SELF_LOCKED.items():
        rel, cls = classes[cname]
        init = _method(cls, "__init__")
        has_lock = init is not None and any(
            _self_attr(t) == "lock"
            for n in ast.walk(init) if isinstance(n, ast.Assign)
            for t in n.targets)
        if not has_lock:
            findings.append(Finding(
                rel, cls.lineno, "LOCK003",
                f"{cname}.__init__ does not create self.lock — the class "
                f"is shared across workers and must be self-locking"))
        for mname in methods:
            m = _method(cls, mname)
            if m is None or not _takes_self_lock(m, methods):
                findings.append(Finding(
                    rel, (m or cls).lineno, "LOCK003",
                    f"{cname}.{mname} mutates shared state without "
                    f"taking self.lock"))
    # 2. LibraCluster.__init__ attaches the plane lock to alloc + registry
    rel = "src/repro_torch/core/cluster.py"
    cls = classes.get("LibraCluster", (rel, None))[1]
    init = _method(cls, "__init__") if cls is not None else None
    attached: Set[str] = set()
    if init is not None:
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "lock" \
                            and isinstance(t.value, ast.Attribute):
                        attached.add(t.value.attr)
    for need in ("alloc", "registry"):
        if need not in attached:
            findings.append(Finding(
                rel, (init or cls).lineno if cls is not None else 0,
                "LOCK003",
                f"LibraCluster.__init__ does not attach the plane lock to "
                f"each worker's {need} (w.{need}.lock = self.lock) — "
                f"plane_lock() degrades to a no-op"))
    return findings


# -- manifest ---------------------------------------------------------------

def derive(root: Path = REPO_ROOT) -> Tuple[dict, List[Finding]]:
    """(shared-state manifest dict, LOCK001/LOCK003 findings)."""
    sites, findings = derive_sites(root)
    findings.extend(check_plumbing(root))
    manifest = {"version": 1,
                "classes": derive_shared_classes(root),
                "sites": sites}
    return manifest, findings


def write_manifest(root: Path = REPO_ROOT,
                   path: Path = MANIFEST_PATH) -> dict:
    manifest, _ = derive(root)
    path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return manifest


def compare_manifest(derived: dict,
                     committed: Optional[dict]) -> List[Finding]:
    loc = str(MANIFEST_PATH.relative_to(REPO_ROOT))
    if committed is None:
        return [Finding(loc, 0, "LOCK002",
                        "shared-state manifest missing — generate with "
                        "`python -m repro_torch.analysis --write-manifest` and "
                        "commit it")]
    findings: List[Finding] = []
    for cname, attrs in derived["classes"].items():
        old = committed.get("classes", {}).get(cname)
        if old != attrs:
            extra = sorted(set(attrs) - set(old or []))
            gone = sorted(set(old or []) - set(attrs))
            findings.append(Finding(
                loc, 0, "LOCK002",
                f"shared-state drift in {cname}: new mutable attrs "
                f"{extra or '[]'}, removed {gone or '[]'} — review the "
                f"locking impact, then re-run --write-manifest"))
    key = lambda s: (s["file"], s["func"], s["path"], s["kind"])  # noqa: E731
    derived_sites = {key(s) for s in derived["sites"]}
    committed_sites = {key(s) for s in committed.get("sites", [])}
    for f, fn, p, k in sorted(derived_sites - committed_sites):
        findings.append(Finding(
            loc, 0, "LOCK002",
            f"new cross-worker mutation site {fn}: {p} ({k}) in {f} — "
            f"review its locking, then re-run --write-manifest"))
    for f, fn, p, k in sorted(committed_sites - derived_sites):
        findings.append(Finding(
            loc, 0, "LOCK002",
            f"manifest site {fn}: {p} ({k}) in {f} no longer exists — "
            f"re-run --write-manifest"))
    return findings


def run(root: Path = REPO_ROOT) -> Report:
    derived, findings = derive(root)
    committed = None
    if MANIFEST_PATH.exists():
        committed = json.loads(MANIFEST_PATH.read_text())
    findings.extend(compare_manifest(derived, committed))
    sources = {rel: (root / rel).read_text()
               for rel in list(PLANE_FILES)
               + sorted(set(SHARED_CLASSES.values()))}
    return build_report("lockset", findings, sources, rules=LOCKSET_RULES)


# -- test-time lockset instrumentation --------------------------------------

#: per-worker objects whose mutators the monitor wraps
MONITORED = {
    "alloc": ("alloc_page", "alloc_sequence", "alloc_batch",
              "free_pages_list", "free_batch", "retain", "defer_free",
              "expire_deferred", "export_grant", "release_export",
              "stage_transfer", "commit_transfer", "abort_transfer"),
    "registry": ("register", "import_grant", "release", "drop",
                 "begin_teardown", "expire_teardowns", "retain"),
}


class LocksetMonitor:
    """Records, per shared object, the set of worker contexts that mutate
    it, and emits a ``LOCK004`` finding for every cross-worker mutation
    executed without the cluster-plane lock held.

    Usage::

        with LocksetMonitor(cluster) as mon:
            ... drive the ClusterRuntime ...
        assert not mon.violations, mon.format()

    Attribution comes from ``cluster.current_worker`` (maintained by
    ``ClusterRuntime`` around each scheduling quantum); ``None`` is the
    control plane, which is single-threaded by construction and therefore
    never a violation. A mutation of worker ``j``'s allocator or registry
    from worker ``i != j``'s quantum must hold ``cluster.lock`` — that is
    the invariant a worker-per-thread executor needs."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.accessors: Dict[str, Set[Optional[int]]] = {}
        self.violations: List[Finding] = []
        self._seen: Set[Tuple[str, str, int]] = set()
        self._installed: List[Tuple[object, str]] = []

    # -- install / restore --------------------------------------------------
    def __enter__(self) -> "LocksetMonitor":
        for w in self.cluster.workers:
            for role, obj in (("alloc", w.alloc), ("registry", w.registry)):
                label = f"worker{w.worker_id}.{role}"
                for meth in MONITORED[role]:
                    self._wrap(obj, meth, label, w.worker_id)
        return self

    def __exit__(self, *exc) -> None:
        for obj, meth in self._installed:
            # the wrapper shadows the class method via an instance
            # attribute; deleting it restores normal lookup
            delattr(obj, meth)
        self._installed.clear()

    def _wrap(self, obj, meth: str, label: str, owner: int) -> None:
        orig = getattr(obj, meth)

        def wrapped(*args, **kw):
            self._record(label, meth, owner)
            return orig(*args, **kw)

        setattr(obj, meth, wrapped)
        self._installed.append((obj, meth))

    def _record(self, label: str, meth: str, owner: int) -> None:
        cur = self.cluster.current_worker
        self.accessors.setdefault(label, set()).add(cur)
        if cur is None or cur == owner:
            return
        if not self.cluster.lock.held:
            key = (label, meth, cur)
            if key not in self._seen:
                self._seen.add(key)
                self.violations.append(Finding(
                    f"<runtime:{label}>", 0, "LOCK004",
                    f"{label}.{meth}() mutated from worker {cur}'s "
                    f"context without the cluster-plane lock held"))

    # -- reporting -----------------------------------------------------------
    def shared_objects(self) -> Dict[str, Set[Optional[int]]]:
        """Objects actually touched from >= 2 distinct contexts."""
        return {k: v for k, v in self.accessors.items() if len(v) > 1}

    def format(self) -> str:
        return "\n".join(f.format() for f in self.violations)

    def report(self) -> Report:
        return Report(name="lockset-runtime", active=list(self.violations),
                      waived=[])
