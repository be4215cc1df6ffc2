"""Pass 4 — concurrency verifier: lock order, atomicity, steal-path.

:mod:`repro_torch.analysis.lockset` answers "is each cross-worker mutation site
locked?".  This pass answers the *global* questions a worker-per-thread
executor adds on top — the readiness gate ``ClusterRuntime.run_parallel
(threads=True)`` ships behind:

- **Lock order** (``DEAD001``–``DEAD003``) — statically derive the lock
  *acquisition graph*: every ``with <x>.lock`` / ``with plane_lock(...)``
  entry (plus ``*_locked`` functions, whose body holds the plane lock from
  entry, and calls into the self-locking ``SteeringPolicy``/``HealthTable``
  mutators, which acquire their leaf lock internally) is classified into a
  lock *class* and every nested acquisition becomes an edge.  ``DEAD001``
  flags cycles (a static deadlock), ``DEAD002`` flags order inversions
  against the committed rank table (acquisition must follow strictly
  increasing rank: plane=0 < registry=1 < alloc=2 < steering/health=3 —
  the :mod:`repro_torch.core.sync` contract), ``DEAD003`` flags unclassifiable
  acquisitions and drift against the committed
  ``lock_hierarchy_manifest.json`` (line-number-free; re-commit with
  ``python -m repro_torch.analysis --write-manifest`` after review).  In a
  cluster the plane/registry/alloc classes are today one lock object
  (reentrant), so the graph is the contract that keeps a future
  per-island fine-graining deadlock-free, not a present-tense hazard —
  which is exactly when it is cheap to enforce.

- **Atomicity** (``ATOM001``–``ATOM003``) — a guard (``peek``,
  ``can_admit``, ``above_watermark``, ``find_owner``, ``torn_down``,
  ``healthy``) and the mutation it authorizes form one invariant; the
  lock must span the *whole* region.  ``ATOM001``: a guard call on
  peer-rooted state whose test dominates a plane mutation of peer-rooted
  state, with the region not inside one continuous lock scope
  (check-then-act).  ``ATOM002``: a read-modify-write (``+=`` and
  friends) of allocator/registry state in a plane file outside any lock
  scope (lost-update).  ``ATOM003``: a guard result produced in one lock
  scope and consumed in a *different* scope of the same lock class —
  release/re-acquire fragmentation: the invariant the guard established
  died at the first release.  (``resolve`` is deliberately *not* a
  guard: a resolved entry is refcount-pinned, which is why the unlocked
  resolve → locked release pattern in ``libra_send`` is sound.)

- **Steal path** (``STEAL001``–``STEAL002``) — everything reachable from
  a stolen quantum must be lock-protected or owner-pinned.
  ``STEAL001``: servicing a channel whose provenance is a cross-runtime
  poll harvest (the steal set) under a worker context without holding
  the cluster lock.  ``STEAL002``: a stolen reference escaping the
  locked handoff region into an attribute (``self.<x>``/``obj.<x>``) —
  local bookkeeping containers (the ``stolen`` membership filter) are
  owner-pinned to the scheduler and allowed.

All three scanners take a ``{relpath: source}`` mapping so tests can run
them over synthetic trees; :func:`run` reads the real files.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, Report, build_report
from repro_torch.analysis.lockset import (
    PLANE_FILES,
    PLANE_MUTATORS,
    REPO_ROOT,
    _attr_root,
    _functions,
    _peer_names,
)

HIERARCHY_PATH = (Path(__file__).resolve().parent
                  / "lock_hierarchy_manifest.json")

CONCURRENCY_RULES = ("DEAD001", "DEAD002", "DEAD003",
                     "ATOM001", "ATOM002", "ATOM003",
                     "STEAL001", "STEAL002")

#: the committed lock hierarchy: acquisition must follow strictly
#: increasing rank; same-class re-acquisition is reentrant and free
LOCK_RANKS = {"plane": 0, "registry": 1, "alloc": 2,
              "steering": 3, "health": 3}

#: classes whose ``self.lock`` is a leaf lock of their own class
SELF_LOCK_CLASSES = {"SteeringPolicy": "steering", "HealthTable": "health"}

#: method names that internally acquire a leaf lock when called
#: (``tick`` is deliberately absent: it collides with ``LibraStack.tick``)
LEAF_MUTATOR_CLASSES = {
    "worker_for": "steering", "forget": "steering",
    "resteer": "steering", "remove_worker": "steering",
    "note_failure": "health", "note_success": "health",
    "mark_down": "health", "mark_up": "health",
}

#: check-then-act guards: their result authorizes a mutation
GUARD_CALLS = frozenset({
    "peek", "_peek_message", "can_admit", "above_watermark",
    "find_owner", "torn_down", "healthy",
})

#: files the pass scans on the real tree
CONCURRENCY_FILES = PLANE_FILES + (
    "src/repro_torch/core/ingress.py",
    "src/repro_torch/core/policy.py",
)


# -- lock-acquisition classification ----------------------------------------

def _last_segment(expr: ast.expr) -> str:
    """Final attribute (or bare name) of a chain: ``pool.alloc`` -> alloc."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return ""


def classify_acquisition(expr: ast.expr,
                         owner_class: Optional[str]) -> Optional[str]:
    """Lock class of a ``with``-context expression, or None if it is not
    a lock acquisition at all. ``"?"`` means a lock we cannot classify."""
    # with <chain>.lock:
    if isinstance(expr, ast.Attribute) and expr.attr == "lock":
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and owner_class in SELF_LOCK_CLASSES:
            return SELF_LOCK_CLASSES[owner_class]
        # self.lock in LibraCluster / cluster.lock / self.cluster.lock —
        # anything reachable as a bare ``.lock`` on the cluster plane
        chain = ast.unparse(expr.value)
        if "cluster" in chain or chain == "self":
            return "plane"
        return "?"
    # with plane_lock(<obj>):
    if isinstance(expr, ast.Call):
        f = expr.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name != "plane_lock":
            return None
        if not expr.args:
            return "?"
        seg = _last_segment(expr.args[0])
        if "alloc" in seg:
            return "alloc"
        if "registry" in seg or seg in ("oreg", "reg"):
            return "registry"
        return "?"
    return None


def _leaf_call_class(node: ast.Call) -> Optional[str]:
    """Lock class a call acquires internally (self-locking mutators)."""
    if isinstance(node.func, ast.Attribute):
        return LEAF_MUTATOR_CLASSES.get(node.func.attr)
    return None


# -- the statement walker (lock stack + scope identity) ---------------------

class _LockWalker:
    """Walks one function's statements tracking the stack of held lock
    classes and the identity of each ``with`` scope, invoking per-node
    callbacks supplied by the individual passes."""

    def __init__(self, filename: str, qualname: str, func: ast.AST,
                 owner_class: Optional[str]):
        self.filename = filename
        self.qualname = qualname
        self.func = func
        self.owner_class = owner_class
        # (lock class, scope id) innermost-last; a *_locked function body
        # holds the plane lock with the function itself as the scope
        self.stack: List[Tuple[str, int]] = []
        if func.name.endswith("_locked"):
            self.stack.append(("plane", id(func)))

    # hooks overridden by passes
    def on_acquire(self, cls: str, node: ast.AST) -> None: ...
    def on_unclassifiable(self, node: ast.AST) -> None: ...
    def on_stmt(self, node: ast.AST) -> None: ...

    def held(self) -> List[str]:
        return [c for c, _ in self.stack]

    def scope_of(self, cls: str) -> Optional[int]:
        for c, sid in reversed(self.stack):
            if c == cls:
                return sid
        return None

    def run(self) -> None:
        if self.func.name == "__init__":
            return  # construction happens-before publication
        for stmt in self.func.body:
            self._scan(stmt)

    def _scan(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                cls = classify_acquisition(item.context_expr,
                                           self.owner_class)
                if cls is None:
                    continue
                if cls == "?":
                    self.on_unclassifiable(item.context_expr)
                    continue
                self.on_acquire(cls, node)
                self.stack.append((cls, id(node)))
                pushed += 1
            for s in node.body:
                self._scan(s)
            for _ in range(pushed):
                self.stack.pop()
            return
        self.on_stmt(node)
        # leaf acquisitions ride ordinary expressions
        for sub in self._walk_exprs(node):
            if isinstance(sub, ast.Call):
                cls = self._call_leaf(sub)
                if cls is not None:
                    self.on_acquire(cls, sub)
        for field in ("body", "orelse", "finalbody"):
            for s in getattr(node, field, []) or []:
                self._scan(s)
        for h in getattr(node, "handlers", []) or []:
            for s in h.body:
                self._scan(s)

    @staticmethod
    def _walk_exprs(node: ast.AST):
        """Expression-level descendants only — nested statements get
        their own :meth:`_scan` visit with their own lock state."""
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                continue
            yield from _LockWalker._walk_exprs(child)

    def _call_leaf(self, node: ast.Call) -> Optional[str]:
        cls = _leaf_call_class(node)
        if cls is None:
            return None
        # calls on self inside the owning class are the internal
        # delegation pattern (resteer -> worker_for), not a re-acquisition
        if self.owner_class in SELF_LOCK_CLASSES \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "self":
            return None
        return cls


def _owner_classes(tree: ast.Module) -> Dict[int, str]:
    """id(function node) -> enclosing class name."""
    out: Dict[int, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[id(sub)] = node.name
    return out


# -- pass (a): lock-order / deadlock graph ----------------------------------

class _EdgeWalker(_LockWalker):
    def __init__(self, *a, edges: List[dict], findings: List[Finding]):
        super().__init__(*a)
        self.edges = edges
        self.findings = findings

    def on_acquire(self, cls: str, node: ast.AST) -> None:
        for held in self.held():
            if held == cls:
                continue  # reentrant same-class: always fine
            self.edges.append({"src": held, "dst": cls,
                               "file": self.filename,
                               "func": self.qualname,
                               "line": node.lineno})

    def on_unclassifiable(self, node: ast.AST) -> None:
        self.findings.append(Finding(
            self.filename, node.lineno, "DEAD003",
            f"{self.qualname}: lock acquisition "
            f"'{ast.unparse(node)}' cannot be classified into the lock "
            f"hierarchy (plane/registry/alloc/steering/health) — name "
            f"the lock so its rank is derivable"))


def derive_lock_graph(sources: Dict[str, str]
                      ) -> Tuple[List[dict], List[Finding]]:
    """(acquisition edges, DEAD003 classification findings)."""
    edges: List[dict] = []
    findings: List[Finding] = []
    for rel, text in sorted(sources.items()):
        tree = ast.parse(text, filename=rel)
        owners = _owner_classes(tree)
        for qualname, func in _functions(tree):
            w = _EdgeWalker(rel, qualname, func, owners.get(id(func)),
                            edges=edges, findings=findings)
            w.run()
    return edges, findings


def check_lock_order(edges: Sequence[dict]) -> List[Finding]:
    """DEAD002 rank inversions + DEAD001 cycles over the class graph."""
    findings: List[Finding] = []
    for e in edges:
        if LOCK_RANKS[e["src"]] >= LOCK_RANKS[e["dst"]]:
            findings.append(Finding(
                e["file"], e["line"], "DEAD002",
                f"{e['func']}: acquires '{e['dst']}' "
                f"(rank {LOCK_RANKS[e['dst']]}) while holding "
                f"'{e['src']}' (rank {LOCK_RANKS[e['src']]}) — "
                f"acquisition order must follow strictly increasing rank"))
    graph: Dict[str, Set[str]] = {}
    rep: Dict[Tuple[str, str], dict] = {}
    for e in edges:
        graph.setdefault(e["src"], set()).add(e["dst"])
        rep.setdefault((e["src"], e["dst"]), e)
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                canon = tuple(sorted(cyc[:-1]))
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                e = rep[(cyc[-2], cyc[-1])]
                findings.append(Finding(
                    e["file"], e["line"], "DEAD001",
                    f"lock-order cycle {' -> '.join(cyc)}: two threads "
                    f"taking these locks in opposing orders deadlock"))
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return findings


def hierarchy_manifest(edges: Sequence[dict]) -> dict:
    """Line-number-free manifest of the derived graph."""
    dedup = sorted({(e["src"], e["dst"], e["file"], e["func"])
                    for e in edges})
    return {"version": 1,
            "ranks": dict(sorted(LOCK_RANKS.items())),
            "edges": [{"src": s, "dst": d, "file": f, "func": fn}
                      for s, d, f, fn in dedup]}


def write_hierarchy_manifest(root: Path = REPO_ROOT,
                             path: Path = HIERARCHY_PATH) -> dict:
    sources = {rel: (root / rel).read_text() for rel in CONCURRENCY_FILES}
    edges, _ = derive_lock_graph(sources)
    manifest = hierarchy_manifest(edges)
    path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return manifest


def compare_hierarchy(derived: dict,
                      committed: Optional[dict]) -> List[Finding]:
    loc = str(HIERARCHY_PATH.relative_to(REPO_ROOT))
    if committed is None:
        return [Finding(loc, 0, "DEAD003",
                        "lock-hierarchy manifest missing — generate with "
                        "`python -m repro_torch.analysis --write-manifest` and "
                        "commit it")]
    findings: List[Finding] = []
    if committed.get("ranks") != derived["ranks"]:
        findings.append(Finding(
            loc, 0, "DEAD003",
            f"lock rank table drift: committed "
            f"{committed.get('ranks')} vs derived {derived['ranks']} — "
            f"review the ordering change, then re-run --write-manifest"))
    key = lambda e: (e["src"], e["dst"], e["file"], e["func"])  # noqa: E731
    new = {key(e) for e in derived["edges"]}
    old = {key(e) for e in committed.get("edges", [])}
    for s, d, f, fn in sorted(new - old):
        findings.append(Finding(
            loc, 0, "DEAD003",
            f"new lock-order edge {s} -> {d} in {fn} ({f}) — review the "
            f"nesting, then re-run --write-manifest"))
    for s, d, f, fn in sorted(old - new):
        findings.append(Finding(
            loc, 0, "DEAD003",
            f"manifest lock-order edge {s} -> {d} in {fn} ({f}) no "
            f"longer exists — re-run --write-manifest"))
    return findings


# -- pass (b): atomicity lint -----------------------------------------------

def _guard_call_on_peer(expr: ast.AST, peers: Set[str]) -> Optional[ast.Call]:
    """A GUARD_CALLS call whose receiver is peer-rooted, if any."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr in GUARD_CALLS:
            root = _attr_root(node.func.value)
            if root in peers:
                return node
        # find_owner & co are guards regardless of receiver: their
        # *result* is the peer handle the region then mutates
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name == "find_owner":
                return node
    return None


def _peer_mutation(region: Sequence[ast.stmt],
                   peers: Set[str]) -> Optional[ast.Call]:
    for stmt in region:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr in PLANE_MUTATORS \
                    and _attr_root(node.func.value) in peers:
                return node
    return None


def _rmw_target(node: ast.AST) -> Optional[str]:
    """Dotted path of a read-modify-write on allocator/registry state."""
    if not isinstance(node, ast.AugAssign):
        return None
    t = node.target
    if not isinstance(t, (ast.Attribute, ast.Subscript)):
        return None
    parts: List[str] = []
    cur: ast.AST = t
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        if isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
        cur = cur.value
    if any(p in ("alloc", "registry") for p in parts):
        return ast.unparse(t)
    return None


class _AtomWalker(_LockWalker):
    def __init__(self, *a, findings: List[Finding]):
        super().__init__(*a)
        self.findings = findings
        self.peers = _peer_names(self.func)
        # guard-result names: name -> (lock class, scope id) at production
        self.guard_scopes: Dict[str, Dict[str, Optional[int]]] = {}

    def on_stmt(self, node: ast.AST) -> None:
        held = self.held()
        # ATOM001: check-then-act across peer state
        if isinstance(node, (ast.If, ast.While)):
            g = _guard_call_on_peer(node.test, self.peers)
            if g is not None:
                m = _peer_mutation(list(node.body) + list(node.orelse),
                                   self.peers)
                if m is not None and not held:
                    self.findings.append(Finding(
                        self.filename, node.lineno, "ATOM001",
                        f"{self.qualname}: '{ast.unparse(g.func)}()' "
                        f"guards a peer-state mutation at line {m.lineno} "
                        f"but the region runs outside any lock — the "
                        f"check and the act must share one lock scope"))
        # ATOM002: unlocked RMW on allocator/registry state
        path = _rmw_target(node)
        if path is not None and not held:
            root = _attr_root(node.target)
            if root in self.peers or root == "self" or root in (
                    "pool", "alloc", "registry"):
                self.findings.append(Finding(
                    self.filename, node.lineno, "ATOM002",
                    f"{self.qualname}: read-modify-write of '{path}' "
                    f"outside any lock scope — a concurrent writer makes "
                    f"this a lost update"))
        # ATOM003: guard results crossing disjoint same-class scopes
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            g = self._any_guard_call(node.value)
            if g is not None and self.stack:
                cls, sid = self.stack[-1]
                self.guard_scopes[node.targets[0].id] = {
                    "cls": cls, "sid": sid, "line": node.lineno,
                    "call": ast.unparse(g.func)}
        for sub in self._walk_exprs(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in self.guard_scopes:
                info = self.guard_scopes[sub.id]
                cur = self.scope_of(info["cls"])
                if cur is not None and cur != info["sid"]:
                    self.findings.append(Finding(
                        self.filename, sub.lineno, "ATOM003",
                        f"{self.qualname}: '{sub.id}' (from "
                        f"{info['call']}() at line {info['line']}) is "
                        f"consumed in a different '{info['cls']}' lock "
                        f"scope than produced — the release/re-acquire "
                        f"fragmented the atomic region"))
                    del self.guard_scopes[sub.id]
                    break

    @staticmethod
    def _any_guard_call(expr: ast.AST) -> Optional[ast.Call]:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) \
                    and node.func.attr in GUARD_CALLS:
                return node
        return None


def scan_atomicity(sources: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    for rel, text in sorted(sources.items()):
        tree = ast.parse(text, filename=rel)
        owners = _owner_classes(tree)
        for qualname, func in _functions(tree):
            _AtomWalker(rel, qualname, func, owners.get(id(func)),
                        findings=findings).run()
    return findings


# -- pass (c): steal-path ownership -----------------------------------------

def _steal_names(func: ast.AST) -> Set[str]:
    """Names whose provenance is a cross-runtime poll harvest (the steal
    candidate set): seeded by expressions containing a ``.poll()`` call,
    propagated through assignments, comprehensions and for-targets."""
    tainted: Set[str] = set()

    def has_taint(expr: ast.AST) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "poll":
                return True
            if isinstance(node, ast.Name) and node.id in tainted:
                return True
        return False

    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            new: List[str] = []
            # only names being BOUND are tainted — the root of an
            # attribute target (`self` in `self.x = take`) is a read
            if isinstance(node, ast.Assign) and has_taint(node.value):
                for t in node.targets:
                    new.extend(n.id for n in ast.walk(t)
                               if isinstance(n, ast.Name)
                               and isinstance(n.ctx, ast.Store))
            elif isinstance(node, ast.For) and has_taint(node.iter):
                new.extend(n.id for n in ast.walk(node.target)
                           if isinstance(n, ast.Name)
                           and isinstance(n.ctx, ast.Store))
            for n in new:
                if n not in tainted:
                    tainted.add(n)
                    changed = True
    return tainted


class _StealWalker(_LockWalker):
    def __init__(self, *a, findings: List[Finding]):
        super().__init__(*a)
        self.findings = findings
        self.tainted = _steal_names(self.func)
        self.worker_depth = 0

    def _scan(self, node: ast.AST) -> None:
        # as_worker() scopes mark a worker-context quantum
        entered = False
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                src = ast.unparse(item.context_expr)
                if "as_worker(" in src:
                    entered = True
        if entered:
            self.worker_depth += 1
        super()._scan(node)
        if entered:
            self.worker_depth -= 1

    def on_stmt(self, node: ast.AST) -> None:
        held = self.held()
        for sub in self._walk_exprs(node):
            # STEAL001: executing a stolen quantum without the lock
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) and sub.func.attr == "service" \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in self.tainted:
                if self.worker_depth and "plane" not in held:
                    self.findings.append(Finding(
                        self.filename, sub.lineno, "STEAL001",
                        f"{self.qualname}: stolen quantum "
                        f"'{ast.unparse(sub.func)}()' executes in a "
                        f"worker context without the cluster lock — the "
                        f"donor's pool/registry are reachable unlocked"))
            # STEAL002: stolen reference escaping into an attribute
            if isinstance(sub, ast.Assign):
                if any(isinstance(t, (ast.Attribute, ast.Subscript))
                       and isinstance(_attr_root(t), str)
                       and _attr_root(t) not in self.tainted
                       for t in sub.targets) \
                        and self._names(sub.value) & self.tainted \
                        and any(isinstance(t, ast.Attribute)
                                or (isinstance(t, ast.Subscript)
                                    and isinstance(t.value, ast.Attribute))
                                for t in sub.targets):
                    self.findings.append(Finding(
                        self.filename, sub.lineno, "STEAL002",
                        f"{self.qualname}: stolen reference "
                        f"'{ast.unparse(sub.value)}' escapes the handoff "
                        f"into '{ast.unparse(sub.targets[0])}' — it "
                        f"outlives the lock scope that pinned it"))
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute) \
                    and sub.func.attr in ("append", "add", "setdefault") \
                    and isinstance(sub.func.value, ast.Attribute) \
                    and self._call_args_tainted(sub):
                self.findings.append(Finding(
                    self.filename, sub.lineno, "STEAL002",
                    f"{self.qualname}: stolen reference stored into "
                    f"'{ast.unparse(sub.func.value)}' — it outlives the "
                    f"lock scope that pinned it"))

    @staticmethod
    def _names(expr: ast.AST) -> Set[str]:
        return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}

    def _call_args_tainted(self, call: ast.Call) -> bool:
        return any(self._names(a) & self.tainted for a in call.args)


def scan_steal(sources: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    for rel, text in sorted(sources.items()):
        tree = ast.parse(text, filename=rel)
        owners = _owner_classes(tree)
        for qualname, func in _functions(tree):
            _StealWalker(rel, qualname, func, owners.get(id(func)),
                         findings=findings).run()
    return findings


# -- entry point ------------------------------------------------------------

def run(root: Path = REPO_ROOT) -> Report:
    sources = {rel: (root / rel).read_text() for rel in CONCURRENCY_FILES}
    edges, findings = derive_lock_graph(sources)
    findings.extend(check_lock_order(edges))
    committed = None
    if HIERARCHY_PATH.exists():
        committed = json.loads(HIERARCHY_PATH.read_text())
    findings.extend(compare_hierarchy(hierarchy_manifest(edges), committed))
    findings.extend(scan_atomicity(sources))
    findings.extend(scan_steal(sources))
    return build_report("concurrency", findings, sources,
                        rules=CONCURRENCY_RULES)
