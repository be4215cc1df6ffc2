"""Pass 1 — page/grant ownership lint (AST dataflow over ``core/*.py``).

Models the anchor-pool / grant lifecycle as acquire → {release | handoff}
and flags any path where an exception or an early exit can escape between
the two without try/finally protection or an explicit ownership transfer —
the bug class behind PR 5's abandoned-grant leak and PR 7's EAGAIN
page-hold.

Lifecycle model (intra-procedural, optimistic):

- **acquire**: ``alloc_page`` / ``alloc_sequence`` / ``alloc_batch`` /
  ``stage_transfer`` bind a *page* resource; ``export_grant`` binds a *pin*.
- **release**: ``free_pages_list`` / ``free_batch`` / ``release_export`` /
  ``defer_free`` / ``commit_transfer`` / ``abort_transfer``.
- **handoff**: ``register`` / ``import_grant`` / ``grant_into`` transfer
  ownership to a registry (``import_grant`` also consumes any live pin —
  the grant entry assumes the pin); storing into an attribute/subscript,
  appending into a collection, wrapping in a CamelCase constructor,
  returning or yielding all move ownership out of the local frame.
- **escape**: ``raise`` / ``assert`` / a call documented to raise
  (:data:`MAY_RAISE`) / ``return`` / ``break`` / ``continue``.
- **protection**: an enclosing ``try`` whose ``finally`` releases (covers
  every escape) or whose handlers each either release or swallow the
  exception (covers raising escapes only — handlers do not run on
  ``return``).

Rules:

- ``OWN001`` — a live resource can leak if a call/raise/assert escapes.
- ``OWN002`` — an acquire's result is discarded (unbound page resource).
- ``OWN003`` — early ``return``/``break``/``continue`` while holding.
- ``OWN004`` — a live resource name is rebound without a release.

The pass is deliberately optimistic (any plausible disposal counts) so that
every finding is worth a human look; residual false positives carry
``# libra: waive[OWNxxx] reason`` comments at the flagged line.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, Report, build_report

REPO_ROOT = Path(__file__).resolve().parents[3]

# method name -> resource kind it acquires
ACQUIRES = {
    "alloc_page": "page",
    "alloc_sequence": "pages",
    "alloc_batch": "page-batch",
    "stage_transfer": "staged-pages",
    "export_grant": "pin",
}
RELEASES = frozenset({
    "free_pages_list", "free_batch", "release_export", "defer_free",
    "commit_transfer", "abort_transfer",
})
HANDOFFS = frozenset({"register", "import_grant", "grant_into"})
# collection mutators that move their argument into the receiver
MOVES_INTO_RECEIVER = frozenset({"append", "extend", "add", "insert"})
# datapath calls documented (or observed) to raise mid-path: pool writes can
# hit bad coords, device anchoring raises DeviceRangeError, the record layer
# raises RecordAuthError, grant import can fault on a dead owner.
MAY_RAISE = frozenset(ACQUIRES) | frozenset({
    "import_grant", "grant_into",
    "write_payload", "write_payload_batch",
    "read_payload", "read_payload_batch",
    "anchor_batch_device", "gather_batch_device",
    "keystream_batch", "verify_record", "sw_decrypt_payload",
    "rx_payload_keystream", "rx_open_span", "seal_record",
})

OWNERSHIP_RULES = ("OWN001", "OWN002", "OWN003", "OWN004",
                   "WAIVER001", "WAIVER002")


@dataclass
class _Res:
    name: str
    kind: str
    line: int
    parent: Optional[str] = None
    reported: bool = False
    accum: bool = False  # receiver collection (append target)


@dataclass
class _TryFrame:
    protects_raise: bool
    protects_all: bool


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _names_in(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _contains_release(stmts: Sequence[ast.stmt]) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call) and _call_name(n) in RELEASES:
                return True
    return False


def _contains_raise(stmts: Sequence[ast.stmt]) -> bool:
    return any(isinstance(n, ast.Raise)
               for s in stmts for n in ast.walk(s))


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    """True when the block cannot fall through to the statement after it."""
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))


def _is_constructor(name: str) -> bool:
    return bool(name) and name.lstrip("_")[:1].isupper()


class _FuncScanner:
    """Scans one function body; collects findings."""

    def __init__(self, filename: str, func: ast.AST):
        self.filename = filename
        self.func = func
        self.live: Dict[str, _Res] = {}
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        self._scan_block(self.func.body, prot=[], loop_start=None)
        return self.findings

    # -- block / statement dispatch ---------------------------------------

    def _scan_block(self, stmts: Sequence[ast.stmt],
                    prot: List[_TryFrame],
                    loop_start: Optional[int]) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt, prot, loop_start)

    def _scan_stmt(self, stmt: ast.stmt, prot: List[_TryFrame],
                   loop_start: Optional[int]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.findings.extend(
                _FuncScanner(self.filename, stmt).run())
            return
        if isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.findings.extend(
                        _FuncScanner(self.filename, sub).run())
            return
        if isinstance(stmt, ast.If):
            self._risk_only(stmt.test, prot, loop_start)
            self._scan_branches(stmt.body, stmt.orelse, prot, loop_start,
                                test=stmt.test)
            return
        if isinstance(stmt, ast.While):
            self._risk_only(stmt.test, prot, loop_start)
            self._scan_branches(stmt.body, stmt.orelse, prot, stmt.lineno)
            return
        if isinstance(stmt, ast.For):
            self._scan_for(stmt, prot, loop_start)
            return
        if isinstance(stmt, ast.Try):
            self._scan_try(stmt, prot, loop_start)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._risk_only(item.context_expr, prot, loop_start)
            self._scan_block(stmt.body, prot, loop_start)
            return
        self._scan_simple(stmt, prot, loop_start)

    # -- simple statements -------------------------------------------------

    def _scan_simple(self, stmt: ast.stmt, prot: List[_TryFrame],
                     loop_start: Optional[int]) -> None:
        calls = [n for n in ast.walk(stmt) if isinstance(n, ast.Call)]
        disposed = self._disposed_by(stmt, calls)
        self._check_risks(stmt, calls, disposed, prot, loop_start)
        for name in disposed:
            self._dispose(name)
        self._acquire_from(stmt, calls)

    def _risk_only(self, expr: ast.expr, prot: List[_TryFrame],
                   loop_start: Optional[int]) -> None:
        calls = [n for n in ast.walk(expr) if isinstance(n, ast.Call)]
        for c in calls:
            if _call_name(c) in MAY_RAISE:
                self._flag_raise(c.lineno, f"{_call_name(c)}() may raise",
                                 set(), prot)

    def _disposed_by(self, stmt: ast.stmt,
                     calls: List[ast.Call]) -> Set[str]:
        disposed: Set[str] = set()
        live = self.live
        for c in calls:
            name = _call_name(c)
            argnames = set()
            for a in list(c.args) + [kw.value for kw in c.keywords]:
                argnames |= _names_in(a)
            if name in RELEASES or name in HANDOFFS:
                disposed |= live.keys() & argnames
                if name == "import_grant":
                    # the grant entry assumes responsibility for the pin
                    disposed |= {n for n, r in live.items()
                                 if r.kind == "pin"}
                elif name == "release_export":
                    # a bare export_grant() pin has no binding name — the
                    # only way to release it IS reconstructed PageRefs, so
                    # any release_export on the path disposes it
                    disposed |= {n for n, r in live.items()
                                 if r.kind == "pin" and n.startswith("<pin@")}
            elif name in MOVES_INTO_RECEIVER and isinstance(
                    c.func, ast.Attribute):
                moved = live.keys() & argnames
                acquired_arg = any(
                    isinstance(a, ast.Call) and _call_name(a) in ACQUIRES
                    for a in c.args)
                if moved or acquired_arg:
                    disposed |= moved
                    recv = c.func.value
                    if isinstance(recv, ast.Name):
                        kind = (live[next(iter(moved))].kind if moved
                                else "pages")
                        self.live.setdefault(
                            recv.id,
                            _Res(recv.id, kind, c.lineno, accum=True))
            elif _is_constructor(name):
                disposed |= live.keys() & argnames
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    # storing a resource into an object moves ownership —
                    # but writing to a field OF the resource itself (or
                    # merely reading it to index the store) does not
                    disposed |= (live.keys() & _names_in(stmt.value)) \
                        - _names_in(t)
        if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
                getattr(stmt, "value", None),
                (ast.Name, ast.Tuple, ast.List, ast.Yield, ast.IfExp)):
            disposed |= live.keys() & _names_in(stmt.value)
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            disposed |= live.keys() & _names_in(stmt.value)
        return disposed

    def _check_risks(self, stmt: ast.stmt, calls: List[ast.Call],
                     disposed: Set[str], prot: List[_TryFrame],
                     loop_start: Optional[int]) -> None:
        if isinstance(stmt, (ast.Raise, ast.Assert)):
            kind = "raise" if isinstance(stmt, ast.Raise) else "assert"
            self._flag_raise(stmt.lineno, f"{kind} escapes", disposed, prot)
            return
        for c in calls:
            name = _call_name(c)
            if name in MAY_RAISE:
                self._flag_raise(c.lineno, f"{name}() may raise",
                                 disposed, prot)
        if isinstance(stmt, ast.Return):
            self._flag_exit(stmt.lineno, "early return while holding",
                            disposed, prot, only_after=None)
        elif isinstance(stmt, (ast.Break, ast.Continue)) and loop_start:
            word = ("break" if isinstance(stmt, ast.Break) else "continue")
            self._flag_exit(stmt.lineno, f"{word} while holding",
                            disposed, prot, only_after=loop_start)

    def _flag_raise(self, line: int, desc: str, disposed: Set[str],
                    prot: List[_TryFrame]) -> None:
        if any(f.protects_all or f.protects_raise for f in prot):
            return
        self._emit("OWN001", line, desc, disposed, skip_children=True)

    def _flag_exit(self, line: int, desc: str, disposed: Set[str],
                   prot: List[_TryFrame],
                   only_after: Optional[int]) -> None:
        if any(f.protects_all for f in prot):
            return
        self._emit("OWN003", line, desc, disposed, skip_children=True,
                   only_after=only_after)

    def _emit(self, rule: str, line: int, desc: str, disposed: Set[str],
              skip_children: bool, only_after: Optional[int] = None) -> None:
        for name, res in list(self.live.items()):
            if name in disposed or res.reported:
                continue
            if skip_children and res.parent is not None:
                continue
            if only_after is not None and (res.line <= only_after
                                           or res.accum):
                # break/continue only leak resources born this iteration;
                # appending into an accumulator then continuing is the
                # normal accumulate pattern (freed after the loop)
                continue
            res.reported = True
            self.findings.append(Finding(
                self.filename, line, rule,
                f"'{name}' ({res.kind} acquired at line {res.line}) "
                f"may leak: {desc}"))

    def _dispose(self, name: str) -> None:
        res = self.live.pop(name, None)
        if res is not None and res.parent is not None:
            # a consumed element optimistically disposes its collection
            self._dispose(res.parent)

    def _acquire_from(self, stmt: ast.stmt,
                      calls: List[ast.Call]) -> None:
        acq = [c for c in calls if _call_name(c) in ACQUIRES]
        if not acq:
            self._alias_comprehension(stmt)
            return
        c = acq[0]
        kind = ACQUIRES[_call_name(c)]
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            if len(targets) == 1 and isinstance(targets[0], ast.Name):
                name = targets[0].id
                prev = self.live.get(name)
                if prev is not None and not prev.reported and \
                        name not in _names_in(stmt.value):
                    self.findings.append(Finding(
                        self.filename, stmt.lineno, "OWN004",
                        f"'{name}' ({prev.kind} acquired at line "
                        f"{prev.line}) rebound without release"))
                self.live[name] = _Res(name, kind, stmt.lineno)
            elif len(targets) == 1 and isinstance(targets[0], ast.Tuple):
                for elt in targets[0].elts:
                    if isinstance(elt, ast.Name):
                        self.live[elt.id] = _Res(elt.id, kind, stmt.lineno)
            # attribute/subscript target: stored into an object that now
            # owns it — out of local scope, nothing to track
        elif isinstance(stmt, ast.Expr) and stmt.value is c:
            # bare acquire, result discarded: pins are legal (released via
            # reconstructed refs), page acquires are an immediate leak
            if kind == "pin":
                name = f"<pin@{c.lineno}>"
                self.live[name] = _Res(name, "pin", c.lineno)
            else:
                self.findings.append(Finding(
                    self.filename, c.lineno, "OWN002",
                    f"{_call_name(c)}() result discarded — "
                    f"{kind} leaks immediately"))
        # acquire nested inside append/constructor/other call: moved into
        # the receiver by _disposed_by, or consumed by the callee (handoff)

    def _alias_comprehension(self, stmt: ast.stmt) -> None:
        """``view = {.. for x in owned ..}`` binds a child view of the
        owned collection: releasing through the view releases the whole."""
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            return
        value = stmt.value
        if not isinstance(value, (ast.ListComp, ast.SetComp, ast.DictComp,
                                  ast.GeneratorExp)):
            return
        name = stmt.targets[0].id
        for gen in value.generators:
            hits = (self.live.keys() & _names_in(gen.iter)) - {name}
            if hits:
                parent = next(iter(hits))
                self.live[name] = _Res(name, self.live[parent].kind,
                                       stmt.lineno, parent=parent)
                return

    # -- control flow ------------------------------------------------------

    def _scan_branches(self, body: Sequence[ast.stmt],
                       orelse: Sequence[ast.stmt],
                       prot: List[_TryFrame],
                       loop_start: Optional[int],
                       test: Optional[ast.expr] = None) -> None:
        # emptiness guard: inside `if not xs:` the collection xs is empty —
        # it cannot leak there; inside `if xs:` it is empty in the orelse
        empty_in_body = empty_in_else = None
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
                and isinstance(test.operand, ast.Name):
            empty_in_body = test.operand.id
        elif isinstance(test, ast.Name):
            empty_in_else = test.id
        entry = dict(self.live)
        if empty_in_body in self.live:
            del self.live[empty_in_body]
        self._scan_block(body, prot, loop_start)
        body_live, body_exits = self.live, _terminates(body)
        if empty_in_body is not None and empty_in_body in entry:
            body_live[empty_in_body] = entry[empty_in_body]
        self.live = dict(entry)
        if empty_in_else in self.live:
            del self.live[empty_in_else]
        self._scan_block(orelse, prot, loop_start)
        else_live, else_exits = self.live, bool(orelse) and _terminates(orelse)
        if empty_in_else is not None and empty_in_else in entry:
            else_live[empty_in_else] = entry[empty_in_else]
        # a branch that cannot fall through does not join (its escapes were
        # already checked by the exit rules)
        if body_exits and not else_exits:
            self.live = dict(else_live)
            return
        if else_exits and not body_exits:
            self.live = dict(body_live)
            return
        merged: Dict[str, _Res] = {}
        for name, res in {**body_live, **else_live}.items():
            if name in entry:
                if name in body_live and name in else_live:
                    merged[name] = res
            else:
                merged[name] = res
        self.live = merged

    def _scan_for(self, stmt: ast.For, prot: List[_TryFrame],
                  loop_start: Optional[int]) -> None:
        self._risk_only(stmt.iter, prot, loop_start)
        children = self._bind_loop_targets(stmt)
        self._scan_block(stmt.body, prot, stmt.lineno)
        for child in children:
            if child in self.live:
                # element never consumed this iteration: scope ends, the
                # collection keeps ownership
                del self.live[child]
        self._scan_block(stmt.orelse, prot, loop_start)

    def _bind_loop_targets(self, stmt: ast.For) -> List[str]:
        """Bind loop targets iterating a live collection as child
        resources (positional for zip/enumerate)."""
        children: List[str] = []

        def bind(target: ast.expr, parent: str, kind: str) -> None:
            for n in ast.walk(target):
                if isinstance(n, ast.Name):
                    self.live[n.id] = _Res(n.id, kind, stmt.lineno,
                                           parent=parent)
                    children.append(n.id)

        it = stmt.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "zip" \
                and isinstance(stmt.target, ast.Tuple) \
                and len(stmt.target.elts) == len(it.args):
            for arg, tgt in zip(it.args, stmt.target.elts):
                hits = self.live.keys() & _names_in(arg)
                if hits:
                    parent = next(iter(hits))
                    bind(tgt, parent, self.live[parent].kind)
            return children
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "enumerate" and it.args:
            hits = self.live.keys() & _names_in(it.args[0])
            if hits and isinstance(stmt.target, ast.Tuple) \
                    and len(stmt.target.elts) == 2:
                parent = next(iter(hits))
                bind(stmt.target.elts[1], parent,
                     self.live[parent].kind)
            return children
        hits = self.live.keys() & _names_in(it)
        if hits:
            parent = next(iter(hits))
            bind(stmt.target, parent, self.live[parent].kind)
        return children

    def _scan_try(self, stmt: ast.Try, prot: List[_TryFrame],
                  loop_start: Optional[int]) -> None:
        handlers_ok = bool(stmt.handlers) and all(
            _contains_release(h.body) or not _contains_raise(h.body)
            for h in stmt.handlers)
        frame = _TryFrame(
            protects_raise=handlers_ok or _contains_release(stmt.finalbody),
            protects_all=_contains_release(stmt.finalbody),
        )
        entry = dict(self.live)
        self._scan_block(stmt.body, prot + [frame], loop_start)
        self._scan_block(stmt.orelse, prot + [frame], loop_start)
        after_body = self.live
        for h in stmt.handlers:
            # a handler may run before any acquire in the body completed;
            # optimistically scan it with entry-state liveness
            self.live = dict(entry)
            self._scan_block(h.body, prot, loop_start)
        self.live = after_body
        self._scan_block(stmt.finalbody, prot, loop_start)


def lint_source(source: str, filename: str) -> List[Finding]:
    """Run the ownership lint over one module's source text."""
    tree = ast.parse(source, filename=filename)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_FuncScanner(filename, node).run())
    # ast.walk visits nested functions too — _FuncScanner already recurses,
    # so de-duplicate by (line, rule, message)
    seen: Set[Tuple[int, str, str]] = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.file, f.line, f.rule)):
        key = (f.line, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def default_targets(root: Path = REPO_ROOT) -> List[Path]:
    return sorted((root / "src" / "repro_torch" / "core").glob("*.py"))


def run(root: Path = REPO_ROOT,
        paths: Optional[Sequence[Path]] = None) -> Report:
    """Lint ``core/*.py`` (or ``paths``) and apply waivers."""
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    for path in (paths if paths is not None else default_targets(root)):
        rel = str(Path(path).resolve().relative_to(root))
        text = Path(path).read_text()
        sources[rel] = text
        findings.extend(lint_source(text, rel))
    return build_report("ownership", findings, sources,
                        rules=OWNERSHIP_RULES)
