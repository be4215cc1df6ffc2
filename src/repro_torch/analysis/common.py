"""Shared finding/waiver plumbing for the analysis passes.

Every pass emits :class:`Finding` records carrying ``file:line``, the rule
name (the invariant that failed), and a message.  A source line may waive a
rule with an explanatory comment::

    pages = risky_thing()  # libra: waive[OWN001] freed by caller via handoff X

The waiver may sit on the flagged line or on the line directly above it.
A waiver without a reason is itself a finding (``WAIVER001``) — the gate
runs at zero *unexplained* findings, not zero findings.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

WAIVER_RE = re.compile(r"#\s*libra:\s*waive\[([A-Z0-9_]+)\]\s*(.*)")


@dataclass
class Finding:
    """One rule violation at a source location."""
    file: str
    line: int
    rule: str
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def format(self) -> str:
        tag = " (waived: %s)" % self.waiver_reason if self.waived else ""
        return f"{self.file}:{self.line} [{self.rule}] {self.message}{tag}"


@dataclass
class Report:
    """Findings from one pass, split by waiver status."""
    name: str
    active: List[Finding] = field(default_factory=list)
    waived: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.active

    def summary(self) -> str:
        return (f"{self.name}: {len(self.active)} finding(s), "
                f"{len(self.waived)} waived")

    def lines(self) -> List[str]:
        out = [self.summary()]
        out += ["  " + f.format() for f in self.active]
        out += ["  " + f.format() for f in self.waived]
        return out


def scan_waivers(source: str) -> Dict[int, Tuple[str, str]]:
    """Map line number -> (rule, reason) for every waiver comment."""
    out: Dict[int, Tuple[str, str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = WAIVER_RE.search(text)
        if m:
            out[i] = (m.group(1), m.group(2).strip())
    return out


def apply_waivers(
    findings: Iterable[Finding],
    waivers_by_file: Dict[str, Dict[int, Tuple[str, str]]],
    rules: Iterable[str] | None = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (active, waived).

    A finding is waived when a matching-rule waiver comment sits on the
    flagged line or the line directly above.  Reasonless waivers surface as
    ``WAIVER001`` findings; waivers that match nothing surface as
    ``WAIVER002`` (stale) so dead waivers cannot mask future regressions.
    ``rules`` restricts the stale-waiver sweep to the rule family a pass
    owns, so passes sharing a file do not flag each other's waivers.
    """
    rule_set = set(rules) if rules is not None else None
    active: List[Finding] = []
    waived: List[Finding] = []
    used: Dict[Tuple[str, int], bool] = {}
    for f in findings:
        file_waivers = waivers_by_file.get(f.file, {})
        hit = None
        for ln in (f.line, f.line - 1):
            w = file_waivers.get(ln)
            if w and w[0] == f.rule:
                hit = (ln, w[1])
                break
        if hit is None:
            active.append(f)
            continue
        ln, reason = hit
        used[(f.file, ln)] = True
        if not reason:
            active.append(Finding(f.file, ln, "WAIVER001",
                                  f"waiver for {f.rule} has no reason"))
        f.waived = True
        f.waiver_reason = reason or "<missing>"
        waived.append(f)
    for file, file_waivers in waivers_by_file.items():
        for ln, (rule, _reason) in file_waivers.items():
            if rule_set is not None and rule not in rule_set:
                continue
            if not used.get((file, ln)):
                active.append(Finding(
                    file, ln, "WAIVER002",
                    f"stale waiver: no {rule} finding at this line"))
    return active, waived


def build_report(name: str, findings: Sequence[Finding],
                 sources: Dict[str, str],
                 rules: Iterable[str] | None = None) -> Report:
    """Apply per-file waivers from ``sources`` (file -> text) and package."""
    waivers = {file: scan_waivers(text) for file, text in sources.items()}
    active, waived = apply_waivers(list(findings), waivers, rules=rules)
    return Report(name=name, active=active, waived=waived)
