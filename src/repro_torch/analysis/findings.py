"""Finding/baseline/waiver plumbing shared by every rule of the port's
contract checker (port of ``repro/analysis/findings.py``; pure Python).

A *finding* is one violation of one rule, pinned to a location: a real
``file:line`` for AST rules, a pseudo-path like
``<case:linear-mixed/spec_step>`` for runtime rules (which watch a real
step run, not source text).

Two suppression channels, with different lifetimes:

  - **inline waiver** — ``# repro-lint: allow(<rule>[,<rule>]): reason`` on
    the offending line (or the line directly above it).  For findings that
    are *accepted forever* at that exact site (e.g. the retirement path's
    necessary device->host readback).  Waived findings stay in the
    inventory (``--syncmap`` needs the full sync map, waived included) but
    never fail the build.
  - **baseline** — ``analysis/baseline.json``.  For *pre-existing* findings
    accepted at adoption time so CI can gate on NEW findings immediately.
    Entries match on (rule, file, context) — context is the stripped source
    line (AST) or a stable key (runtime), so findings survive line drift.
    The baseline is a ratchet: shrink it, never grow it.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

_WAIVER_RE = re.compile(
    r"#\s*repro-lint:\s*allow\(\s*(?P<rules>[\w, -]+?)\s*\)"
    r"(?::\s*(?P<reason>.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule id, e.g. "in-place" or "kernel-scope"
    file: str            # repo-relative path, or "<case:...>" pseudo-path
    line: int            # 1-based; 0 = whole entity (runtime)
    message: str         # what is wrong, concretely
    hint: str = ""       # how to fix it
    context: str = ""    # stable matching key (stripped source line / aval)
    waived: bool = False
    waive_reason: str = ""

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.context)

    def format(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        tag = " [waived]" if self.waived else ""
        s = f"{loc}: [{self.rule}]{tag} {self.message}"
        if self.hint:
            s += f"\n    fix: {self.hint}"
        return s

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def scan_waivers(source: str) -> Dict[int, Tuple[Set[str], str]]:
    """{line (1-based) -> (waived rule ids, reason)} for one source file.

    A waiver comment applies to its own line and, when the line holds only
    the comment, to the line below — so multi-line statements can carry the
    waiver above them.
    """
    out: Dict[int, Tuple[Set[str], str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _WAIVER_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        reason = (m.group("reason") or "").strip()
        out[i] = (rules, reason)
        if text.lstrip().startswith("#"):       # comment-only line: applies
            out[i + 1] = (rules, reason)        # to the statement below
    return out


def apply_waivers(findings: Sequence[Finding],
                  waivers: Dict[int, Tuple[Set[str], str]]) -> List[Finding]:
    out = []
    for f in findings:
        w = waivers.get(f.line)
        if w and f.rule in w[0]:
            f = dataclasses.replace(f, waived=True, waive_reason=w[1])
        out.append(f)
    return out


class Baseline:
    """Accepted pre-existing findings (see module docstring)."""

    def __init__(self, entries: Optional[List[Dict]] = None):
        self.entries = entries or []
        self._keys = {(e["rule"], e["file"], e.get("context", ""))
                      for e in self.entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls([])
        return cls(data.get("entries", []))

    def covers(self, finding: Finding) -> bool:
        return finding.key in self._keys

    def split(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding]]:
        """(new, accepted) — waived findings count as accepted."""
        new, accepted = [], []
        for f in findings:
            (accepted if (f.waived or self.covers(f)) else new).append(f)
        return new, accepted
