"""Finding type + inline suppression / annotation comment parsing.

A :class:`Finding` is one rule violation pinned to a file and line; the
engine sorts, deduplicates, suppresses, and reports them
(docs/ANALYSIS.md).  Two comment micro-syntaxes live here because every
rule and the engine share them:

* ``# lint: allow RA004 -- <reason>`` suppresses the named rule(s) on its
  line (or, as a standalone comment, on the line below).  The reason is
  REQUIRED: a reasonless suppression is itself reported (rule ``RA000``),
  so an annotation always records *why* the violation is intended.
* ``# guarded-by: _lock`` registers the attribute assigned on that line as
  lock-guarded shared state for the RA001 lock-discipline rule.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

SEVERITIES = ("error", "warning")

# the engine's own rule id: malformed suppressions, unreadable/unparseable
# files — meta-findings about the analysis input itself
ENGINE_RULE = "RA000"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*allow\s+(?P<rules>RA\d{3}(?:\s*,\s*RA\d{3})*)"
    r"(?:\s*--\s*(?P<reason>\S.*))?")
_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>\w+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, which rule, how bad, and what."""

    path: str  # root-relative posix path
    line: int
    rule: str  # "RA001".."RA005" (or RA000 for engine meta-findings)
    severity: str  # "error" | "warning"
    message: str

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule, self.message)

    def baseline_key(self) -> tuple:
        """Identity used by ``--baseline`` matching: line numbers drift as
        files are edited, so a baselined finding is keyed on content."""
        return (self.path, self.rule, self.message)

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "severity": self.severity, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.severity}: {self.message}"


def parse_suppressions(lines: list[str]) -> tuple[dict[int, set[str]], list[tuple[int, str]]]:
    """Scan source lines for ``# lint: allow`` comments.

    Returns ``(allow, malformed)``: ``allow`` maps 1-based line numbers to
    the rule ids suppressed there; ``malformed`` lists ``(line, rules)``
    pairs whose annotation is missing the required ``-- reason`` string.
    """
    allow: dict[int, set[str]] = {}
    malformed: list[tuple[int, str]] = []
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = {r.strip() for r in m.group("rules").split(",")}
        if not m.group("reason"):
            malformed.append((i, ", ".join(sorted(rules))))
            continue
        allow.setdefault(i, set()).update(rules)
    return allow, malformed


def guard_annotation(line_text: str) -> str | None:
    """The lock name a ``# guarded-by: <name>`` comment declares, or None."""
    m = _GUARD_RE.search(line_text)
    return m.group("lock") if m else None
