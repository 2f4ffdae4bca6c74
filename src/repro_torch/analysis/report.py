"""Reporters: human-readable text and machine-readable JSON.

The JSON shape is the reference's report contract: top-level run
metadata plus one object per finding with
``path``/``line``/``rule``/``severity``/``message``.  The text reporter is
one grep-able line per finding plus a summary tail.
"""
from __future__ import annotations

import json

from repro_torch.analysis.findings import Finding


def render_json(findings: list[Finding], *, root: str, files: int,
                rules: list[str], suppressible: bool = True) -> str:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    doc = {
        "tool": "repro_torch.analysis",
        "root": root,
        "files": files,
        "rules": rules,
        "clean": not findings,
        "counts": counts,
        "findings": [f.to_json() for f in findings],
    }
    return json.dumps(doc, indent=1, sort_keys=False)


def render_text(findings: list[Finding], *, root: str, files: int,
                rules: list[str]) -> str:
    lines = [f.render() for f in findings]
    if findings:
        by_rule: dict[str, int] = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        tally = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items()))
        lines.append(f"{len(findings)} finding"
                     f"{'' if len(findings) == 1 else 's'} ({tally}) "
                     f"in {files} files under {root}")
    else:
        lines.append(f"clean: 0 findings in {files} files under {root} "
                     f"(rules {', '.join(rules)})")
    return "\n".join(lines)


def load_baseline(text: str) -> set[tuple]:
    """Parse a baseline document (the JSON reporter's output, or a bare
    findings list) into the set of accepted finding keys."""
    doc = json.loads(text)
    items = doc["findings"] if isinstance(doc, dict) else doc
    return {(f["path"], f["rule"], f["message"]) for f in items}


def apply_baseline(findings: list[Finding], accepted: set[tuple]) -> list[Finding]:
    """Drop findings whose (path, rule, message) identity is baselined."""
    return [f for f in findings if f.baseline_key() not in accepted]
