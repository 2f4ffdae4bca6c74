"""Checker engine: one ``ast.parse`` + one walk per file, shared by all rules.

Each source file under the analysis root is read and parsed exactly once
into a :class:`ModuleInfo` — the shared visitor walks the tree a single
time, recording a parent map plus typed node buckets (classes, functions,
excepts, raises, calls, assignments, bytes literals).  Rules consume those
buckets instead of re-walking, which is what keeps a full-tree lint in the
single-digit-second range (asserted in ``tests/test_torch_analysis.py``).

Two rule shapes exist: *module* rules (:meth:`Rule.check_module`, run per
file) and *project* rules (:meth:`Rule.check_project`, run once over every
parsed module — kernel parity needs the cross-file view, the ``csrc/*.cu``
sources, the port's tests and ``chip_smoke.py``).  Findings
on a line carrying (or directly below) a ``# lint: allow <RULE> --
<reason>`` annotation are suppressed; reasonless annotations are reported
as ``RA000`` so a suppression can never silently lose its justification.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.findings import ENGINE_RULE, Finding, parse_suppressions

__all__ = ["ModuleInfo", "ProjectContext", "Rule", "analyze_source",
           "default_chip_smoke", "default_root", "default_tests_dir",
           "load_modules", "run_analysis"]


class ModuleInfo:
    """One parsed source file + the shared single-pass AST index."""

    def __init__(self, path: Path | None, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)  # SyntaxError handled by the loader
        self.allow, self.malformed_suppressions = parse_suppressions(self.lines)
        # -- typed buckets filled by the one shared walk ---------------------
        self.classes: list[ast.ClassDef] = []
        self.functions: list[ast.FunctionDef | ast.AsyncFunctionDef] = []
        self.lambdas: list[ast.Lambda] = []
        self.excepts: list[ast.ExceptHandler] = []
        self.raises: list[ast.Raise] = []
        self.asserts: list[ast.Assert] = []
        self.calls: list[ast.Call] = []
        self.assigns: list[ast.Assign | ast.AnnAssign | ast.AugAssign] = []
        self.bytes_consts: list[ast.Constant] = []
        self._parents: dict[ast.AST, ast.AST] = {}
        self._walk()

    def _walk(self) -> None:
        stack: list[ast.AST] = [self.tree]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
                stack.append(child)
            if isinstance(node, ast.ClassDef):
                self.classes.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.append(node)
            elif isinstance(node, ast.Lambda):
                self.lambdas.append(node)
            elif isinstance(node, ast.ExceptHandler):
                self.excepts.append(node)
            elif isinstance(node, ast.Raise):
                self.raises.append(node)
            elif isinstance(node, ast.Assert):
                self.asserts.append(node)
            elif isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self.assigns.append(node)
            elif isinstance(node, ast.Constant) and isinstance(node.value, bytes):
                self.bytes_consts.append(node)

    # -- tree navigation -----------------------------------------------------

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def line(self, lineno: int) -> str:
        return self.lines[lineno - 1] if 1 <= lineno <= len(self.lines) else ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        """True when the finding line (or a standalone comment directly
        above it) carries a ``# lint: allow`` for this rule."""
        if rule in self.allow.get(lineno, ()):
            return True
        above = self.allow.get(lineno - 1)
        if above and rule in above and self.line(lineno - 1).lstrip().startswith("#"):
            return True
        return False


@dataclass
class ProjectContext:
    """Cross-file facts project rules need: where the tree, the port's tests
    and the card's check script live."""

    root: Path
    tests_dir: Path | None = None
    chip_smoke: Path | None = None
    _tests_text: str | None = field(default=None, repr=False)
    _chip_smoke_text: str | None = field(default=None, repr=False)

    def tests_text(self) -> str:
        """Concatenated source of every ``tests/test_torch_*.py`` (lazily
        read once): the haystack kernel parity searches for op coverage.
        Only the port's tests: the reference's ops share the port's names,
        so its tests would cover a port op they never run."""
        if self._tests_text is None:
            chunks = []
            if self.tests_dir is not None and self.tests_dir.is_dir():
                for p in sorted(self.tests_dir.glob("test_torch_*.py")):
                    try:
                        chunks.append(p.read_text())
                    except OSError:
                        pass
            self._tests_text = "\n".join(chunks)
        return self._tests_text

    def chip_smoke_text(self) -> str | None:
        """Source of ``chip_smoke.py`` (lazily read once), the script that
        holds every kernel against its plain version on the card; None when
        there is none."""
        if self._chip_smoke_text is None and self.chip_smoke is not None:
            try:
                self._chip_smoke_text = self.chip_smoke.read_text()
            except OSError:
                pass
        return self._chip_smoke_text


class Rule:
    """Base class: subclasses set ``id``/``name``/``severity`` and override
    one (or both) of the check hooks."""

    id = "RA000"
    name = "unnamed"
    severity = "error"

    def check_module(self, mod: ModuleInfo) -> Iterable[Finding]:
        return ()

    def check_project(self, mods: list[ModuleInfo],
                      ctx: ProjectContext) -> Iterable[Finding]:
        return ()

    def finding(self, mod_or_rel, lineno: int, message: str) -> Finding:
        rel = mod_or_rel.rel if isinstance(mod_or_rel, ModuleInfo) else str(mod_or_rel)
        return Finding(rel, int(lineno), self.id, self.severity, message)


def all_rules() -> dict[str, Rule]:
    """Fresh instances of every registered rule, keyed by id."""
    from repro_torch.analysis.hygiene import ExceptionHygiene
    from repro_torch.analysis.locks import LockDiscipline
    from repro_torch.analysis.parity import KernelParity
    from repro_torch.analysis.tags import ContainerTagDrift
    from repro_torch.analysis.tracer import TracerSafety

    rules = [LockDiscipline(), TracerSafety(), KernelParity(),
             ExceptionHygiene(), ContainerTagDrift()]
    return {r.id: r for r in rules}


def default_root() -> Path:
    """The installed ``repro_torch`` package directory — the tree the gate
    lints (``src/repro_torch`` in a checkout)."""
    import repro_torch

    return Path(repro_torch.__file__).resolve().parent


def default_tests_dir(root: Path) -> Path | None:
    """Find the test suite next to the analysis root: ``<repo>/tests`` for
    a ``src/repro_torch`` root, or ``<root>/tests`` for fixture trees."""
    candidates = []
    if len(root.parents) >= 2:
        candidates.append(root.parents[1] / "tests")
    candidates += [root / "tests", root.parent / "tests"]
    for c in candidates:
        if c.is_dir():
            return c
    return None


def default_chip_smoke(tests_dir: Path | None) -> Path | None:
    """``chip_smoke.py`` beside the test suite (the repository root)."""
    if tests_dir is None:
        return None
    path = tests_dir.parent / "chip_smoke.py"
    return path if path.is_file() else None


def load_modules(root: Path) -> tuple[list[ModuleInfo], list[Finding]]:
    """Read + parse every ``*.py`` under root ONCE.  Unreadable or
    syntactically broken files become ``RA000`` findings, not crashes."""
    mods: list[ModuleInfo] = []
    findings: list[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if "__pycache__" in path.parts:
            continue
        try:
            text = path.read_text()
        except OSError as e:
            findings.append(Finding(rel, 1, ENGINE_RULE, "error",
                                    f"unreadable source file: {e}"))
            continue
        try:
            mods.append(ModuleInfo(path, rel, text))
        except SyntaxError as e:
            findings.append(Finding(rel, int(e.lineno or 1), ENGINE_RULE,
                                    "error", f"syntax error: {e.msg}"))
    return mods, findings


def run_analysis(root=None, rules: Iterable[str] | None = None,
                 tests_dir=None, chip_smoke=None) -> list[Finding]:
    """Run the selected rules over every module under ``root``.

    Returns the sorted, suppression-filtered findings.  ``rules`` selects a
    subset by id (unknown ids raise ``ValueError`` — the CLI maps that to
    exit code 2); the default runs everything.  ``tests_dir`` and
    ``chip_smoke`` default to the ones beside ``root``
    (:func:`default_tests_dir`, :func:`default_chip_smoke`).
    """
    root = Path(root).resolve() if root is not None else default_root()
    if not root.is_dir():
        raise ValueError(f"analysis root {str(root)!r} is not a directory")
    registry = all_rules()
    if rules is None:
        selected = list(registry.values())
    else:
        unknown = [r for r in rules if r not in registry]
        if unknown:
            raise ValueError(
                f"unknown rule id(s) {unknown} (known: {sorted(registry)})")
        selected = [registry[r] for r in dict.fromkeys(rules)]
    mods, findings = load_modules(root)
    tests_dir = Path(tests_dir) if tests_dir is not None else default_tests_dir(root)
    ctx = ProjectContext(
        root=root, tests_dir=tests_dir,
        chip_smoke=Path(chip_smoke) if chip_smoke is not None
        else default_chip_smoke(tests_dir))
    by_rel = {m.rel: m for m in mods}
    for mod in mods:
        for lineno, ids in mod.malformed_suppressions:
            findings.append(Finding(
                mod.rel, lineno, ENGINE_RULE, "error",
                f"suppression for {ids} is missing its required reason "
                "(write '# lint: allow RAnnn -- <why this is intended>')"))
    for rule in selected:
        for mod in mods:
            findings.extend(rule.check_module(mod))
        findings.extend(rule.check_project(mods, ctx))
    kept = []
    for f in findings:
        mod = by_rel.get(f.path)
        if f.rule != ENGINE_RULE and mod is not None \
                and mod.suppressed(f.line, f.rule):
            continue
        kept.append(f)
    return sorted(set(kept), key=Finding.sort_key)


def analyze_source(text: str, rel: str = "snippet.py",
                   rules: Iterable[str] | None = None) -> list[Finding]:
    """Run module-level rules over an in-memory snippet (the fixture-pair
    test helper).  Project rules need a real tree — use a tmp root."""
    registry = all_rules()
    selected = (list(registry.values()) if rules is None
                else [registry[r] for r in rules])
    mod = ModuleInfo(None, rel, text)
    findings = [
        Finding(rel, lineno, ENGINE_RULE, "error",
                f"suppression for {ids} is missing its required reason "
                "(write '# lint: allow RAnnn -- <why this is intended>')")
        for lineno, ids in mod.malformed_suppressions]
    for rule in selected:
        findings.extend(rule.check_module(mod))
    return sorted(
        (f for f in findings
         if f.rule == ENGINE_RULE or not mod.suppressed(f.line, f.rule)),
        key=Finding.sort_key)
