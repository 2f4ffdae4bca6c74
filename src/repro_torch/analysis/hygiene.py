"""RA004 — exception hygiene: no silent broad catches, structured
integrity raises.

Two failure patterns this rule exists to keep out of the tree:

* **Swallowed broad excepts.**  ``except Exception`` (or a bare
  ``except:``) hides real defects — a typo inside the handler scope turns
  into "the sharding constraint silently didn't apply".  Flagged
  everywhere in ``src/repro_torch`` except (a) a ``BaseException`` handler that
  visibly RE-RAISES (the cleanup-and-reraise idiom used by the mmap open
  path and the streaming executor is correct: cleanup must run for
  KeyboardInterrupt too), and (b) modules on the explicit
  :data:`ALLOWLIST` — reporting harnesses whose contract is to convert any
  per-cell failure into an error row.  Anything else needs a
  ``# lint: allow RA004 -- <reason>`` annotation.

* **Unstructured integrity raises.**  Inside the container modules
  (:data:`INTEGRITY_MODULES`), parse/verify functions must raise from the
  ``repro_torch.errors`` hierarchy — ``CorruptContainerError`` /
  ``CorruptLaneError`` carry offsets and expectations callers dispatch on
  (docs/ROBUSTNESS.md); a raw ``ValueError("bad magic")`` or an ``assert``
  erases that structure and breaks the CLI's exit-code contract.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import ModuleInfo, Rule

#: Modules where broad excepts are accepted by design: launch-time report
#: harnesses that must record any cell failure as data and keep sweeping.
ALLOWLIST = frozenset({"launch/dryrun.py", "launch/roofline.py"})

#: Modules whose parse/verify paths participate in the structured
#: integrity contract (docs/ROBUSTNESS.md).
INTEGRITY_MODULES = frozenset({
    "api.py", "exec/writer.py", "sz/artifact.py", "sz/entropy.py",
    "sz/szjax.py", "sz/tiled.py",
})

#: Exception names allowed from integrity paths: the repro_torch.errors
#: hierarchy (plus bare re-raise, handled structurally).
INTEGRITY_RAISES = frozenset({
    "IntegrityError", "CorruptContainerError", "CorruptLaneError",
})

_BROAD = ("Exception", "BaseException")
_BUILTIN_BROAD = frozenset({
    "AssertionError", "Exception", "RuntimeError", "ValueError",
})


def _exc_names(node: ast.AST | None) -> list[str]:
    if node is None:
        return []
    if isinstance(node, ast.Tuple):
        return [n for e in node.elts for n in _exc_names(e)]
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    return []


def _integrity_fn(name: str) -> bool:
    return (name == "from_bytes" or name.startswith(("parse_", "_parse"))
            or name.startswith(("verify", "_verify"))
            or name.startswith(("check_", "_check")))


class ExceptionHygiene(Rule):
    id = "RA004"
    name = "exception-hygiene"
    severity = "error"

    def check_module(self, mod: ModuleInfo):
        if mod.rel not in ALLOWLIST:
            yield from self._broad_excepts(mod)
        if mod.rel in INTEGRITY_MODULES:
            yield from self._integrity_raises(mod)

    def _broad_excepts(self, mod: ModuleInfo):
        for handler in mod.excepts:
            names = _exc_names(handler.type)
            bare = handler.type is None
            if not bare and not any(n in _BROAD for n in names):
                continue
            if not bare and "Exception" not in names \
                    and self._reraises(handler):
                continue  # `except BaseException: <cleanup>; raise` idiom
            what = "bare except:" if bare else \
                f"except {' / '.join(n for n in names if n in _BROAD)}"
            yield self.finding(
                mod, handler.lineno,
                f"broad '{what}' swallows unrelated failures — catch "
                "concrete exception types, or catch BaseException and "
                "re-raise after cleanup")

    @staticmethod
    def _reraises(handler: ast.ExceptHandler) -> bool:
        return any(isinstance(n, ast.Raise) and n.exc is None
                   for n in ast.walk(handler))

    def _integrity_raises(self, mod: ModuleInfo):
        for raise_ in mod.raises:
            fn = mod.enclosing_function(raise_)
            if fn is None or not _integrity_fn(fn.name):
                continue
            exc = raise_.exc
            if exc is None:
                continue  # bare re-raise
            name = None
            if isinstance(exc, ast.Call):
                names = _exc_names(exc.func)
                name = names[0] if names else None
            elif isinstance(exc, (ast.Name, ast.Attribute)):
                names = _exc_names(exc)
                name = names[0] if names else None
            if name in _BUILTIN_BROAD and name not in INTEGRITY_RAISES:
                yield self.finding(
                    mod, raise_.lineno,
                    f"integrity path {fn.name}() raises bare {name} — raise "
                    "from the repro_torch.errors hierarchy (CorruptContainerError/"
                    "CorruptLaneError carry offset + expectation)")
        for assert_ in mod.asserts:
            fn = mod.enclosing_function(assert_)
            if fn is not None and _integrity_fn(fn.name):
                yield self.finding(
                    mod, assert_.lineno,
                    f"integrity path {fn.name}() validates with assert — "
                    "asserts vanish under -O and raise unstructured "
                    "AssertionError; raise a repro_torch.errors type instead")
