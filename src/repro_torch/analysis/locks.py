"""RA001 — lock discipline on registered shared state.

The serving and caching layer holds shared mutable state behind
per-instance locks (``TileCache``, ``DecodeBatcher``, ``VolumePool``,
``AdmissionController``, ``_Metrics``, ``DecodeStats``).  Unsynchronized
counters and lock-free cache reads are the class of bug that load tests
stop catching once requests spread over threads and hosts.
This rule makes the contract checkable:

* an attribute is REGISTERED as guarded either by a ``# guarded-by: <lock>``
  comment on the line that initializes it (``self.x = 0  # guarded-by:
  _lock``) or through a class-level ``GUARDED = {"attr": "_lock"}`` dict;
* every mutation of a registered attribute (assignment, augmented
  assignment, ``del``, item store, or a mutating method call such as
  ``.append``/``.pop``/``.update``) must be lexically inside a
  ``with self.<lock>:`` block naming the registered lock;
* ``__init__`` is exempt — the object is not shared while it is being
  constructed.

``Condition`` objects count as locks (``with self._cv:`` guards the state
the condition protects).  Reads are deliberately out of scope: immutable
and monotone reads are common and fine; it is lost *updates* that corrupt
the metrics and cache accounting.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import ModuleInfo, Rule
from repro_torch.analysis.findings import guard_annotation

# Mutating container/deque/dict/set methods: calling one of these on a
# guarded attribute mutates it just as surely as assignment does.
MUTATING_METHODS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend", "insert",
    "move_to_end", "pop", "popitem", "popleft", "remove", "setdefault",
    "update",
})


def _self_attr(node: ast.AST) -> str | None:
    """``self.<attr>`` -> attr name (drilling through subscripts, so
    ``self._d[k]`` and ``self._d[k][j]`` both resolve to ``_d``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _flatten_targets(target: ast.AST):
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _flatten_targets(elt)
    else:
        yield target


class LockDiscipline(Rule):
    id = "RA001"
    name = "lock-discipline"
    severity = "error"

    def check_module(self, mod: ModuleInfo):
        for cls in mod.classes:
            guarded = self._guarded_attrs(cls, mod)
            if guarded:
                yield from self._check_class(cls, guarded, mod)

    # -- registration --------------------------------------------------------

    def _guarded_attrs(self, cls: ast.ClassDef, mod: ModuleInfo) -> dict[str, str]:
        """attr -> lock name, from guard comments + the GUARDED registry."""
        guarded: dict[str, str] = {}
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if mod.enclosing_class(node) is not cls:
                    continue  # a nested class's annotations are its own
                lock = guard_annotation(mod.line(node.lineno))
                if lock is None:
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for leaf in _flatten_targets(t):
                        attr = _self_attr(leaf)
                        if attr is not None:
                            guarded[attr] = lock
        # class-level registry: GUARDED = {"attr": "_lock", ...}
        for stmt in cls.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == "GUARDED" \
                    and isinstance(stmt.value, ast.Dict):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                            and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        guarded[k.value] = v.value
        return guarded

    # -- enforcement ---------------------------------------------------------

    def _check_class(self, cls: ast.ClassDef, guarded: dict[str, str],
                     mod: ModuleInfo):
        for node in ast.walk(cls):
            if mod.enclosing_class(node) is not cls:
                continue
            fn = mod.enclosing_function(node)
            if fn is None or fn.name == "__init__":
                continue  # class body / construction: not shared yet
            for attr, where in self._mutations(node):
                lock = guarded.get(attr)
                if lock is None:
                    continue
                if not self._lock_held(where, lock, mod):
                    yield self.finding(
                        mod, where.lineno,
                        f"{cls.name}.{attr} is registered as guarded by "
                        f"self.{lock} but is mutated in {fn.name}() outside "
                        f"a 'with self.{lock}:' block")

    def _mutations(self, node: ast.AST):
        """(attr, node) pairs for every self-attribute mutation in node."""
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for leaf in _flatten_targets(t):
                    attr = _self_attr(leaf)
                    if attr is not None:
                        yield attr, node
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            attr = _self_attr(node.target)
            if attr is not None:
                yield attr, node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    yield attr, node
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATING_METHODS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                yield attr, node

    def _lock_held(self, node: ast.AST, lock: str, mod: ModuleInfo) -> bool:
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    e = item.context_expr
                    if isinstance(e, ast.Attribute) \
                            and isinstance(e.value, ast.Name) \
                            and e.value.id == "self" and e.attr == lock:
                        return True
        return False
