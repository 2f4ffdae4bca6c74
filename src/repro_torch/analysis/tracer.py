"""RA002 — tracer safety inside the functions that run on data-free tensors.

Eager PyTorch has no ``jax.jit``, but two kinds of function in the port run
on tensors that carry no data:

* shape rules registered with ``register_fake`` (``kernels/ops.py``): a
  shape-only trace — fake or meta tensors, as the dry run makes them —
  calls the rule in place of the kernel and its plain version;
* the ``forward`` / ``backward`` of ``torch.autograd.Function`` subclasses
  (``models/spmd.py``, ``launch/gwlz_dist.py``), which the dry run runs
  under ``FakeTensorMode`` and through ``launch/opcount.py``'s dispatch
  mode.

Host work inside them either crashes (a fake tensor has no value to read),
silently specializes the trace to one input, or fires once per trace
instead of once per step.  Inside them this rule flags:

* ``print(...)`` / ``breakpoint()`` calls;
* ``global`` / ``nonlocal`` declarations (mutation of enclosing state);
* a host read of a traced parameter: ``p.item()``, ``p.tolist()``,
  ``p.numpy()``, ``p.cpu()``, ``int(p)``, ``float(p)``, ``bool(p)`` and
  host ``np.*(p)`` / ``numpy.*(p)`` calls;
* ``if`` / ``while`` tests using a traced parameter as a bare name —
  Python-level data-dependent control flow.

``ctx`` is no tensor and is never traced.  Attribute reads like
``x.shape``/``x.dtype``/``x.ndim`` are static facts of a fake tensor and
stay allowed, as do ``is None`` tests and host reads of values the
function built itself (``torch.tensor(c).item()``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.engine import ModuleInfo, Rule

_HOST_MODULES = ("np", "numpy")
_SIDE_EFFECT_CALLS = ("print", "breakpoint")
_HOST_READ_METHODS = ("item", "tolist", "numpy", "cpu")
_HOST_CASTS = ("int", "float", "bool")
_AUTOGRAD_BASES = ("Function", "autograd.Function", "torch.autograd.Function")
_AUTOGRAD_METHODS = ("forward", "backward")


def _dotted(node: ast.AST) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _param_names(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _is_register_fake(node: ast.AST) -> bool:
    """``<op>.register_fake`` or ``torch.library.register_fake(...)``."""
    name = _dotted(node.func if isinstance(node, ast.Call) else node)
    return name is not None and name.split(".")[-1] == "register_fake"


class TracerSafety(Rule):
    id = "RA002"
    name = "tracer-safety"
    severity = "error"

    def check_module(self, mod: ModuleInfo):
        seen: set[ast.AST] = set()
        for fn, kind in self._traced_functions(mod):
            if fn in seen:
                continue
            seen.add(fn)
            traced = set(_param_names(fn)) - {"ctx"}
            yield from self._check_traced(fn, traced, kind, mod)

    # -- which functions run on data-free tensors ----------------------------

    def _traced_functions(self, mod: ModuleInfo):
        by_name = {}
        for fn in mod.functions:
            by_name.setdefault(fn.name, fn)
        # shape rules: @<op>.register_fake / @torch.library.register_fake(...)
        for fn in mod.functions:
            if any(_is_register_fake(d) for d in fn.decorator_list):
                yield fn, "shape rule"
        # shape rules registered by call: <op>.register_fake(fn)
        for call in mod.calls:
            if not _is_register_fake(call):
                continue
            for arg in call.args:
                if isinstance(arg, ast.Lambda):
                    yield arg, "shape rule"
                elif isinstance(arg, ast.Name) and arg.id in by_name:
                    yield by_name[arg.id], "shape rule"
        # forward / backward of torch.autograd.Function subclasses
        for cls in mod.classes:
            if not any(_dotted(b) in _AUTOGRAD_BASES for b in cls.bases):
                continue
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name in _AUTOGRAD_METHODS:
                    yield stmt, f"autograd.Function {cls.name}.{stmt.name}"

    # -- what must not happen inside one -------------------------------------

    def _check_traced(self, fn, traced: set[str], kind: str, mod: ModuleInfo):
        where = f"{kind} {getattr(fn, 'name', '<lambda>')}" \
            if kind == "shape rule" else kind
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                cname = _dotted(node.func)
                if cname in _SIDE_EFFECT_CALLS:
                    yield self.finding(
                        mod, node.lineno,
                        f"host side effect {cname}() inside {where} (runs once "
                        "per trace, not per step)")
                    continue
                hit = self._host_read(node, cname, traced)
                if hit is not None:
                    yield self.finding(
                        mod, node.lineno,
                        f"host read {hit} of a traced tensor inside {where} (a "
                        "fake or meta tensor has no data: keep it on the device, "
                        "or read it before the traced call)")
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                label = "global" if isinstance(node, ast.Global) else "nonlocal"
                yield self.finding(
                    mod, node.lineno,
                    f"{label} mutation inside {where} (side effects fire once "
                    "per trace)")
            elif isinstance(node, (ast.If, ast.While)):
                hit = self._traced_name_in_test(node.test, traced)
                if hit is not None:
                    yield self.finding(
                        mod, node.lineno,
                        f"Python-level branch on traced value '{hit}' inside "
                        f"{where} (data-dependent control flow needs torch.where, "
                        "or a decision from shapes and dtypes)")

    @staticmethod
    def _host_read(call: ast.Call, cname: str | None, traced: set[str]) -> str | None:
        """The spelling of a host read of a traced parameter, else None."""
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_READ_METHODS \
                and isinstance(f.value, ast.Name) and f.value.id in traced:
            return f"{f.value.id}.{f.attr}()"
        args = [a.value if isinstance(a, ast.Starred) else a
                for a in list(call.args) + [kw.value for kw in call.keywords]]
        hit = next((a.id for a in args if isinstance(a, ast.Name) and a.id in traced), None)
        if hit is None:
            return None
        if cname in _HOST_CASTS:
            return f"{cname}({hit})"
        if cname is not None and "." in cname and cname.split(".", 1)[0] in _HOST_MODULES:
            return f"{cname}({hit})"
        return None

    def _traced_name_in_test(self, test: ast.AST, traced: set[str]) -> str | None:
        """A traced parameter used as a BARE name in a branch test.

        Names under an Attribute (``x.ndim``) or a call result are skipped —
        shape/dtype/ndim reads are static facts about a fake tensor.  Identity
        tests against ``None`` (``if g is None:``) are also skipped: the
        comparison reads no data."""
        parents: dict[ast.AST, ast.AST] = {}
        stack = [test]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                parents[child] = node
                stack.append(child)
            if isinstance(node, ast.Name) and node.id in traced:
                p = parents.get(node)
                if isinstance(p, ast.Attribute) and p.value is node:
                    continue
                if isinstance(p, ast.Call):
                    continue  # f(x) in a test: the call decides staticness
                if isinstance(p, ast.Compare) and self._is_none_identity(p):
                    continue
                return node.id
        return None

    @staticmethod
    def _is_none_identity(cmp: ast.Compare) -> bool:
        """True for ``x is None`` / ``x is not None`` shaped comparisons."""
        if not all(isinstance(op, (ast.Is, ast.IsNot)) for op in cmp.ops):
            return False
        operands = [cmp.left] + list(cmp.comparators)
        return any(isinstance(o, ast.Constant) and o.value is None
                   for o in operands)
