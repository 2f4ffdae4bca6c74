"""RA003 — kernel-triple parity: every CUDA kernel ships with its plain
version and its checks.

The port's accelerator layer is built as triples: a C entry in
``csrc/<source>.cu``; a ``kernels/<name>.py`` wrapper that reaches it through
``_build.launch(counter, source, fn, ...)`` (or, for a query such as a
workspace size, ``_build._library(source).<fn>``); and a dispatcher in
``kernels/ops.py`` that follows the tensor's device (``_on_cuda``) and
calls the plain PyTorch version in ``kernels/ref.py`` on the CPU.  The CPU
tests check the plain versions; ``chip_smoke.py`` holds each kernel against
its plain version on the card.  A kernel missing one of these can drift
silently.  This project rule asserts, across files:

* every ``extern "C"`` entry of ``csrc/*.cu`` is reached by a
  ``kernels/*.py`` wrapper;
* every ``_build.launch`` names its counter, source and entry as literals,
  its source and entry name an ``extern "C"`` entry, and its counter is a
  key of ``_build.LAUNCHES``;
* every public kernel function (a ``kernels/*.py`` def that calls
  ``_build.launch``) is imported by ``kernels/ops.py``;
* every public ``*_op`` in ``ops.py`` that reaches a kernel function —
  itself, or through a module-local helper one level down (a def it calls,
  or a ``torch.library.custom_op`` it calls as ``torch.ops.<ns>.<name>``) —
  calls ``_on_cuda`` and a ``ref.*`` plain version that ``ref.py``
  defines, and is named by a ``tests/test_torch_*.py``;
* every ``_build.LAUNCHES`` counter is a key of ``chip_smoke.py``'s
  ``KERNELS`` table, the card's kernel-against-plain check.

Ops with no kernel (``lorenzo_decode_tiles_op``) are exempt: there is no
kernel to compare.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import ModuleInfo, ProjectContext, Rule

_EXCLUDED = ("kernels/__init__.py", "kernels/ops.py", "kernels/ref.py",
             "kernels/_build.py")
# extern "C" <return type> <name>(  -- the entry's name is the last word
_ENTRY_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?(\w+)\s*\(')


def _top_level_defs(mod: ModuleInfo | None) -> list:
    if mod is None:
        return []
    return [s for s in mod.tree.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _build_call(node: ast.AST, attr: str) -> bool:
    """``node`` is ``_build.<attr>(...)``."""
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
        and node.func.attr == attr and isinstance(node.func.value, ast.Name) \
        and node.func.value.id == "_build"


def _const_str(node: ast.AST) -> str | None:
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) \
        else None


def _dict_keys(tree: ast.Module, name: str) -> dict[str, int] | None:
    """Literal string keys (-> line) of the top-level ``<name> = {...}``."""
    for stmt in tree.body:
        target = stmt.targets[0] if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            else stmt.target if isinstance(stmt, ast.AnnAssign) else None
        if isinstance(target, ast.Name) and target.id == name \
                and isinstance(stmt.value, ast.Dict):
            return {k.value: k.lineno for k in stmt.value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return None


class KernelParity(Rule):
    id = "RA003"
    name = "kernel-triple-parity"
    severity = "error"

    def check_project(self, mods: list[ModuleInfo], ctx: ProjectContext):
        by_rel = {m.rel: m for m in mods}
        entries = self._entries(ctx)
        kernel_mods = [m for m in mods
                       if m.rel.startswith("kernels/") and m.rel.count("/") == 1
                       and m.rel not in _EXCLUDED]
        launches = {m.rel: [c for c in m.calls if _build_call(c, "launch")]
                    for m in kernel_mods}
        if not entries and not any(launches.values()):
            return  # no CUDA layer in this tree

        # 1) every C entry is reached by a wrapper
        reached = set()
        for m in kernel_mods:
            for call in launches[m.rel]:
                if len(call.args) >= 3:
                    reached.add((_const_str(call.args[1]), _const_str(call.args[2])))
            for node in m.calls:  # _build._library("<source>").<entry>
                parent = m.parent(node)
                if _build_call(node, "_library") and node.args \
                        and isinstance(parent, ast.Attribute):
                    reached.add((_const_str(node.args[0]), parent.attr))
        for (source, fn), line in sorted(entries.items()):
            if (source, fn) not in reached:
                yield self.finding(
                    f"csrc/{source}.cu", line,
                    f'extern "C" entry {fn} of csrc/{source}.cu is reached by no '
                    "kernels/*.py wrapper (_build.launch or _build._library)")

        # 2) every launch names an entry and a LAUNCHES counter
        build = by_rel.get("kernels/_build.py")
        counters = (_dict_keys(build.tree, "LAUNCHES") if build else None) or {}
        for m in kernel_mods:
            for call in launches[m.rel]:
                names = [_const_str(a) for a in call.args[:3]]
                if len(names) < 3 or None in names:
                    yield self.finding(
                        m, call.lineno, "_build.launch must name its counter, source "
                                        "and entry as string literals")
                    continue
                counter, source, fn = names
                if (source, fn) not in entries:
                    yield self.finding(
                        m, call.lineno,
                        f'_build.launch calls {fn} of csrc/{source}.cu, which has no '
                        'such extern "C" entry')
                if counter not in counters:
                    yield self.finding(
                        m, call.lineno,
                        f"_build.launch counts {counter!r}, which is not a key of "
                        "kernels/_build.py's LAUNCHES")

        # 3) every public kernel function is imported by ops.py
        kernel_fns = {(m.rel, fn.name) for m in kernel_mods for fn in _top_level_defs(m)
                      if not fn.name.startswith("_")
                      and any(_build_call(n, "launch") for n in ast.walk(fn))}
        ops = by_rel.get("kernels/ops.py")
        if ops is None:
            for rel in sorted({rel for rel, _ in kernel_fns}):
                yield self.finding(
                    rel, 1, f"kernel module {rel} has no kernels/ops.py dispatch "
                            "layer (kernel/plain/op triple is incomplete)")
        else:
            imports = self._kernel_imports(ops)
            imported = {v: k for k, v in imports.items()}
            for rel, name in sorted(kernel_fns - set(imports.values())):
                line = next(fn.lineno for fn in _top_level_defs(by_rel[rel])
                            if fn.name == name)
                yield self.finding(
                    rel, line, f"kernel function {name} of {rel} is not imported by "
                               "kernels/ops.py — the kernel is not dispatchable")
            yield from self._dispatchers(
                ops, by_rel.get("kernels/ref.py"),
                {imported[k] for k in kernel_fns if k in imported}, ctx)

        # 4) every counter is checked on the card
        if not counters:
            return
        smoke = ctx.chip_smoke_text()
        checked = None
        if smoke is not None:
            try:
                checked = _dict_keys(ast.parse(smoke), "KERNELS")
            except SyntaxError:
                checked = None
        for counter, line in sorted(counters.items()):
            if checked is None:
                yield self.finding(
                    build, line, f"no chip_smoke.py with a KERNELS table found to check "
                                 f"kernel {counter!r} against its plain version on the card")
            elif counter not in checked:
                yield self.finding(
                    build, line, f"kernel {counter!r} is not a key of chip_smoke.py's "
                                 "KERNELS — nothing holds it against its plain version "
                                 "on the card")

    def _dispatchers(self, ops: ModuleInfo, ref: ModuleInfo | None, kernels: set[str],
                     ctx: ProjectContext):
        ref_defs = {fn.name for fn in _top_level_defs(ref)}
        helpers = {fn.name: fn for fn in _top_level_defs(ops)}
        custom_ops = self._custom_ops(ops)
        tests_text = ctx.tests_text()
        for fn in _top_level_defs(ops):
            if not fn.name.endswith("_op") or fn.name.startswith("_"):
                continue
            scope = [fn] + [h for h in self._helpers_called(fn, helpers, custom_ops)
                            if h is not fn]
            used = {n.id for f in scope for n in ast.walk(f) if isinstance(n, ast.Name)}
            kernel_used = used & kernels
            if not kernel_used:
                continue  # plain-torch op: no kernel branch to check
            if "_on_cuda" not in used:
                yield self.finding(
                    ops, fn.lineno,
                    f"{fn.name} dispatches kernel(s) {sorted(kernel_used)} without "
                    "_on_cuda — the choice must follow the tensor's device")
            ref_used = {n.attr for f in scope for n in ast.walk(f)
                        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                        and n.value.id == "ref"}
            if not ref_used:
                yield self.finding(
                    ops, fn.lineno,
                    f"{fn.name} dispatches kernel(s) {sorted(kernel_used)} but never "
                    "calls a ref.* plain version — the kernel is uncheckable")
            elif ref_used - ref_defs:
                missing = sorted(ref_used - ref_defs)
                yield self.finding(
                    ops, fn.lineno,
                    f"{fn.name} calls ref.{missing[0]} but kernels/ref.py does not "
                    f"define it (missing plain versions: {missing})")
            if not tests_text:
                yield self.finding(
                    ops, fn.lineno,
                    f"no tests/test_torch_*.py found to cover {fn.name} (the plain "
                    "versions' parity tests are required)")
            elif not re.search(rf"\b{re.escape(fn.name)}\b", tests_text):
                yield self.finding(
                    ops, fn.lineno,
                    f"{fn.name} appears in no tests/test_torch_*.py under "
                    f"{ctx.tests_dir} — every dispatch op needs a parity test")

    @staticmethod
    def _entries(ctx: ProjectContext) -> dict[tuple[str, str], int]:
        """(source, entry) -> line of every ``extern "C"`` in ``csrc/*.cu``."""
        out: dict[tuple[str, str], int] = {}
        csrc = ctx.root / "csrc"
        for path in sorted(csrc.glob("*.cu")) if csrc.is_dir() else ():
            try:
                text = path.read_text()
            except OSError:
                continue
            for m in _ENTRY_RE.finditer(text):
                out[(path.stem, m.group(1))] = text.count("\n", 0, m.start()) + 1
        return out

    @staticmethod
    def _kernel_imports(ops: ModuleInfo) -> dict[str, tuple[str, str]]:
        """local name -> (module rel, def name) for ``from <pkg>.kernels.X
        import a, b`` in ops.py."""
        out: dict[str, tuple[str, str]] = {}
        for node in ast.walk(ops.tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and ".kernels." in f".{node.module}":
                rel = f"kernels/{node.module.rsplit('.', 1)[-1]}.py"
                for alias in node.names:
                    out[alias.asname or alias.name] = (rel, alias.name)
        return out

    @staticmethod
    def _custom_ops(ops: ModuleInfo) -> dict[str, ast.FunctionDef]:
        """``<ns>.<name>`` -> the def decorated ``@torch.library.custom_op(
        "<ns>::<name>", ...)``."""
        out = {}
        for fn in _top_level_defs(ops):
            for dec in fn.decorator_list:
                if isinstance(dec, ast.Call) and isinstance(dec.func, ast.Attribute) \
                        and dec.func.attr == "custom_op" and dec.args:
                    name = _const_str(dec.args[0])
                    if name:
                        out[name.replace("::", ".")] = fn
        return out

    @staticmethod
    def _helpers_called(fn, helpers: dict, custom_ops: dict) -> list:
        """Module-local defs ``fn`` calls by name, and custom ops it calls
        as ``torch.ops.<ns>.<name>``."""
        out = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in helpers:
                out.append(helpers[f.id])
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute) \
                    and isinstance(f.value.value, ast.Attribute) \
                    and f.value.value.attr == "ops":
                hit = custom_ops.get(f"{f.value.attr}.{f.attr}")
                if hit is not None:
                    out.append(hit)
        return out
