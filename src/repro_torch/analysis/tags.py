"""RA005 — container-tag drift: wire constants live in ONE registry.

Magic bytes and format version numbers are wire contracts shared by four
parsers (``sz/tiled.py``, ``sz/szjax.py``, ``sz/artifact.py``,
``exec/writer.py``) plus the GWDS envelope in ``api.py`` and the entropy
blob header.  GWTC went v1→v3 and GWDS v1→v2; each bump had to touch every
copy of the literal, and a missed copy is exactly the drift that parses
yesterday's containers with today's constants.  The shared registry
(:data:`repro_torch.sz.artifact.CONTAINER_TAGS`) is now the single source of
truth; this rule flags, everywhere outside that registry module:

* a ``bytes`` literal equal to any registered magic or sentinel
  (``b"GWTC"``, ``b"SZJX"``, ``b"GWDS"``, ``b"GWDX"``, ``b"GWJL"``,
  ``b"RPRE"``) — import the named constant instead;
* an assignment of an integer literal to a ``*VERSION``-named constant —
  alias the registry value (``_VERSION = A.GWTC_VERSION``) so a format
  bump is one edit.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.engine import ModuleInfo, Rule

#: The registry module: the one place literal tag values are allowed.
REGISTRY_MODULE = "sz/artifact.py"

_VERSION_NAME = re.compile(r"^_?[A-Z0-9_]*VERSION$")


def _registry_values() -> dict[bytes, str]:
    """magic/sentinel bytes -> the registry constant naming them."""
    from repro_torch.sz.artifact import CONTAINER_TAGS

    out: dict[bytes, str] = {}
    for tag in CONTAINER_TAGS.values():
        out.setdefault(tag.magic, f"{tag.name} magic")
        if tag.sentinel is not None:
            out.setdefault(tag.sentinel, f"{tag.name} sentinel")
    return out


class ContainerTagDrift(Rule):
    id = "RA005"
    name = "container-tag-drift"
    severity = "error"

    def __init__(self):
        self._values = _registry_values()

    def check_module(self, mod: ModuleInfo):
        if mod.rel == REGISTRY_MODULE:
            return
        for const in mod.bytes_consts:
            label = self._values.get(const.value)
            if label is not None:
                yield self.finding(
                    mod, const.lineno,
                    f"container tag literal {const.value!r} ({label}) "
                    "duplicated outside the shared registry — import it "
                    "from repro_torch.sz.artifact so a format bump is one edit")
        for node in mod.assigns:
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if not isinstance(node.value, ast.Constant) \
                    or not isinstance(node.value.value, int) \
                    or isinstance(node.value.value, bool):
                continue
            for t in targets:
                if isinstance(t, ast.Name) and _VERSION_NAME.match(t.id):
                    yield self.finding(
                        mod, node.lineno,
                        f"format version constant {t.id} = "
                        f"{node.value.value} defined outside the shared "
                        "registry — alias repro_torch.sz.artifact's version "
                        "instead (container versions must not fork)")
