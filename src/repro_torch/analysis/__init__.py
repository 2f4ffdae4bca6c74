"""Project-specific static analysis, port of ``repro/analysis`` (docs/ANALYSIS.md).

An AST-based checker suite over the ``repro_torch`` tree: one shared parse
+ walk per file (``engine``), five rules encoding the invariants the rest
of the port only enforces by convention —

* **RA001 lock-discipline** (``locks``): attributes registered as
  lock-guarded are only mutated under ``with self.<lock>:``.
* **RA002 tracer-safety** (``tracer``): no host reads of tensor data,
  prints or Python data-dependent branching inside the functions that run
  on data-free tensors: ``register_fake`` shape rules and the
  ``forward``/``backward`` of ``torch.autograd.Function`` subclasses.
* **RA003 kernel-triple-parity** (``parity``): every ``csrc/*.cu`` entry is
  reached by a ``kernels/*.py`` wrapper through ``_build``, counted in
  ``_build.LAUNCHES``, dispatched by ``ops.py`` on the tensor's device with
  a ``ref.py`` plain version, named by a port test, and checked on the card
  by ``chip_smoke.py``.
* **RA004 exception-hygiene** (``hygiene``): no swallowed broad excepts;
  integrity paths raise the ``repro_torch.errors`` hierarchy.
* **RA005 container-tag-drift** (``tags``): container magic/version
  constants resolve to the one shared registry in ``sz/artifact.py``.

The ``# lint: allow RAnnn -- <reason>`` and ``# guarded-by: <lock>``
comments read the same as in the reference.  Shell surface: ``python -m
repro_torch.cli lint [--json] [--rule RAnnn ...] [--root DIR] [--baseline
PATH [--write-baseline]]`` — exit 0 clean, 1 findings, 2 usage, matching
the CLI-wide exit-code contract.  Only the standard library, plus the
container registry RA005 reads; no device is touched.
"""
from repro_torch.analysis.engine import (
    ModuleInfo,
    ProjectContext,
    Rule,
    all_rules,
    analyze_source,
    run_analysis,
)
from repro_torch.analysis.findings import Finding

__all__ = [
    "Finding",
    "ModuleInfo",
    "ProjectContext",
    "Rule",
    "all_rules",
    "analyze_source",
    "run_analysis",
]
