"""The port's static-analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

RA001, RA004, RA005 and the RA000 suppression rules read the same source
the same way in both packages: the reference's fixture snippets and whole
trees give the same ``(path, line, rule)`` findings.  RA002 and RA003 hold
the port to its own mechanisms (``register_fake`` shape rules and
``autograd.Function`` bodies; the ``csrc`` entry / ``_build`` wrapper /
``ops`` dispatcher / ``ref`` plain version / port test / card check
triple), so they get their own fixtures.  Then the port's tree is clean and
fast, and ``python -m repro_torch.cli lint`` keeps the reference CLI's exit
codes and baseline round trip.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from repro import analysis as R
from repro_torch import cli
from repro_torch import analysis as P

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _src(s: str) -> str:
    return textwrap.dedent(s).lstrip("\n")


def _pairs(findings) -> list:
    return [(f.line, f.rule) for f in findings]


def _triples(findings) -> set:
    return {(f.path, f.line, f.rule) for f in findings}


# ---------------------------------------------------------------------------
# RA001 / RA004 / RA005 / RA000: the reference's fixtures through both gates
# ---------------------------------------------------------------------------

# (name, source, rules, rel, (line, rule) pairs the port must find)
SHARED_CASES = [
    ("ra001_unlocked", _src("""
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._hits = 0  # guarded-by: _lock

            def bump(self):
                self._hits += 1
    """), ["RA001"], "snippet.py", [(9, "RA001")]),
    ("ra001_locked", _src("""
        import threading

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()
                self._hits = 0  # guarded-by: _lock

            def bump(self):
                with self._lock:
                    self._hits += 1
    """), ["RA001"], "snippet.py", []),
    ("ra001_guarded_dict", _src("""
        class Pool:
            GUARDED = {"items": "_lock"}

            def __init__(self, lock):
                self._lock = lock
                self.items = []

            def add(self, x):
                self.items.append(x)
    """), ["RA001"], "snippet.py", [(9, "RA001")]),
    ("ra001_init_and_wrong_lock", _src("""
        class C:
            def __init__(self):
                self._lock = object()
                self._other = object()
                self.n = 0  # guarded-by: _lock
                self.n = 1

            def bump(self):
                with self._other:
                    self.n += 1
    """), ["RA001"], "snippet.py", [(10, "RA001")]),
    ("ra001_mutating_method_and_subscript", _src("""
        class C:
            def __init__(self):
                self._lock = object()
                self._d = {}  # guarded-by: _lock

            def put(self, k, v):
                self._d[k] = v

            def drop(self, k):
                self._d.pop(k)
    """), ["RA001"], "snippet.py", [(7, "RA001"), (10, "RA001")]),
    ("ra004_broad", _src("""
        def f():
            try:
                g()
            except Exception:
                pass

        def h():
            try:
                g()
            except:
                pass
    """), ["RA004"], "snippet.py", [(4, "RA004"), (10, "RA004")]),
    ("ra004_narrow_and_cleanup_reraise", _src("""
        def f():
            try:
                g()
            except ValueError:
                pass

        def h(res):
            try:
                g()
            except BaseException:
                res.close()
                raise
    """), ["RA004"], "snippet.py", []),
    *[(f"ra004_integrity_{rel.replace('/', '_')}", _src("""
        from repro_torch.errors import CorruptContainerError

        def from_bytes(blob):
            if len(blob) < 4:
                raise ValueError("too short")
            assert blob[:4] == b"XXXX"
            return blob

        def parse_header(blob):
            raise CorruptContainerError("bad", offset=0)
    """), ["RA004"], rel, want) for rel, want in (
        ("sz/tiled.py", [(5, "RA004"), (6, "RA004")]), ("core/other.py", []))],
    ("ra004_entropy_check_lengths", _src("""
        class HuffmanCodec:
            def _check_lengths(self):
                if self.lengths.max() > 32:
                    raise ValueError("corrupt Huffman table")
    """), ["RA004"], "sz/entropy.py", [(4, "RA004")]),
    ("ra004_save_thread_annotated", _src("""
        class Saver:
            def _save(self):
                try:
                    self._write()
                except BaseException as e:  # lint: allow RA004 -- handed to wait(), which re-raises it
                    self._error = e
    """), ["RA004"], "checkpoint/manager.py", []),
    ("ra000_suppression_with_reason", _src("""
        def f():
            try:
                g()
            except Exception:  # lint: allow RA004 -- report harness keeps sweeping
                pass
    """), ["RA004"], "snippet.py", []),
    ("ra000_suppression_without_reason", _src("""
        def f():
            try:
                g()
            except Exception:  # lint: allow RA004
                pass
    """), ["RA004"], "snippet.py", [(4, "RA000"), (4, "RA004")]),
    ("ra000_suppression_on_line_above", _src("""
        def f():
            try:
                g()
            # lint: allow RA004 -- tolerated in this fixture
            except Exception:
                pass
    """), ["RA004"], "snippet.py", []),
    ("ra005_duplicated_tags", _src("""
        MAGIC = b"GWTC"
        _VERSION = 3

        def sniff(blob):
            return blob[:4] == b"GWDS"
    """), ["RA005"], "snippet.py", [(1, "RA005"), (2, "RA005"), (5, "RA005")]),
    ("ra005_aliases", _src("""
        from repro_torch.sz import artifact as A

        _MAGIC = A.GWTC_MAGIC
        _VERSION = A.GWTC_VERSION
        OTHER = b"OTHR"
    """), ["RA005"], "snippet.py", []),
    ("ra005_registry_module", 'GWTC_MAGIC, GWTC_VERSION = b"GWTC", 3\n', ["RA005"],
     "sz/artifact.py", []),
    ("ra005_sentinel_journal_entropy", _src("""
        SENT = b"GWDX"
        J = b"GWJL"
        E = b"RPRE"
    """), ["RA005"], "exec/writer.py", [(1, "RA005"), (2, "RA005"), (3, "RA005")]),
]


@pytest.mark.parametrize("name,src,rules,rel,want", SHARED_CASES,
                         ids=[c[0] for c in SHARED_CASES])
def test_shared_rules_match_the_reference(name, src, rules, rel, want):
    port = P.analyze_source(src, rel=rel, rules=rules)
    ref = R.analyze_source(src, rel=rel, rules=rules)
    assert _pairs(port) == _pairs(ref)
    assert _pairs(port) == want
    assert all(f.path == rel for f in port)


def _undo_repairs(tree: Path) -> None:
    """Put back the two RA004 findings the reference's gate reported on the
    port before they were repaired."""
    p = tree / "checkpoint" / "manager.py"
    s = p.read_text()
    assert "# lint: allow RA004 -- " in s
    p.write_text(s.replace("# lint: allow RA004 -- ", "# "))
    p = tree / "sz" / "entropy.py"
    s = p.read_text()
    assert "raise CorruptContainerError(\n                f\"corrupt Huffman" in s
    p.write_text(s.replace("raise CorruptContainerError(\n                f\"corrupt Huffman",
                           "raise ValueError(\n                f\"corrupt Huffman"))


@pytest.mark.parametrize("tree", ["port", "port_unrepaired", "reference"])
def test_shared_rules_match_the_reference_on_whole_trees(tree, tmp_path):
    rules = ["RA001", "RA004", "RA005"]
    root = {"port": PORT, "reference": ROOT / "src" / "repro"}.get(tree)
    if root is None:
        root = tmp_path / "repro_torch"
        shutil.copytree(PORT, root, ignore=shutil.ignore_patterns("__pycache__"))
        _undo_repairs(root)
    port = _triples(P.run_analysis(root=root, rules=rules))
    assert port == _triples(R.run_analysis(root=root, rules=rules))
    if tree == "port_unrepaired":
        assert {(p, r) for p, _, r in port} == {("checkpoint/manager.py", "RA004"),
                                                ("sz/entropy.py", "RA004")}
    else:
        assert port == set()


# ---------------------------------------------------------------------------
# RA002: register_fake shape rules and autograd.Function bodies
# ---------------------------------------------------------------------------

RA002_BAD = _src("""
    import numpy as np
    import torch

    _COUNT = 0

    @torch.library.custom_op("demo::scale", mutates_args=())
    def scale(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return x * k.item()

    @scale.register_fake
    def _scale_shape(x, k):
        n = int(k.item())
        if k:
            print(n)
        return torch.empty_like(x)

    class Sync(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, scale):
            global _COUNT
            _COUNT += 1
            host = np.asarray(t)
            return t * float(scale), host

        @staticmethod
        def backward(ctx, g, _):
            while g:
                g = g.cpu()
            return g.tolist(), None
""")

RA002_CLEAN = _src("""
    import torch
    from torch.autograd import Function

    def eager(x):
        if x:
            print(x.item())
        return x

    @torch.library.register_fake("demo::pair")
    def _pair_shape(x, edges):
        if x.ndim == 3 and edges.shape[0] > 1 and x.dtype == torch.float32:
            return torch.empty(x.shape, dtype=torch.int32, device=x.device)
        return torch.empty(edges.shape[0] - 1, dtype=torch.int32, device=x.device)

    class Reshape(Function):
        @staticmethod
        def forward(ctx, t, shape):
            ctx.shape = t.shape
            if ctx.needs_input_grad[0]:
                ctx.mark_dirty(t)
            return t.reshape(shape)

        @staticmethod
        def backward(ctx, g):
            if g is None:
                return None, None
            scale = torch.tensor(ctx.shape[0] ** 0.5, dtype=g.dtype).item()
            return (g * scale).reshape(ctx.shape), None
""")


def test_ra002_flags_host_work_in_shape_rules_and_autograd_functions():
    findings = P.analyze_source(RA002_BAD, rules=["RA002"])
    got = [(f.line, f.message.split(" (")[0]) for f in findings]
    assert got == [
        (12, "host read k.item() of a traced tensor inside shape rule _scale_shape"),
        (13, "Python-level branch on traced value 'k' inside shape rule _scale_shape"),
        (14, "host side effect print() inside shape rule _scale_shape"),
        (20, "global mutation inside autograd.Function Sync.forward"),
        (22, "host read np.asarray(t) of a traced tensor inside autograd.Function "
             "Sync.forward"),
        (23, "host read float(scale) of a traced tensor inside autograd.Function "
             "Sync.forward"),
        (27, "Python-level branch on traced value 'g' inside autograd.Function "
             "Sync.backward"),
        (28, "host read g.cpu() of a traced tensor inside autograd.Function Sync.backward"),
        (29, "host read g.tolist() of a traced tensor inside autograd.Function "
             "Sync.backward"),
    ]


def test_ra002_clean_on_ctx_static_reads_none_tests_and_built_constants():
    """``ctx``, shape/dtype/ndim reads, ``is None`` and a host read of a
    tensor the function built (``models/decoder.py``'s
    ``torch.tensor(c).item()``) stay clean; eager code is out of scope."""
    assert P.analyze_source(RA002_CLEAN, rules=["RA002"]) == []
    decoder = PORT / "models" / "decoder.py"
    text = decoder.read_text()
    assert "torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()" in text
    assert P.analyze_source(text, rel="models/decoder.py", rules=["RA002"]) == []


def test_ra002_register_fake_by_call_and_lambda():
    src = _src("""
        def _rule(x):
            return x.new_empty(int(x))

        op.register_fake(_rule)
        torch.library.register_fake("demo::f", lambda x: x.tolist())
    """)
    assert _pairs(P.analyze_source(src, rules=["RA002"])) == [(2, "RA002"), (5, "RA002")]


# ---------------------------------------------------------------------------
# RA003: the csrc / wrapper / ops / ref / test / card-check triple
# ---------------------------------------------------------------------------

TRIPLE = {
    "pkg/csrc/foo.cu": _src("""
        __global__ void foo_kernel(const float* x) {}

        extern "C" int foo_entry(const void* x, long long n, void* stream) {
          return 0;
        }
    """),
    "pkg/kernels/__init__.py": "",
    "pkg/kernels/_build.py": 'LAUNCHES = {"foo": 0}\n',
    "pkg/kernels/foo.py": _src("""
        from pkg.kernels import _build

        def foo(x):
            _build.launch("foo", "foo", "foo_entry", (), x.data_ptr(), x.numel(), None)
            return x
    """),
    "pkg/kernels/ref.py": "def foo_ref(x):\n    return x\n",
    "pkg/kernels/ops.py": _src("""
        from pkg.kernels import _build, ref
        from pkg.kernels.foo import foo

        def _on_cuda(t):
            return t.is_cuda

        def foo_op(x):
            if _on_cuda(x):
                return foo(x)
            return ref.foo_ref(x)
    """),
    "tests/test_torch_foo.py": "def test_foo_op():\n    foo_op\n",
    "chip_smoke.py": 'KERNELS = {"foo": ("pkg/csrc/foo.cu", "ref.py:1", "foo_kernel")}\n',
}

# piece removed -> (files replaced (None: deleted), words of the one finding)
REMOVALS = {
    "cu_entry": ({"pkg/csrc/foo.cu": None}, "no such extern"),
    "wrapper": ({"pkg/kernels/foo.py": None}, "reached by no kernels/*.py wrapper"),
    "ops_layer": ({"pkg/kernels/ops.py": None}, "no kernels/ops.py dispatch layer"),
    "dispatcher": ({"pkg/kernels/ops.py": "from pkg.kernels import ref\n"},
                   "not imported by kernels/ops.py"),
    "device_choice": ({"pkg/kernels/ops.py": TRIPLE["pkg/kernels/ops.py"].replace(
        "if _on_cuda(x):", "if x.is_cuda:")}, "without _on_cuda"),
    "plain_call": ({"pkg/kernels/ops.py": TRIPLE["pkg/kernels/ops.py"].replace(
        "return ref.foo_ref(x)", "return x")}, "never calls a ref.* plain version"),
    "plain_version": ({"pkg/kernels/ref.py": None}, "kernels/ref.py does not define it"),
    "port_test": ({"tests/test_torch_foo.py": "def test_other():\n    pass\n"},
                  "appears in no tests/test_torch_*.py"),
    "reference_test_only": ({"tests/test_torch_foo.py": None,
                             "tests/test_foo.py": TRIPLE["tests/test_torch_foo.py"]},
                            "no tests/test_torch_*.py found"),
    "launch_counter": ({"pkg/kernels/_build.py": "LAUNCHES = {}\n"},
                       "not a key of kernels/_build.py's LAUNCHES"),
    "card_check": ({"chip_smoke.py": "KERNELS = {}\n"}, "not a key of chip_smoke.py's KERNELS"),
    "card_script": ({"chip_smoke.py": None}, "no chip_smoke.py with a KERNELS table"),
}


def _write_tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel
        if text is None:
            p.unlink()
            continue
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def _ra003(root: Path):
    smoke = root / "chip_smoke.py"
    return P.run_analysis(root=root / "pkg", rules=["RA003"], tests_dir=root / "tests",
                          chip_smoke=smoke if smoke.exists() else None)


def test_ra003_complete_triple_clean(tmp_path):
    assert _ra003(_write_tree(tmp_path, TRIPLE)) == []


@pytest.mark.parametrize("piece", sorted(REMOVALS))
def test_ra003_each_missing_piece_is_one_finding(piece, tmp_path):
    files, words = REMOVALS[piece]
    root = _write_tree(_write_tree(tmp_path, TRIPLE), files)
    findings = _ra003(root)
    assert len(findings) == 1, [f.render() for f in findings]
    assert findings[0].rule == "RA003" and words in findings[0].message


OPS_AS_WRITTEN = _src("""
    import torch

    from pkg.kernels import _build, ref
    from pkg.kernels.foo import foo, foo_workspace

    def _on_cuda(t):
        return t.is_cuda

    def foo_op(x):
        if _on_cuda(x):
            return foo(x)
        return ref.foo_ref(x)

    def foo_delegating_op(x):
        return foo_op(x.reshape(1, -1))[0]

    @torch.library.custom_op("pkg::bar", mutates_args=())
    def _bar(x: torch.Tensor) -> torch.Tensor:
        if _on_cuda(x):
            return foo(x)
        return ref.foo_ref(x)

    @_bar.register_fake
    def _bar_shape(x):
        return torch.empty_like(x)

    def bar_op(x):
        return torch.ops.pkg.bar(x)

    def cumsum_op(x):
        return torch.cumsum(x, 0)
""")


def test_ra003_follows_ops_as_written(tmp_path):
    """A custom op reached through ``torch.ops``, an op that only
    delegates, a size query reached through ``_build._library`` and a
    kernel-free op pass; the helper really is followed: without its
    ``_on_cuda`` the custom op's dispatcher is flagged."""
    files = dict(TRIPLE)
    files["pkg/csrc/foo.cu"] += 'extern "C" long long foo_size(long long n) { return n; }\n'
    files["pkg/kernels/foo.py"] += _src("""

        def foo_workspace(n):
            f = _build._library("foo").foo_size
            return int(f(n))
    """)
    files["pkg/kernels/ops.py"] = OPS_AS_WRITTEN
    files["tests/test_torch_foo.py"] = "foo_op, foo_delegating_op, bar_op\n"
    root = _write_tree(tmp_path, files)
    assert _ra003(root) == []
    ops = root / "pkg" / "kernels" / "ops.py"
    head, tail = OPS_AS_WRITTEN.split("def _bar", 1)
    ops.write_text(head + "def _bar" + tail.replace("if _on_cuda(x):", "if x.is_cuda:", 1))
    findings = _ra003(root)
    assert [(f.line, f.message.split(" ")[0]) for f in findings] == [(27, "bar_op")]
    ops.write_text(OPS_AS_WRITTEN)
    foo = root / "pkg" / "kernels" / "foo.py"
    foo.write_text(foo.read_text().replace('_build._library("foo").foo_size', "None"))
    findings = _ra003(root)
    assert len(findings) == 1 and "foo_size" in findings[0].message


def test_ra003_holds_on_the_port_as_written():
    """On the port's own tree: every entry of ``csrc`` is reached, and the
    dispatchers the rule reads are the ones ``ops.py`` defines."""
    from repro_torch.analysis.parity import KernelParity
    from repro_torch.analysis.engine import ProjectContext

    ctx = ProjectContext(root=PORT)
    entries = KernelParity._entries(ctx)
    assert ("huffman_legacy", "huffman_legacy_workspace") in entries
    assert {e for s, e in entries if s == "lorenzo_quant"} == {"lorenzo_quant_tiles",
                                                              "lorenzo_quant_volume"}
    assert len(entries) == 9
    assert P.run_analysis(root=PORT, rules=["RA003"]) == []


# ---------------------------------------------------------------------------
# engine and the whole tree
# ---------------------------------------------------------------------------


def test_syntax_error_becomes_ra000_and_unknown_rule_raises(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n")
    findings = P.run_analysis(root=tmp_path)
    assert [f.rule for f in findings] == ["RA000"] and "syntax error" in findings[0].message
    with pytest.raises(ValueError, match="RA999"):
        P.run_analysis(root=tmp_path, rules=["RA999"])


def test_port_tree_is_clean_and_fast():
    P.run_analysis(root=PORT, rules=["RA005"])  # imports the registry (and torch) once
    t0 = time.monotonic()
    findings = P.run_analysis()
    elapsed = time.monotonic() - t0
    assert findings == [], "\n".join(f.render() for f in findings)
    assert elapsed < 10.0, f"lint took {elapsed:.1f}s over src/repro_torch"


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.cli lint
# ---------------------------------------------------------------------------


def _lint(capsys, *argv) -> tuple[int, str]:
    try:
        code = cli.main(["lint", *argv])
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _lint_subprocess(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.cli", "lint", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_lint_repo_clean():
    proc = _lint_subprocess("--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["tool"] == "repro_torch.analysis" and doc["clean"] is True
    assert doc["findings"] == [] and Path(doc["root"]) == PORT
    assert doc["rules"] == ["RA001", "RA002", "RA003", "RA004", "RA005"]
    assert doc["files"] == sum(1 for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)


def test_cli_lint_violation_exits_1_with_structured_json(tmp_path, capsys):
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "drift.py").write_text('MAGIC = b"GWTC"\n_VERSION = 3\n')
    code, out = _lint(capsys, "--json", "--root", str(bad))
    assert code == 1, out
    doc = json.loads(out)
    assert doc["clean"] is False and doc["counts"] == {"RA005": 2}
    f = doc["findings"][0]
    assert f["path"] == "drift.py" and f["line"] == 1 and f["rule"] == "RA005"
    assert set(f) == {"path", "line", "rule", "severity", "message"}
    code, out = _lint(capsys, "--root", str(bad), "--rule", "RA005", "--rule", "RA005")
    assert code == 1 and out.splitlines()[0].startswith("drift.py:1: RA005 error:")
    assert out.splitlines()[-1].startswith("2 findings (RA005: 2) in 1 files")


def test_cli_lint_usage_errors_exit_2(tmp_path, capsys):
    proc = _lint_subprocess("--rule", "RA999")
    assert proc.returncode == 2 and "RA999" in proc.stderr
    assert _lint(capsys, "--root", str(tmp_path / "missing"))[0] == 2
    assert _lint(capsys, "--write-baseline")[0] == 2
    assert _lint(capsys, "--baseline", str(tmp_path / "absent.json"))[0] == 2


def test_cli_lint_baseline_roundtrip(tmp_path, capsys):
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "drift.py").write_text('MAGIC = b"SZJX"\n')
    base = tmp_path / "baseline.json"
    assert _lint(capsys, "--root", str(bad), "--baseline", str(base),
                 "--write-baseline")[0] == 0
    assert json.loads(base.read_text())["counts"] == {"RA005": 1}
    code, out = _lint(capsys, "--root", str(bad), "--baseline", str(base))
    assert code == 0, out
    # without the baseline the same tree still fails
    assert _lint(capsys, "--root", str(bad))[0] == 1
