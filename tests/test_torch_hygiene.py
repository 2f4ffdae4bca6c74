"""Port rules that hold for every module of ``repro_torch``:

* it imports neither ``jax`` nor the reference package ``repro`` (nor does
  ``chip_smoke.py``), so it runs where JAX is absent;
* an entry point called without ``device`` runs on CUDA or raises -- it never
  carries on on the CPU;
* no kernel launch sits inside a ``try``: a kernel that fails raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    bad = [(str(p.relative_to(ROOT)), m) for p in _port_sources()
           for m in _imported_modules(p)
           if m and m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_imports_without_jax_in_a_fresh_interpreter():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.sz, repro_torch.exec.writer, repro_torch.data\n"
            "import repro_torch.kernels.ops, repro_torch.core.pipeline\n"
            "import repro_torch.core.convert, repro_torch.optim.schedule\n"
            "import repro_torch.api, repro_torch.cli, repro_torch.exec.cache\n"
            "import repro_torch.exec, repro_torch.runtime.fault\n"
            "import repro_torch.checkpoint, repro_torch.runtime\n"
            "import repro_torch.launch.train, repro_torch.launch.gwlz_dist\n"
            "import repro_torch.configs.gwlz_nyx, repro_torch.optim.grad_compress\n"
            "import repro_torch.models.ssm, repro_torch.models.encdec\n"
            "import repro_torch.launch.serve, repro_torch.analysis\n"
            "from repro_torch.analysis import all_rules\n"
            "assert sorted(all_rules()) == ['RA001', 'RA002', 'RA003', 'RA004', 'RA005']\n"
            "from repro_torch.configs import ARCH_IDS, get_config\n"
            "[get_config(a) for a in ARCH_IDS]\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_without_device_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.sz import compress_tiled, decompress_tiled

    x = np.ones((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_tiled(x, 4, abs_eb=0.1)
    art, _ = compress_tiled(x, 4, abs_eb=0.1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        decompress_tiled(art)


def test_module_constructors_without_device_need_cuda():
    """The enhancer module and its initialisers follow the entry-point rule
    too: without ``device`` they build on the CUDA device or raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.core import enhancer

    for call in (lambda: enhancer.GroupEnhancers(2), lambda: enhancer.init_params(2),
                 lambda: enhancer.init_state(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert enhancer.GroupEnhancers(2, device="cpu").w1.device.type == "cpu"


def test_training_entry_points_without_device_need_cuda():
    """The LM and the distributed GWLZ state follow the entry-point rule."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import build_model
    from repro_torch.launch import gwlz_dist

    cfg = gwlz_dist.DistGWLZConfig(n_groups=2)
    for call in (lambda: build_model("granite-3-8b", reduced=True),
                 lambda: gwlz_dist.build_state(cfg), lambda: gwlz_dist.make_dist_train_step(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model, _ = build_model("granite-3-8b", reduced=True, device="cpu")
    assert model.device.type == "cpu"


def test_no_try_around_kernel_launches():
    kernel_modules = ["ops.py", "lorenzo_quant.py", "group_hist.py", "huffman_encode.py",
                      "huffman_decode.py", "enhancer_fused.py", "_build.py"]
    for name in kernel_modules:
        tree = ast.parse((PORT / "kernels" / name).read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert tries == [], f"kernels/{name} has a try at line(s) {tries}"


def test_dispatch_follows_the_tensor_device(monkeypatch):
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel wrapper or raises, never to ``ref``."""
    from repro_torch.kernels import ops

    calls = []
    monkeypatch.setattr(ops, "lorenzo_quant_tiles", lambda x, eb: calls.append("kernel"))
    monkeypatch.setattr(ops.ref, "lorenzo_quant_tiles_ref", lambda x, eb: calls.append("plain"))
    fake = torch.empty(0, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.lorenzo_quant_tiles_op(fake, 1.0)
    ops.lorenzo_quant_tiles_op(torch.zeros(1, 2), 1.0)
    assert calls == ["plain"]


def test_launch_counters_reset_and_count_only_launches():
    from repro_torch.kernels import ops
    from repro_torch.sz import compress_tiled

    ops.reset_launches()
    compress_tiled(np.ones((8, 8, 8), np.float32), 4, abs_eb=0.1, device="cpu")
    # CPU tensors run the plain versions: no kernel launched, none counted
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}
    assert set(ops.LAUNCHES) == {"lorenzo_quant_tiles", "lorenzo_quant", "symbol_hist",
                                 "huffman_encode", "huffman_decode", "huffman_legacy",
                                 "group_hist", "enhancer_fused"}
