"""The plain reference: its Huffman decoder on a hand-made code, its decode
of the program's containers at a small size on the CPU, the Nyx-like
generator, and what the harness and the reference load."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from perfbench import loop as L  # noqa: E402
from perfbench import reference as R  # noqa: E402
from perfbench.reference import container as C  # noqa: E402
from perfbench.reference import huffman  # noqa: E402
from perfbench.reference import nyx  # noqa: E402


def _pack(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def test_huffman_decodes_a_hand_made_canonical_code():
    # alphabet (-1, 0, 5, 7) with lengths (2, 1, 3, 3): canonical codes
    # 0 -> "0", -1 -> "10", 5 -> "110", 7 -> "111"
    alphabet = np.array([-1, 0, 5, 7], np.int32)
    lengths = np.array([2, 1, 3, 3], np.int64)
    symbols = [0, 5, -1, 7, 0, 0, 7]
    code = {0: "0", -1: "10", 5: "110", 7: "111"}
    chunks = [symbols[:4], symbols[4:]]  # chunks of 4 symbols
    bits = ["".join(code[s] for s in ch) for ch in chunks]
    lane = C.HuffmanLane(len(symbols), 4, alphabet, lengths,
                         np.array([len(b) for b in bits], np.int64), _pack("".join(bits)))
    out = huffman.decode_lanes([lane, lane], "cpu")
    assert out.tolist() == [symbols, symbols]


def test_nyx_fields_keep_their_statistics():
    t = nyx.field((32, 32, 32), "temperature", 2**31 + 3, "cpu")
    assert float(t.min()) == pytest.approx(2281.0, rel=1e-4)
    assert float(t.max()) == pytest.approx(4.78e6, rel=1e-4)
    v = nyx.field((32, 32, 32), "velocity_x", 5, "cpu")
    assert float(v.std()) == pytest.approx(2.3e7, rel=1e-3)
    assert torch.equal(v, nyx.field((32, 32, 32), "velocity_x", 5, "cpu"))
    assert not torch.equal(v, nyx.field((32, 32, 32), "velocity_x", 6, "cpu"))


@pytest.mark.parametrize("predictor", ["lorenzo", "interp"])
def test_reference_decodes_the_programs_container(predictor):
    from repro_torch import api

    x = nyx.field((24, 40, 32), "temperature", 11, "cpu")
    vol = api.compress(x, eb=1e-3, tiled=True, tile=(16, 16, 16), predictor=predictor,
                       device="cpu")
    blob = vol.to_bytes()
    d = R.decode(blob, "cpu", x=x)
    assert d.codes_bad == 0 and d.crc_bad == 0
    assert d.eb == R.rel_eb_abs(x, 1e-3)
    assert torch.equal(d.out, torch.from_numpy(np.array(api.from_bytes(blob, device="cpu"))))
    assert L.max_abs(d.sz, x) / d.eb <= 1.0001
    # a flipped lane byte shows in the CRC count
    con = C.parse_gwtc(blob)
    off = blob.index(con.lanes[3]) + 20
    bad = blob[:off] + bytes([blob[off] ^ 1]) + blob[off + 1:]
    assert C.parse_gwtc(bad).crc_bad == 1


def test_reference_enhances_as_the_program_on_the_cpu():
    from repro_torch import api
    from repro_torch.core.trainer import GWLZTrainConfig

    x = nyx.field((32, 32, 32), "velocity_x", 4, "cpu")
    cfg = GWLZTrainConfig(n_groups=3, epochs=1, gate_groups=False)
    blob = api.compress(x, eb=1e-3, tiled=True, tile=(16, 16, 16), predictor="lorenzo",
                        enhance=cfg, device="cpu").to_bytes()
    d = R.decode(blob, "cpu", x=x)
    assert d.model is not None and float(np.abs(d.model["rscale"]).max()) > 0
    port = torch.from_numpy(np.array(api.from_bytes(blob, device="cpu")))
    assert not torch.equal(d.out, d.sz)  # the ungated enhancers move values
    assert L.max_abs(port, d.out) <= 1e-3 * d.eb  # float32 rounding of x + rhat


def _loaded_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    got = _loaded_modules("""
        import json, sys, time
        sys.path.insert(0, ".")
        from perfbench import harness as H
        bench = H.load_json(H.ROOT / "BENCHMARK.json")
        small = {"cfg": {"shape": [16, 16, 16], "tile": [8, 8, 8]}}
        run, kind = H.prepare(bench, "sz-write", 3, 0.05, True, "cpu", small)
        H.execute(bench, run, kind, time.perf_counter())
        for m in bench["end_to_end"] + bench["per_layer"]:
            H._load(H.HERE / "readers" / (m["name"] + ".py"), "r")
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert "repro_torch" in got
    assert not got & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program(tmp_path):
    from repro_torch import api

    x = nyx.field((16, 16, 16), "temperature", 1, "cpu")
    (tmp_path / "c.gwtc").write_bytes(
        api.compress(x, eb=1e-3, tiled=True, tile=(8, 8, 8), device="cpu").to_bytes())
    got = _loaded_modules(f"""
        import json, sys
        sys.path.insert(0, ".")
        from perfbench import reference as R
        d = R.decode(open({str(tmp_path / "c.gwtc")!r}, "rb").read(), "cpu")
        assert d.codes_bad == -1 and d.crc_bad == 0
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert not got & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
