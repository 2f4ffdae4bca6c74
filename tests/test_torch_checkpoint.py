"""Port parity: checkpoints (``repro_torch.checkpoint``), the restart loop
and elastic restore (``repro_torch.runtime``) against ``repro.checkpoint``
and ``repro.runtime`` on the CPU.

Exact leaves are held bit for bit across packages.  Compressed leaves are
held to ``eb = rel_eb * range`` times ``1 + 1e-5`` (the reference test's
factor) plus one float32 ulp of max|x|: the interp predictor's coarse grid
is Lorenzo-coded, and its dequantization ``2eb * q`` rounds to float32, so
in both packages a point may land past eb by a fraction of an ulp of |x|
(``test_coarse_grid_passes_eb_by_float32_rounding_in_both_packages``).
Across packages the interp decode's float32 arithmetic differs (ROADMAP.md
Queue 3), so the bound gains 8 float32 ulps of max|x|, the port's stated
interp tolerance.  A bfloat16 leaf is decoded in float32 and then rounded
to bfloat16, which adds half a bfloat16 ulp of the decoded value (at most
2^-8 of |x| + eb).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as rck
from repro import runtime as rrt
from repro_torch.checkpoint import CheckpointManager, compress_tensor, decompress_tensor
from repro_torch.runtime import (
    FailureInjector,
    HeartbeatMonitor,
    ResilientLoop,
    plan_remesh,
    reshard_restore,
)

CPU = "cpu"
REL_EB = 1e-4
ULPS = 8 * 2.0**-23


def _bound(x: np.ndarray, *, cross: bool = False, bf16: bool = False, rel_eb=REL_EB,
           enhanced: bool = False):
    """Elementwise error bound of a compressed leaf ``x`` (float32 values).
    ``enhanced``: the GWLZ branch where the gate kept a group, whose clamp
    to the SZ decode +- eb doubles the bound and rounds once more."""
    x = np.asarray(x, np.float64)
    eb = rel_eb * float(np.float32(x.max()) - np.float32(x.min()))
    top = float(np.abs(x).max())
    k = 2 if enhanced else 1
    bound = k * (eb * (1 + 1e-5) + 2.0**-23 * top) + (ULPS * top if cross else 0.0)
    if bf16:
        bound = bound + 2.0**-8 * (np.abs(x) + eb)
    return bound


def _within(got, want, **kw) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(np.all(np.abs(got - want) <= _bound(want, **kw)))


def _f32(t) -> np.ndarray:
    """A leaf of either package as float32 numpy (bfloat16 widened)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def arrays():
    """One state's values as numpy (bfloat16 as float32 values that are
    exactly representable in bfloat16)."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(320, 256)).astype(ml_dtypes.bfloat16).astype(np.float32)
    return {"w": rng.normal(size=(32, 16)).astype(np.float32), "b": np.zeros(16, np.float32),
            "big": rng.normal(size=(512, 256)).astype(np.float32), "emb": emb,
            "small_bf16": rng.normal(size=(8, 4)).astype(ml_dtypes.bfloat16).astype(np.float32),
            "layer0": rng.normal(size=(6,)).astype(np.float32),
            "layer1": rng.normal(size=(3, 2)).astype(np.float32)}


def _port_state(a: dict) -> dict:
    t = torch.from_numpy
    return {"params": {"w": t(a["w"]), "b": t(a["b"]), "big": t(a["big"]),
                       "emb": t(a["emb"]).to(torch.bfloat16),
                       "small_bf16": t(a["small_bf16"]).to(torch.bfloat16)},
            "layers": [t(a["layer0"]), {"k": t(a["layer1"])}], "step": torch.tensor(7)}


def _ref_state(a: dict) -> dict:
    j = jnp.asarray
    return {"params": {"w": j(a["w"]), "b": j(a["b"]), "big": j(a["big"]),
                       "emb": j(a["emb"], jnp.bfloat16),
                       "small_bf16": j(a["small_bf16"], jnp.bfloat16)},
            "layers": [j(a["layer0"]), {"k": j(a["layer1"])}], "step": j(7)}


COMPRESSED = ("params/big", "params/emb")  # >= 65536 elements, float32 / bfloat16


def _ref_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(k.key) if isinstance(k, jax.tree_util.DictKey) else str(k.idx)
                       for k in path)
        out[key] = np.asarray(leaf)
    return out


def _port_leaves(tree) -> dict:
    from repro_torch.checkpoint.manager import _leaves

    return dict(_leaves(tree))


def _manifest(d, step) -> dict:
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoints_cross_packages(tmp_path, arrays, writer):
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(pdir, async_save=False, gwlz_rel_eb=REL_EB, device=CPU).save(
        3, _port_state(arrays))
    rck.CheckpointManager(str(rdir), async_save=False, gwlz_rel_eb=REL_EB).save(
        3, _ref_state(arrays))
    pm, rm = _manifest(pdir, 3), _manifest(rdir, 3)
    assert list(pm["keys"]) == list(rm["keys"])  # same keys, same order
    assert pm["gwlz"] == rm["gwlz"] == {k: True for k in COMPRESSED}
    # the port names int64 what the reference (jax x64 off) stores as int32
    assert {k: v for k, v in pm["keys"].items() if k != "step"} == \
        {k: v for k, v in rm["keys"].items() if k != "step"}
    assert (pm["keys"]["step"], rm["keys"]["step"]) == (
        {"shape": [], "dtype": "int64"}, {"shape": [], "dtype": "int32"})
    assert sorted(os.listdir(pdir / "step_00000003")) == sorted(
        os.listdir(rdir / "step_00000003"))

    src = pdir if writer == "port" else rdir
    port = CheckpointManager(src, device=CPU).restore(_port_state(arrays))
    ref = rck.CheckpointManager(str(src)).restore(_ref_state(arrays))
    got_p, got_r = _port_leaves(port), _ref_leaves(ref)
    assert list(got_p) == list(got_r)
    for key, want in _port_leaves(_port_state(arrays)).items():
        bf16 = want.dtype == torch.bfloat16
        assert got_p[key].dtype == want.dtype and got_p[key].device.type == CPU
        p, r, w = _f32(got_p[key]), _f32(got_r[key]), _f32(want)
        if key in COMPRESSED:
            same = writer == "port"
            assert _within(p, w, cross=not same, bf16=bf16), key
            assert _within(r, w, cross=same, bf16=bf16), key
        else:
            np.testing.assert_array_equal(p, w)
            np.testing.assert_array_equal(r, w)
    assert got_r["step"].dtype == np.int32 and int(got_r["step"]) == 7


def test_reference_restores_an_int64_leaf_as_int32(tmp_path):
    """Known reference behaviour: with jax's x64 off an int64 target is an
    int32 array, so the reference hands back int32; the port keeps int64."""
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, {"step": torch.tensor(2**40 + 5)})
    assert int(m.restore({"step": torch.tensor(0)})["step"]) == 2**40 + 5
    r = rck.CheckpointManager(str(tmp_path)).restore({"step": jnp.asarray(0)})
    assert r["step"].dtype == np.int32 and int(r["step"]) == 5  # the top bits are gone


@pytest.mark.parametrize("shape,dtype", [((200, 96), "float32"), ((4, 30, 40), "float32"),
                                         ((70000,), "float32"), ((2, 3, 40, 50), "float32"),
                                         ((300, 64), "bfloat16")])
def test_gwck_blobs_cross_both_ways(shape, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        port_in, ref_in = torch.from_numpy(x).to(torch.bfloat16), x.astype(ml_dtypes.bfloat16)
    else:
        port_in, ref_in = torch.from_numpy(x), x
    bf16 = dtype == "bfloat16"
    pblob, rblob = compress_tensor(port_in, device=CPU), rck.compress_tensor(ref_in)
    assert pblob[:4] == rblob[:4] == b"GWCK"
    head = 6 + len(dtype) + 8 * len(shape)
    assert pblob[:head] == rblob[:head]  # the same GWCK header
    p_of_p = decompress_tensor(pblob, device=CPU)
    p_of_r = decompress_tensor(rblob, device=CPU)
    r_of_p, r_of_r = rck.decompress_tensor(pblob), rck.decompress_tensor(rblob)
    for got in (p_of_p, p_of_r):
        assert got.dtype == port_in.dtype and tuple(got.shape) == shape
    for got in (r_of_p, r_of_r):
        assert str(got.dtype) == dtype and got.shape == shape
    assert _within(_f32(p_of_p), x, bf16=bf16)
    assert _within(_f32(r_of_r), x, bf16=bf16)
    assert _within(_f32(p_of_r), x, cross=True, bf16=bf16)
    assert _within(_f32(r_of_p), x, cross=True, bf16=bf16)
    assert len(pblob) < x.size * (2 if bf16 else 4)  # it compresses


def test_rank_fold_lets_a_2d_leaf_take_the_gwlz_branch():
    """The reference's GWLZ branch raises on a 2-D leaf; the port sends a
    leaf of rank below 3 down the SZ branch at any size (no rank fold: the
    fold cost a 4096 x 4096 leaf its ratio on the card), keeps the shape in
    the header, and the reference decodes the blob within the bound."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    kw = dict(enhance_threshold=0, epochs=1)
    with pytest.raises(ValueError, match="axis 3 is out of bounds"):
        rck.compress_tensor(w, rel_eb=REL_EB, **kw)
    blob = compress_tensor(torch.from_numpy(w), rel_eb=REL_EB, device=CPU, **kw)
    from repro.sz.szjax import SZCompressed

    head = 6 + len("float32") + 8 * 2
    art = SZCompressed.from_bytes(blob[head:])
    assert "gwlz" not in art.extras and tuple(art.shape) == (64, 96)
    assert blob == compress_tensor(torch.from_numpy(w), rel_eb=REL_EB, device=CPU,
                                   enhance_threshold=w.size + 1)  # the SZ branch's bytes
    mine = decompress_tensor(blob, device=CPU)
    assert tuple(mine.shape) == (64, 96) and mine.dtype == torch.float32
    assert _within(_f32(mine), w)
    theirs = rck.decompress_tensor(blob)
    assert theirs.shape == (64, 96) and _within(theirs, w, cross=True)
    # rank 1 takes the SZ branch the same way
    v = rng.normal(size=(700,)).astype(np.float32)
    one = compress_tensor(v, rel_eb=REL_EB, device=CPU, **kw)
    assert "gwlz" not in SZCompressed.from_bytes(one[6 + len("float32") + 8:]).extras
    assert _within(_f32(decompress_tensor(one, device=CPU)), v)


def test_gwlz_branch_where_groups_are_kept_is_held_to_twice_eb(monkeypatch):
    """Known reference behaviour: the GWLZ branch clamps the enhanced value
    to the SZ decode +- eb, so where the gate keeps a group a point may land
    up to 2 eb from the input, in both packages.  No small leaf trained for
    a few epochs makes the gate keep a group, so the gate is turned off in
    both packages' ``compress_tensor``: every group with enough pixels
    applies its (one-epoch) enhancer, and only the clamp holds the error."""
    import functools

    from repro.checkpoint import gwlz_ckpt as rgc

    from repro_torch.checkpoint import gwlz_ckpt
    from repro_torch.core.pipeline import deserialize_model
    from repro_torch.data import nyx_like_field
    from repro_torch.sz.szjax import SZCompressed

    monkeypatch.setattr(gwlz_ckpt, "GWLZTrainConfig",
                        functools.partial(gwlz_ckpt.GWLZTrainConfig, gate_groups=False))
    monkeypatch.setattr(rgc, "GWLZTrainConfig",
                        functools.partial(rgc.GWLZTrainConfig, gate_groups=False))
    x = nyx_like_field((16, 32, 32), "temperature", seed=3)
    x = x / np.float32(np.abs(x).max())
    kw = dict(rel_eb=1e-2, enhance_threshold=0, epochs=1, n_groups=4)
    head = 6 + len("float32") + 8 * 3
    blob = compress_tensor(torch.from_numpy(x), device=CPU, **kw)
    art = SZCompressed.from_bytes(blob[head:])
    eb = art.eb_abs
    assert int((deserialize_model(art.extras["gwlz"], device=CPU).rscale > 0).sum()) > 0
    mine = _f32(decompress_tensor(blob, device=CPU))
    assert _within(mine, x, rel_eb=1e-2, enhanced=True)
    assert np.abs(mine - x).max() > eb * (1 + 1e-5)  # past the SZ bound, as the clamp allows
    assert _within(rck.decompress_tensor(blob), x, rel_eb=1e-2, enhanced=True, cross=True)
    rblob = rck.compress_tensor(x, **kw)
    rart = SZCompressed.from_bytes(rblob[head:])
    assert int((deserialize_model(rart.extras["gwlz"], device=CPU).rscale > 0).sum()) > 0
    assert _within(_f32(decompress_tensor(rblob, device=CPU)), x, rel_eb=1e-2, enhanced=True,
                   cross=True)


def test_coarse_grid_passes_eb_by_float32_rounding_in_both_packages():
    """Known reference behaviour: on this 3-D leaf (a 512 x 512 weight with
    a leading axis of 1) the interp SZ of both packages decodes a
    coarse-grid point 7.2e-5 eb past eb, within one float32 ulp of max|x|."""
    from repro.sz.szjax import SZCompressor as RSZ

    from repro_torch.sz.szjax import SZCompressor

    g = torch.Generator().manual_seed(0)
    x = (torch.randn((512, 512), generator=g) * 0.02).reshape(1, 512, 512)
    xn = x.numpy()
    eb = REL_EB * (float(xn.max()) - float(xn.min()))
    port = SZCompressor().compress(x, rel_eb=REL_EB, device=CPU)[1].numpy()
    sz = RSZ()
    ref = np.asarray(sz.decompress(sz.compress(jnp.asarray(xn), rel_eb=REL_EB)[0]))
    for got in (port, ref):
        over = float(np.abs(got - xn).max()) - eb
        assert eb * 1e-5 < over <= 2.0**-23 * float(np.abs(xn).max())


def test_compress_entry_points_need_cuda_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    x = torch.zeros(64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        compress_tensor(x)
    blob = compress_tensor(x, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        decompress_tensor(blob)
    with pytest.raises(RuntimeError, match="CUDA"):  # compressing needs a device at save
        CheckpointManager(tmp_path, gwlz_rel_eb=REL_EB).save(1, {"x": torch.zeros(4)})
    CheckpointManager(tmp_path, async_save=False).save(1, {"x": torch.zeros(4)})  # exact only


def test_corrupt_gwck_header_raises():
    from repro_torch.errors import CorruptContainerError

    with pytest.raises(CorruptContainerError, match="GWCK"):
        decompress_tensor(b"XXXX" + bytes(20), device=CPU)
    with pytest.raises(CorruptContainerError, match="truncated GWCK"):
        decompress_tensor(b"GWCK\x03\x07float32", device=CPU)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


def test_save_restore_exact_and_structure(tmp_path, arrays):
    state = _port_state(arrays)
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(7, state)
    out = m.restore(state)
    assert isinstance(out["layers"], list) and isinstance(out["layers"][1], dict)
    for (k, a), (k2, b) in zip(_port_leaves(state).items(), _port_leaves(out).items()):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b)
    # a tuple stays a tuple; None is an empty subtree, as in jax
    tup = {"pair": (torch.ones(2), torch.zeros(3)), "none": None}
    m.save(8, tup)
    back = m.restore(tup)
    assert isinstance(back["pair"], tuple) and back["none"] is None
    assert list(_manifest(tmp_path, 8)["keys"]) == ["pair/0", "pair/1"]
    with pytest.raises(ValueError, match="shape"):
        m.restore({"pair": (torch.ones(3), torch.zeros(3)), "none": None})


def test_python_numbers_are_leaves_as_numpy_makes_them(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, {"lr": 0.5, "n": 3, "flag": True})
    keys = _manifest(tmp_path, 1)["keys"]
    assert keys == {"flag": {"shape": [], "dtype": "bool"},
                    "lr": {"shape": [], "dtype": "float64"},
                    "n": {"shape": [], "dtype": "int64"}}
    out = m.restore({"lr": 0.0, "n": 0, "flag": False})
    assert float(out["lr"]) == 0.5 and int(out["n"]) == 3 and bool(out["flag"])


def test_async_save_and_gc(tmp_path, arrays):
    state = {"w": torch.from_numpy(arrays["w"])}
    m = CheckpointManager(tmp_path, keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        m.save(s, state)
    m.wait()
    assert m.all_steps() == [3, 4] and m.latest_step() == 4
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    r = rck.CheckpointManager(str(tmp_path / "r"), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        r.save(s, {"w": jnp.asarray(arrays["w"])})
    r.wait()
    assert r.all_steps() == m.all_steps()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_save_snapshots_its_leaves(tmp_path, arrays):
    """The host copy is taken before ``save`` returns: a step that updates a
    CPU leaf in place right after cannot reach the checkpoint."""
    w = torch.from_numpy(arrays["big"].copy())
    want = w.clone()
    gate = threading.Event()
    m = CheckpointManager(tmp_path, async_save=True)
    real = m._write

    def slow_write(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)

    m._write = slow_write
    m.save(1, {"w": w, "n": torch.tensor([1, 2])})
    w.mul_(-3.0)  # the training step's in-place update
    gate.set()
    m.wait()
    out = m.restore({"w": torch.zeros_like(w), "n": torch.zeros(2, dtype=torch.int64)})
    assert torch.equal(out["w"], want) and out["n"].tolist() == [1, 2]


def test_async_save_error_surfaces_at_wait(tmp_path):
    m = CheckpointManager(tmp_path, async_save=True)

    def broken(*a, **kw):
        raise OSError("disk full")

    m._write = broken
    m.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    m.wait()  # reported once
    assert m.all_steps() == []


def test_bfloat16_leaves_round_trip(tmp_path, arrays):
    exact = torch.from_numpy(arrays["small_bf16"]).to(torch.bfloat16)
    big = torch.from_numpy(arrays["emb"]).to(torch.bfloat16)
    m = CheckpointManager(tmp_path, async_save=False, gwlz_rel_eb=REL_EB, device=CPU)
    m.save(1, {"exact": exact, "big": big})
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as npz:
        assert npz["exact"].dtype == np.uint16
        assert np.array_equal(npz["exact"], exact.view(torch.int16).numpy().view(np.uint16))
    out = m.restore({"exact": torch.zeros_like(exact), "big": torch.zeros_like(big)})
    assert out["exact"].dtype == out["big"].dtype == torch.bfloat16
    assert torch.equal(out["exact"], exact)
    assert _within(_f32(out["big"]), arrays["emb"], bf16=True)
    # and into float32 targets: the values, widened
    wide = m.restore({"exact": torch.zeros(8, 4), "big": torch.zeros(320, 256)})
    assert wide["exact"].dtype == torch.float32 and torch.equal(wide["exact"], exact.float())


def test_reshard_restore_onto_the_cpu(tmp_path, arrays):
    m = CheckpointManager(tmp_path, async_save=False)
    state = {"w": torch.from_numpy(arrays["w"]), "step": torch.tensor(3)}
    m.save(5, state)
    m.save(6, {"w": state["w"] * 2, "step": torch.tensor(4)})
    out = reshard_restore(m, state, "cpu", step=5)
    assert out["w"].device.type == CPU and torch.equal(out["w"], state["w"])
    assert torch.equal(reshard_restore(m, state, torch.device("cpu"))["w"], state["w"] * 2)
    meta = torch.zeros(32, 16, device="meta")  # the target's device is overridden
    assert reshard_restore(m, {"w": meta, "step": torch.tensor(0)}, "cpu")["w"].device.type == CPU


# ---------------------------------------------------------------------------
# runtime: the restart loop, heartbeats, remesh
# ---------------------------------------------------------------------------


def _toy_loop(tmp_path, fail_at=None, n=40, every=10, *, in_place=False, async_save=False,
              monitor=None):
    """The reference test's loop on torch tensors; ``in_place`` updates the
    state's tensors in place, as the port's trainer does."""

    def step_fn(s, batch):
        if in_place:
            s["w"].sub_(0.1 * (s["w"] - batch))
            s["step"].add_(1)
            return s, {"w0": float(s["w"][0])}
        w = s["w"] - 0.1 * (s["w"] - batch)
        return {"w": w, "step": s["step"] + 1}, {"w0": float(w[0])}

    def batch_fn(step):
        return torch.full((4,), float(step % 5))

    m = CheckpointManager(tmp_path, async_save=async_save, keep=5)
    loop = ResilientLoop(step_fn, batch_fn, m, ckpt_every=every)
    inj = FailureInjector(fail_at or set())
    state = {"w": torch.ones(4) * 10, "step": torch.tensor(0)}
    return loop.run(state, n, injector=inj, monitor=monitor)


def _ref_toy_loop(tmp_path, fail_at=None, n=40, every=10):
    def step_fn(s, batch):
        w = s["w"] - 0.1 * (s["w"] - batch)
        return {"w": w, "step": s["step"] + 1}, {"w0": float(w[0])}

    m = rck.CheckpointManager(str(tmp_path), async_save=False, keep=5)
    loop = rrt.ResilientLoop(step_fn, lambda step: jnp.full((4,), float(step % 5)), m,
                             ckpt_every=every)
    state = {"w": jnp.ones(4) * 10, "step": jnp.asarray(0)}
    return loop.run(state, n, injector=rrt.FailureInjector(fail_at or set()))


@pytest.mark.parametrize("mode", ["functional", "in_place_async"])
def test_resilient_loop_recovers_exactly(tmp_path, mode):
    kw = dict(in_place=True, async_save=True) if mode == "in_place_async" else {}
    s_clean, log_clean, r0 = _toy_loop(tmp_path / "clean", **kw)
    mon = HeartbeatMonitor(n_workers=1)
    s_fail, log_fail, r1 = _toy_loop(tmp_path / "fail", fail_at={17, 31}, monitor=mon, **kw)
    assert r0 == 0 and r1 == 2
    assert torch.equal(s_clean["w"], s_fail["w"]) and int(s_fail["step"]) == 40
    assert len(log_clean) == 40 and len(log_fail) == 40 + 7 + 1  # replayed 10-16, 30
    assert len(mon._times[0]) == 16  # the window
    r_state, r_log, rr = _ref_toy_loop(tmp_path / "ref", fail_at={17, 31})
    assert rr == 2 and [m["w0"] for m in r_log] == pytest.approx(
        [m["w0"] for m in log_fail], rel=1e-6)
    np.testing.assert_allclose(s_fail["w"].numpy(), np.asarray(r_state["w"]), rtol=1e-6)


def test_resilient_loop_resumes_and_gives_up(tmp_path):
    _toy_loop(tmp_path, n=20)  # leaves steps 10 and 20 behind
    s, log, r = _toy_loop(tmp_path, n=40)
    assert r == 0 and len(log) == 20 and int(s["step"]) == 40  # resumed at 20
    m = CheckpointManager(tmp_path / "x", async_save=False)
    loop = ResilientLoop(lambda s, b: (s, {}), lambda step: None, m, ckpt_every=5,
                         max_restarts=2)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        loop.run({"w": torch.zeros(1)}, 10, injector=FailureInjector({3}, attempts=5))
    # an error that is not a RuntimeError is not retried
    with pytest.raises(KeyError):
        loop.run({"w": torch.zeros(1)}, 10,
                 injector=FailureInjector({1}, exc=lambda s: KeyError(s)))


def test_cold_restart_replays_from_step_zero(tmp_path):
    """A failure before the first checkpoint restarts at step 0 from the
    state as it stands, in both packages."""
    s, log, r = _toy_loop(tmp_path / "p", fail_at={3}, n=6, every=10)
    rs, rlog, rr = _ref_toy_loop(tmp_path / "r", fail_at={3}, n=6, every=10)
    assert r == rr == 1 and len(log) == len(rlog) == 9
    np.testing.assert_allclose(s["w"].numpy(), np.asarray(rs["w"]), rtol=1e-6)


def test_straggler_detection_matches_the_reference():
    mons = (HeartbeatMonitor(n_workers=4, straggler_factor=3.0),
            rrt.HeartbeatMonitor(n_workers=4, straggler_factor=3.0))
    for mon in mons:
        assert mon.stragglers() == []  # not every worker has reported
        for step in range(20):
            for w in range(4):
                mon.beat(w, 1.0 if w != 2 else 10.0)
    assert mons[0].stragglers() == mons[1].stragglers() == [2]
    assert all(len(v) == 16 for v in mons[0]._times.values())


@pytest.mark.parametrize("old,n", [((16, 16), 128), ((16, 16), 100), ((2, 16, 16), 256),
                                   ((4, 8), 7), ((1, 1), 3), ((8, 6), 12)])
def test_plan_remesh_equals_the_reference(old, n):
    assert plan_remesh(old, n) == rrt.plan_remesh(old, n)


def test_port_imports_no_ml_dtypes():
    """bfloat16 goes through torch views: the machine with the card has no
    ml_dtypes."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), path
