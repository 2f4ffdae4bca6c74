"""Port parity: error-bounded gradient compression
(``repro_torch.optim.grad_compress``) against ``repro.optim.grad_compress``
on the CPU.

Tolerances: the RMS is a reduction whose float32 summation order differs
between the packages (no fixed order reproduces XLA's), so the scale is
held within 4 float32 ulps (measured: at most 3); a code may then round
the other way only where ``(g + err) / scale`` lies within 8 ulps of a
half-integer (none did on these inputs), and everywhere else codes are
equal.  Dequantized gradients and error feedback are held within
``1e-6 * max|g|``, 8 ulps of the largest value.  ``compressed_psum``
over a 2-process gloo group is held to the reference's
``jax.vmap(..., axis_name="i")`` psum on the same two shards with the
same tolerances.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from repro.optim import grad_compress as RGC
from repro_torch.optim import grad_compress as PGC

T = torch.from_numpy


def _ulp_diff(a, b) -> int:
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def _codes_agree(pc, rc, ratio) -> None:
    """Codes equal, except where the scaled value sits within 8 ulps of a
    half-integer (a tie the scale's last ulps decide)."""
    pc, rc = np.asarray(pc, np.int64), np.asarray(rc, np.int64)
    frac = np.abs(ratio - np.floor(ratio) - 0.5)
    tie = frac <= 8 * np.spacing(np.abs(ratio).astype(np.float32))
    assert np.all((pc == rc) | tie), np.flatnonzero((pc != rc) & ~tie)[:10]
    assert np.abs(pc - rc).max(initial=0) <= 1


@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
@pytest.mark.parametrize("shape,rel_eb,with_err", [((128,), 1e-2, False), ((7, 33), 0.1, True),
                                                   ((3, 5, 64), 0.5, True)])
def test_quantize_leaf_matches_the_reference(shape, rel_eb, with_err, code_dtype):
    rng = np.random.default_rng(sum(shape))
    g = rng.normal(size=shape).astype(np.float32)
    e = (rng.normal(size=shape) * 0.3 if with_err else np.zeros(shape)).astype(np.float32)
    cfg_r = RGC.GradCompressConfig(rel_eb=rel_eb, code_dtype=code_dtype)
    cfg_p = PGC.GradCompressConfig(rel_eb=rel_eb, code_dtype=code_dtype)
    rc, rs, re = (np.asarray(a) for a in RGC.quantize_leaf(jnp.asarray(g), jnp.asarray(e), cfg_r))
    pc, ps, pe = PGC.quantize_leaf(T(g), T(e), cfg_p)
    assert pc.dtype == getattr(torch, code_dtype) and str(rc.dtype) == code_dtype
    assert pe.dtype == torch.float32 and ps.shape == ()
    assert _ulp_diff(ps, rs) <= 4
    _codes_agree(pc.numpy(), rc, (g + e) / np.float32(rs))
    np.testing.assert_allclose(pe.numpy(), re, rtol=0, atol=1e-6 * float(np.abs(g + e).max()))


def test_quantize_leaf_error_bound():
    """Mirror of ``test_optim.py::test_quantize_leaf_error_bound``."""
    g = np.random.default_rng(0).normal(size=128).astype(np.float32)
    cfg = PGC.GradCompressConfig(rel_eb=1e-2, code_dtype="int16")
    codes, scale, new_err = PGC.quantize_leaf(T(g), torch.zeros(128), cfg)
    ghat = codes.to(torch.float32) * scale
    eb = 1e-2 * float(np.sqrt(np.mean(g.astype(np.float64) ** 2)))
    assert float((ghat - T(g)).abs().max()) <= eb * (1 + 1e-4)
    torch.testing.assert_close(new_err, T(g) - ghat, rtol=0, atol=0)


@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_ef_residual_bounded_property(code_dtype):
    """Mirror of ``test_optim_properties.py::test_ef_residual_bounded_property``
    over 20 numpy seeds (hypothesis is not needed), against the reference."""
    bound = 127 if code_dtype == "int8" else 32767
    for seed in range(20):
        g = np.random.default_rng(seed).normal(size=64).astype(np.float32)
        cfg = PGC.GradCompressConfig(rel_eb=0.1, code_dtype=code_dtype)
        codes, scale, new_err = PGC.quantize_leaf(T(g), torch.zeros(64), cfg)
        assert int(codes.to(torch.int32).abs().max()) <= bound
        ghat = codes.to(torch.float32) * scale
        np.testing.assert_allclose(new_err.numpy(), g - ghat.numpy(), atol=1e-6)
        rc, rs, _ = RGC.quantize_leaf(jnp.asarray(g), jnp.zeros(64),
                                      RGC.GradCompressConfig(rel_eb=0.1, code_dtype=code_dtype))
        assert _ulp_diff(scale, rs) <= 4
        _codes_agree(codes.numpy(), np.asarray(rc), g / np.float32(rs))


def test_clipped_mass_goes_into_the_error_feedback():
    """At the int8 bound the clipped part of a spike is kept as error, in
    both packages."""
    g = np.full(256, 1e-3, np.float32)
    g[7] = 50.0  # far past 127 grid steps of the RMS-relative eb
    cfg = PGC.GradCompressConfig(rel_eb=1e-2, code_dtype="int8")
    pc, ps, pe = PGC.quantize_leaf(T(g), torch.zeros(256), cfg)
    rc, rs, re = RGC.quantize_leaf(jnp.asarray(g), jnp.zeros(256),
                                   RGC.GradCompressConfig(rel_eb=1e-2, code_dtype="int8"))
    assert int(pc[7]) == int(rc[7]) == 127
    assert float(pe[7]) == pytest.approx(50.0 - 127 * float(ps), rel=1e-6)
    np.testing.assert_allclose(pe.numpy(), np.asarray(re), rtol=1e-6, atol=1e-9)


def test_apply_matches_the_reference_on_a_tree():
    rng = np.random.default_rng(5)
    grads = {"w": rng.normal(size=(4, 9)).astype(np.float32),
             "b": rng.normal(size=(9,)).astype(np.float32) * 1e-3}
    cfg_r, cfg_p = RGC.GradCompressConfig(rel_eb=0.05), PGC.GradCompressConfig(rel_eb=0.05)
    r_ef, p_ef = RGC.init_ef(grads), PGC.init_ef({k: T(v) for k, v in grads.items()})
    assert all(v.dtype == torch.float32 and not v.any() for v in p_ef.values())
    for _ in range(3):  # error feedback carried across steps
        rg, r_ef = RGC.apply({k: jnp.asarray(v) for k, v in grads.items()}, r_ef, cfg_r)
        pg, p_ef = PGC.apply({k: T(v) for k, v in grads.items()}, p_ef, cfg_p)
        for k in grads:
            scale = float(np.abs(np.asarray(rg[k])).max())
            np.testing.assert_allclose(pg[k].numpy(), np.asarray(rg[k]), rtol=0,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(p_ef[k].numpy(), np.asarray(r_ef[k]), rtol=0,
                                       atol=1e-6 * scale)
    off = PGC.GradCompressConfig(enabled=False)
    same, ef = PGC.apply({"w": T(grads["w"])}, None, off)
    assert ef is None and torch.equal(same["w"], T(grads["w"]))


def test_error_feedback_makes_sgd_converge():
    """Mirror of ``test_optim.py::test_error_feedback_makes_sgd_converge``:
    heavily quantized SGD converges with error feedback; the port's
    trajectory follows the reference's."""
    target = np.asarray([1.0, 2.0], np.float32)
    cfg = PGC.GradCompressConfig(rel_eb=0.5, code_dtype="int8")
    cur = {"w": torch.tensor([5.0, -3.0])}
    ef = PGC.init_ef(cur)
    rcur = {"w": jnp.asarray([5.0, -3.0])}
    ref = RGC.init_ef(rcur)
    rcfg = RGC.GradCompressConfig(rel_eb=0.5, code_dtype="int8")
    for _ in range(400):
        gq, ef = PGC.apply({"w": 2 * (cur["w"] - T(target))}, ef, cfg)
        cur = {"w": cur["w"] - 0.05 * gq["w"]}
        rq, ref = RGC.apply({"w": 2 * (rcur["w"] - jnp.asarray(target))}, ref, rcfg)
        rcur = {"w": rcur["w"] - 0.05 * rq["w"]}
    np.testing.assert_allclose(cur["w"].numpy(), target, atol=0.05)
    np.testing.assert_allclose(cur["w"].numpy(), np.asarray(rcur["w"]), atol=1e-4)


def _psum_worker(rank: int, init_file: str, shards: np.ndarray, errs: np.ndarray,
                 code_dtype: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    try:
        cfg = PGC.GradCompressConfig(rel_eb=0.05, code_dtype=code_dtype)
        g, e = PGC.compressed_psum(T(shards[rank]), T(errs[rank]), dist.group.WORLD, cfg)
        np.savez(f"{out}_{rank}.npz", g=g.numpy(), e=e.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("code_dtype", ["int8", "int16"])
def test_compressed_psum_over_two_gloo_ranks_matches_the_vmapped_psum(tmp_path, code_dtype):
    rng = np.random.default_rng(11)
    shards = rng.normal(size=(2, 6, 40)).astype(np.float32)
    shards[1] *= 1.7  # the two shards' RMS (and scales) differ
    errs = (rng.normal(size=(2, 6, 40)) * 0.01).astype(np.float32)
    mp.spawn(_psum_worker, nprocs=2, join=True,
             args=(str(tmp_path / "pg"), shards, errs, code_dtype, str(tmp_path / "out")))
    cfg = RGC.GradCompressConfig(rel_eb=0.05, code_dtype=code_dtype)
    rg, re = jax.vmap(lambda g, e: RGC.compressed_psum(g, e, "i", cfg), axis_name="i")(
        jnp.asarray(shards), jnp.asarray(errs))
    rg, re = np.asarray(rg), np.asarray(re)
    assert np.array_equal(rg[0], rg[1])  # every shard holds the mean
    for rank in range(2):
        got = np.load(tmp_path / f"out_{rank}.npz")
        scale = float(np.abs(rg[rank]).max())
        np.testing.assert_allclose(got["g"], rg[rank], rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got["e"], re[rank], rtol=0,
                                   atol=1e-6 * float(np.abs(shards[rank]).max()))
