"""Port parity: the distributed GWLZ step (``repro_torch.launch.gwlz_dist``)
against ``repro.launch.gwlz_dist`` on the CPU, as
``test_system.py::test_distributed_gwlz_step_runs`` drives it (G = 2, a
16^3 field, batch 4, two steps), from the reference's initial state.

Tolerances (the trainer's, ``test_torch_trainer.py``): per-group losses
within rtol 1e-5, parameters within 1e-6 + 1e-5 |p|, with gradient
compression off and on (the codes agree: no scaled gradient fell within
the scale's last ulps of a half-integer here).  Left out, as there: b1
and the running BN mean, whose true gradient is 0 (BN subtracts the batch
mean after conv1), so both packages feed Adam rounding noise.  The error
feedback, a difference of nearly equal numbers, within 1e-3 of its largest
value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import grouping as RG
from repro.data import nyx_like_field
from repro.launch import gwlz_dist as RD
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import gwlz_nyx
from repro_torch.core.convert import enhancers_from_arrays
from repro_torch.launch import gwlz_dist as PD

CPU = "cpu"
SKIP = ("b1",)  # gradient 0 in exact arithmetic; see the module docstring


def _batch():
    x = np.array(nyx_like_field((16, 16, 16), "temperature", seed=0))
    edges = np.array(RG.compute_edges(jnp.asarray(x), 2))
    return {"x": x[:4], "r": x[:4] * np.float32(1e-3), "edges": edges,
            "rscale": np.ones(2, np.float32) * np.float32(np.abs(x).max() * 1e-3)}


@pytest.mark.parametrize("grad_compress", [False, True])
def test_two_steps_match_the_reference(grad_compress):
    rcfg = RD.DistGWLZConfig(n_groups=2, volume=16, batch_slices=4, grad_compress=grad_compress)
    pcfg = PD.DistGWLZConfig(n_groups=2, volume=16, batch_slices=4, grad_compress=grad_compress)
    rstep, _, _ = RD.make_dist_train_step(rcfg, make_host_mesh())
    rstate = RD.build_state(rcfg)
    enh = enhancers_from_arrays(jax.tree.map(np.asarray, rstate["params"]),
                                jax.tree.map(np.asarray, rstate["bn"]), device=CPU)
    pstate = PD.build_state(pcfg, enhancers=enh, device=CPU)
    assert (pstate["ef"] is None) == (not grad_compress)
    pstep = PD.make_dist_train_step(pcfg, device=CPU)
    batch = _batch()
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(rstep)
    for _ in range(2):
        rstate, rlosses = jstep(rstate, rbatch)
        pstate, plosses = pstep(pstate, batch)
        assert np.isfinite(plosses.numpy()).all()
        np.testing.assert_allclose(plosses.numpy(), np.asarray(rlosses), rtol=1e-5)
    assert int(pstate["opt"]["step"]) == int(rstate["opt"]["step"]) == 2
    for k, p in pstate["params"].items():
        if k in SKIP:
            continue
        want = np.asarray(rstate["params"][k])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pstate["bn"]["var"].numpy(), np.asarray(rstate["bn"]["var"]),
                               rtol=1e-5, atol=1e-6)
    if grad_compress:
        for k, e in pstate["ef"].items():
            want = np.asarray(rstate["ef"][k])
            if k not in SKIP:
                np.testing.assert_allclose(e.numpy(), want, rtol=0,
                                           atol=1e-3 * float(np.abs(want).max()), err_msg=k)


def test_step_assigns_groups_inside_and_sums_every_group():
    """Unlike the enhancer trainer's step, an inactive group (rscale 0)
    still trains: the loss is the plain sum over groups."""
    cfg = PD.DistGWLZConfig(n_groups=2, volume=16, batch_slices=4)
    state = PD.build_state(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    batch = _batch()
    batch["rscale"] = np.asarray([0.0, batch["rscale"][1]], np.float32)
    before = {k: p.detach().clone() for k, p in state["params"].items()}
    _, losses = PD.make_dist_train_step(cfg, device=CPU)(state, batch)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
    assert not torch.equal(state["params"]["w1"][0], before["w1"][0])  # group 0 moved too


def test_gwlz_nyx_config():
    full, small = gwlz_nyx.get_config(), gwlz_nyx.get_config(reduced=True)
    assert (full.n_groups, full.volume, full.batch_slices) == (32, 512, 512)
    assert (small.n_groups, small.volume, small.batch_slices) == (4, 32, 8)
    assert PD.DistGWLZConfig().batch_slices == 64 and gwlz_nyx.FAMILY == "gwlz"
