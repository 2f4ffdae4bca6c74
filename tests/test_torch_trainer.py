"""Port parity: optimizer, schedule and the group-wise trainer.

The reference's init is injected into the port (torch cannot reproduce
``jax.random``).  Tolerances:

* AdamW and step_decay: parameters bit-exact on the CPU (same float32
  operations); the moments within 1e-6 relative (XLA fuses their
  multiply-adds; 1e-6 of the largest where a moment cancels).
* train_step: per-group losses within rtol 1e-5 over five steps, parameters
  within 1e-6 + 1e-5 |p|.  Two leaves are left out: b1 and the running BN
  mean.  BN subtracts the batch mean right after conv1, so b1's true
  gradient is 0 and both packages feed Adam rounding noise, which Adam
  scales to +-lr a step; the running mean carries b1.  Neither changes a
  prediction.
* _bn_calibrate: rtol 1e-5 (float64 chunked sums against float32 sums).
* _gate_groups: equal decisions on a case whose margins are clear.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import enhancer as RE
from repro.core import grouping as RG
from repro.core import trainer as RT
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as RA
from repro.optim.schedule import step_decay as ref_step_decay
from repro_torch.core import convert
from repro_torch.core import grouping as PG
from repro_torch.core import trainer as PT
from repro_torch.data import nyx_like_field
from repro_torch.optim import adamw as PA
from repro_torch.optim.schedule import step_decay

G, C = 4, 9
T = lambda a: torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_adamw_and_step_decay_bitexact():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
         "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rstate = RA.init(rp)
    pp = {k: T(v) for k, v in p.items()}
    pstate = PA.init(pp)
    rsched, psched = ref_step_decay(1e-3, 0.5, 7), step_decay(1e-3, 0.5, 7)
    for step in range(20):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in p.items()}
        assert psched(step) == float(rsched(step))
        rp, rstate = RA.update(rp, rstate, {k: jnp.asarray(v) for k, v in g.items()},
                               rsched(step))
        PA.update(pp, pstate, {k: T(v) for k, v in g.items()}, psched(step))
    for k in p:
        np.testing.assert_array_equal(_bits(pp[k]), _bits(rp[k]))
        for mom in ("m", "v"):
            want = np.asarray(rstate[mom][k])
            np.testing.assert_allclose(pstate[mom][k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    assert pstate["step"] == int(rstate["step"]) == 20


def test_adamw_device_scalar_form_is_the_host_step():
    """The captured step's update: the learning rate and the bias
    corrections read from 0-d float32 tensors, the step count left to the
    caller, gives the host-scalar update's bits; int8 moments refuse it."""
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32)}
    host, dev = {k: T(v) for k, v in p.items()}, {k: T(v) for k, v in p.items()}
    hs, ds = PA.init(host), PA.init(dev)
    lr_t, bc1, bc2 = (torch.zeros(()) for _ in range(3))
    for step in range(12):
        g = {k: T(rng.normal(0, 1, v.shape).astype(np.float32)) for k, v in p.items()}
        lr = step_decay(1e-3, 0.5, 5)(step)
        PA.update(host, hs, g, lr)
        ds["step"] += 1
        for t, v in zip((lr_t, bc1, bc2), (lr, *PA.bias_corrections(ds["step"]))):
            t.fill_(v)
        PA.update(dev, ds, g, lr_t, corrections=(bc1, bc2))
    assert ds["step"] == hs["step"] == 12
    for k in p:
        for got, want in ((dev[k], host[k]), (ds["m"][k], hs["m"][k]), (ds["v"][k], hs["v"][k])):
            np.testing.assert_array_equal(_bits(got), _bits(want))
    cfg = PA.AdamWConfig(moment_dtype="int8")
    with pytest.raises(ValueError, match="fp32"):
        PA.update(dev, PA.init(dev, cfg), g, lr_t, cfg, corrections=(bc1, bc2))


@pytest.fixture(scope="module")
def volume():
    x = nyx_like_field((16, 16, 16), "temperature", seed=3)
    r = (np.random.default_rng(0).uniform(-1, 1, x.shape) * 0.01 * np.abs(x).max()
         ).astype(np.float32)
    edges = RG.compute_edges(jnp.asarray(x), G)
    ids = RG.assign_groups(jnp.asarray(x), edges)
    keys = jax.random.split(jax.random.PRNGKey(0), G)
    params = {k: np.asarray(v) for k, v in
              jax.vmap(lambda k: RE.init_params(k, C))(keys).items()}
    return x, r, np.asarray(edges), np.asarray(ids), params


@pytest.mark.parametrize("residual", [True, False])
def test_first_train_steps_track_reference(volume, residual):
    x, r, edges, ids, params = volume
    xs, rs, rids, redges = jnp.asarray(x), jnp.asarray(r), jnp.asarray(ids), jnp.asarray(edges)
    rscale = RT._per_group_scale(rs, rids, G)
    np.testing.assert_array_equal(PT._per_group_scale(T(r), T(ids), G).numpy(), rscale)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rbn = jax.vmap(lambda _: RE.init_state(C))(jnp.arange(G))
    ropt = RA.init(rp, RAdamWConfig())
    enh = convert.enhancers_from_arrays(params, device="cpu")
    popt = PA.init(enh.params())
    for step in range(5):
        idx = np.arange(3 * step, 3 * step + 3)
        rp, rbn, ropt, rl = RT.train_step(
            rp, rbn, ropt, xs[idx], rs[idx], rids[idx], redges, rscale, jnp.float32(1e-3),
            n_groups=G, residual_learning=residual, adam_cfg=RAdamWConfig())
        pl = PT.train_step(enh, popt, T(x[idx]), T(r[idx]), T(ids[idx]), T(edges),
                           T(rscale), 1e-3, n_groups=G, residual_learning=residual)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=1e-5)
    for k in ("b2", "beta", "gamma", "w1", "w2"):
        np.testing.assert_allclose(getattr(enh, k).detach().numpy(), rp[k],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(enh.var.numpy(), rbn["var"], rtol=1e-5)


def test_chunked_bn_calibrate_matches_reference(volume):
    x, _, edges, ids, params = volume
    want = RT._bn_calibrate(params, jnp.asarray(x), jnp.asarray(ids), jnp.asarray(edges),
                            n_groups=G)
    enh = convert.enhancers_from_arrays(params, device="cpu")
    for chunk in (3, None):  # 16 slices in chunks of 3 (last one short), and whole
        mean, var = PT._bn_calibrate(enh.params(), T(x), T(ids), T(edges), n_groups=G,
                                     chunk_slices=chunk)
        np.testing.assert_allclose(mean.numpy(), want["mean"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(var.numpy(), want["var"], rtol=1e-5, atol=1e-7)


def test_gate_decisions_match_reference(volume):
    x, _, edges, ids, params = volume
    enh = convert.enhancers_from_arrays(params, device="cpu")
    mean, var = PT._bn_calibrate(enh.params(), T(x), T(ids), T(edges), n_groups=G)
    enh.load(params, {"mean": mean, "var": var})
    rscale = np.array([1.0, 3.0, 2.0, 1.5], np.float32)
    packed = PT._packed(enh, T(edges), T(rscale))
    pred = PT.ops.enhancer_grouped_op(T(x), T(ids), packed, mode="pred").numpy()
    # groups 2 and 3: the residual IS the enhancer's prediction (plus a little
    # noise), so enhancing helps; groups 0 and 1: an unrelated residual, so it
    # hurts.  (An inactive group, rscale 0, is a tie the reference's float32
    # sums may break either way; its rscale stays 0 whatever the gate says.)
    rng = np.random.default_rng(7)
    r = np.where(ids >= 2, pred * rscale[ids], rng.normal(0, 0.01, x.shape))
    r = (r + rng.normal(0, 1e-3, x.shape)).astype(np.float32)
    rbn = {"mean": jnp.asarray(mean.numpy()), "var": jnp.asarray(var.numpy())}
    want = RT._gate_groups(params, rbn, jnp.asarray(x), jnp.asarray(r), jnp.asarray(ids),
                           jnp.asarray(edges), jnp.asarray(rscale), n_groups=G)
    for chunk in (5, None):
        got = PT._gate_groups(enh, T(x), T(r), T(ids), T(edges), T(rscale), chunk_slices=chunk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0.0, 0.0, 1.0, 1.0]


def test_train_enhancers_with_injected_init_tracks_reference(volume):
    x, r, _, _, params = volume
    cfg_kw = dict(n_groups=G, epochs=2, batch_size=4, min_group_pixels=64)
    rmodel, rhist = RT.train_enhancers(jnp.asarray(x), jnp.asarray(r),
                                       RT.GWLZTrainConfig(**cfg_kw))
    pmodel, phist = PT.train_enhancers(x, r, PT.GWLZTrainConfig(**cfg_kw), params=params,
                                       device="cpu")
    np.testing.assert_array_equal(pmodel.edges.numpy(), np.asarray(rmodel.edges))
    np.testing.assert_array_equal(pmodel.rscale.numpy(), np.asarray(rmodel.rscale))
    np.testing.assert_allclose(phist["loss"], rhist["loss"], rtol=1e-4)
    np.testing.assert_array_equal(phist["gate"], rhist["gate"])
    np.testing.assert_array_equal(phist["lr"], rhist["lr"])


def test_train_step_keeps_tf32_off_through_the_backward(volume, monkeypatch):
    """cuDNN would run the float32 convolutions' gradients in TF32 unless
    the flag is off while autograd runs them, not only in the forward."""
    x, r, edges, ids, params = volume
    seen = []
    real_grad = torch.autograd.grad

    def grad(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_grad(*a, **k)

    monkeypatch.setattr(torch.autograd, "grad", grad)
    enh = convert.enhancers_from_arrays(params, device="cpu")
    PT.train_step(enh, PA.init(enh.params()), T(x[:2]), T(r[:2]), T(ids[:2]), T(edges),
                  torch.ones(G), 1e-3, n_groups=G, residual_learning=True)
    assert seen == [False]


def test_train_step_wrapper_sees_one_call_a_step(volume, monkeypatch):
    """A wrapper of the module-level ``train_step`` (as the benchmark's
    probe wraps it) sees one call a step of train_enhancers' loop, with
    ``opt_state["step"]`` the call's index, and Adam's first moment moved
    once call 0 returns."""
    x, r, _, _, _ = volume
    real, steps, moved = PT.train_step, [], []

    def probed(enh, opt_state, *args, **kwargs):
        steps.append(int(opt_state["step"]))
        losses = real(enh, opt_state, *args, **kwargs)
        if len(steps) == 1:
            moved.append(all(bool(m.abs().sum() > 0) for k, m in opt_state["m"].items()
                             if k != "b1"))
        return losses

    monkeypatch.setattr(PT, "train_step", probed)
    cfg = PT.GWLZTrainConfig(n_groups=G, epochs=1, batch_size=2, min_group_pixels=64)
    PT.train_enhancers(x, r, cfg, device="cpu")
    assert steps == list(range(x.shape[0] // 2)) and moved == [True]
