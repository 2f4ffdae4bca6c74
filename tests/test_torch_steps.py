"""Port parity: the microbatched training step, the prefill step and the
dry run's shape-only inputs (``repro_torch.launch.{steps,shapes}``,
``launch.gwlz_dist.input_specs``) against ``repro`` on the CPU.

Tolerances, every arch reduced in float32 from the reference's init,
AdamW with float32 moments at lr 1e-3:

* the reference's ``make_train_step(..., TrainOptions(microbatch=2),
  mesh=None)`` (``lax.scan`` over two microbatches) and the port's: loss
  within rtol 1e-6 (rwkv6 1e-5, its amplified rounding:
  ``tests/test_torch_lm_families.py``); the first moments after the step,
  0.1 times the microbatch-mean gradients, within 2e-5 of each leaf's
  largest (rwkv6 2e-4, as there) [1.9e-5 at rwkv6's ``wk``]; parameters
  within lr · 2e-3 but for at most one element a leaf or 0.1% of it, and
  within 2 lr everywhere.  A first AdamW step moves a parameter by about
  lr · g / (|g| + 1e-8), so where a gradient is near 0 its float32
  rounding can flip the update's sign (seen: one element of llama4's
  ``we_gate`` off by 1.03e-2 lr, one of rwkv6's 128 ``mu_x`` by 1.81 lr).
* the port's M = 2 against its own M = 1 on the same batch (not MoE,
  whose expert capacity is a microbatch's): the same bounds.
* the prefill step's last-position logits within 2e-5 absolute
  (``tests/test_torch_lm.py``'s logits bound).
* shapes and dtypes of ``input_specs``: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import gwlz_dist as RGD
from repro.launch import shapes as RSHAPES
from repro.launch import steps as RS
from repro.models.decoder import DecoderLM as RDecoder
from repro.models.encdec import EncDecLM as REncDec
from repro_torch import configs as PC
from repro_torch import tree
from repro_torch.core.convert import lm_params_from_arrays
from repro_torch.launch import gwlz_dist as PGD
from repro_torch.launch import shapes as PSHAPES
from repro_torch.launch import steps as PS
from repro_torch.models.decoder import DecoderLM
from repro_torch.models.encdec import EncDecLM
from repro_torch.optim import adamw

CPU = "cpu"
LR = 1e-3
B, S = 4, 16


def _models(arch):
    rcfg = dataclasses.replace(RC.get_config(arch, reduced=True), dtype="fp32")
    pcfg = dataclasses.replace(PC.get_config(arch, reduced=True), dtype="fp32")
    if RC.get_family(arch) == "encdec":
        return REncDec(rcfg), EncDecLM(pcfg, device=CPU), rcfg, pcfg
    return RDecoder(rcfg), DecoderLM(pcfg, device=CPU), rcfg, pcfg


def _batch(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "targets")}
    if cfg.enc_layers:
        out["enc_feats"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    elif cfg.attn is not None and cfg.attn.mrope_sections is not None:
        out["positions"] = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                                     rng.integers(0, S, (B, S)),
                                     rng.integers(0, S, (B, S))], 1).astype(np.int32)
    return out


def _opts(M):
    return dict(lr=LR, warmup=1, total_steps=10, microbatch=M, moment_dtype="fp32")


def _port_step(pm, pcfg, rp, batch, M):
    """One port step from the reference's init -> (loss, parameters, first
    moments)."""
    params = lm_params_from_arrays(jax.tree.map(np.asarray, rp), device=CPU)
    step, adam_cfg = PS.make_train_step(pm, pcfg, PS.TrainOptions(**_opts(M)))
    opt = adamw.init(params, adam_cfg)
    params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                          np.zeros(2, np.uint32))
    return float(m["loss"]), params, opt["m"]


def _close(got, want, mtol, what):
    """Parameter trees (see the module docstring) or moment trees (within
    ``mtol`` of each leaf's largest)."""
    for (path, a), b in zip(tree.leaves(got), want):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        d = np.abs(a - b)
        if what == "m":
            assert d.max() <= mtol * np.abs(b).max(), (path, d.max(), np.abs(b).max())
        else:
            off = int(np.sum(d > 2e-3 * LR))
            assert d.max() <= 2 * LR and off <= max(1, d.size // 1000), (path, d.max(), off)


@pytest.mark.parametrize("arch", ["granite-3-8b", "llama4-scout-17b-a16e", "rwkv6-7b",
                                  "whisper-small"])
def test_microbatched_step_matches_the_references(arch):
    rm, pm, rcfg, pcfg = _models(arch)
    rp = rm.init(jax.random.PRNGKey(0))
    batch = _batch(rcfg)
    rstep, radam = RS.make_train_step(rm, rcfg, RS.TrainOptions(**_opts(2)), mesh=None)
    ropt = RS.adamw_mod.init(rp, radam)
    rnew, rnopt, rmetrics = jax.jit(rstep)(rp, ropt, jax.tree.map(jnp.asarray, batch),
                                           jax.random.PRNGKey(0))
    loss2, pnew, pm2 = _port_step(pm, pcfg, rp, batch, 2)
    ltol, mtol = (1e-5, 2e-4) if arch == "rwkv6-7b" else (1e-6, 2e-5)
    assert loss2 == pytest.approx(float(rmetrics["loss"]), rel=ltol)
    _close(pm2, jax.tree.leaves(rnopt["m"]), mtol, "m")
    _close(pnew, jax.tree.leaves(rnew), mtol, "params")
    if pcfg.moe is None:  # M = 2 against M = 1 on the same batch
        loss1, pone, pm1 = _port_step(pm, pcfg, rp, batch, 1)
        assert loss2 == pytest.approx(loss1, rel=ltol)
        _close(pm2, [t.numpy() for _, t in tree.leaves(pm1)], mtol, "m")
        _close(pnew, [t.detach().numpy() for _, t in tree.leaves(pone)], mtol, "params")


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-vl-7b", "whisper-small"])
def test_prefill_step_matches_the_references(arch):
    rm, pm, rcfg, pcfg = _models(arch)
    rp = rm.init(jax.random.PRNGKey(1))
    batch = _batch(rcfg, seed=1)
    batch.pop("targets")
    want = np.asarray(RS.make_prefill_step(rm, rcfg)(rp, jax.tree.map(jnp.asarray, batch)))
    params = lm_params_from_arrays(jax.tree.map(np.asarray, rp), device=CPU)
    got = PS.make_prefill_step(pm, pcfg)(params, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert tuple(got.shape) == want.shape == (B, rcfg.vocab) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_input_specs_are_the_references(arch):
    for reduced in (False, True):
        for shape in RSHAPES.SHAPES:
            assert PSHAPES.cell_applicable(arch, shape) == RSHAPES.cell_applicable(arch, shape)
            want = RSHAPES.input_specs(arch, shape, reduced=reduced)
            got = PSHAPES.input_specs(arch, shape, reduced=reduced)
            assert dataclasses.asdict(got["cell"]) == dataclasses.asdict(want["cell"])
            assert got.get("ctx") == want.get("ctx")
            assert sorted(got["batch"]) == sorted(want["batch"])
            for k, v in got["batch"].items():
                assert v.is_meta and tuple(v.shape) == want["batch"][k].shape
                assert _dtype(v) == str(want["batch"][k].dtype), (arch, shape, k)


def test_gwlz_input_specs_are_the_references():
    for kw in ({}, {"n_groups": 64, "batch_slices": 16}):
        got = PGD.input_specs(PGD.DistGWLZConfig(**kw))
        want = RGD.input_specs(RGD.DistGWLZConfig(**kw))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.is_meta and tuple(v.shape) == want[k].shape and _dtype(v) == "float32"
