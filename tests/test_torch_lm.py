"""Port parity: the decoder LM (``repro_torch.models``,
``repro_torch.configs``), AdamW's compressed moments, ``warmup_cosine``
and the token pipeline against ``repro`` on the CPU.

Tolerances (measured maxima in brackets):

* float32 models (every ported arch reduced, ``dtype="fp32"``), from
  the reference's init: logits within 2e-5 absolute [4.1e-6 at |logits| up
  to 4.5], loss (with the MoE aux loss) within rtol 1e-6 [2.2e-7], the
  aux loss within rtol 1e-6, each gradient leaf within 2e-5 of its
  largest value [2.2e-6].  XLA:CPU fuses and reorders float
  operations, so float paths are held to tolerances, not bits.
* bfloat16 (the configs' dtype), granite: logits within 8 bfloat16 ulps
  of the largest, 2^-5 max|logits| [1.5 ulps], loss within rtol 2e-3
  [5.7e-4], gradients within 0.05 of each leaf's largest [0.021]: every
  matmul output rounds to bfloat16, and one ulp there moves the rest.
* AdamW with bf16 moments: parameters within 1e-6 + 1e-5 |p| and moments
  within one bfloat16 ulp of the reference's (a float32 moment an ulp
  away may round to the neighbouring bfloat16).  With int8 moments the
  second moment's codes equal the reference's up to a half-integer tie
  (its float32 scale within 1 ulp); the first moment is rounded
  stochastically from the port's own generator, so it is held to its
  property (within one code of the exact moment), not to the reference's
  draws.
* ``warmup_cosine``: within 1 float32 ulp, and equal on >= 99.9% of steps.
* ``TokenPipeline.batch_at``: bit for bit.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.data.tokens import TokenPipeline as RPipe
from repro.data.tokens import TokenPipelineConfig as RPipeCfg
from repro.models import decoder as RD
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw as RA
from repro.optim.schedule import warmup_cosine as ref_warmup_cosine
from repro_torch import configs as PC
from repro_torch import tree
from repro_torch.core.convert import lm_params_from_arrays
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models import attention as PAttn
from repro_torch.models import decoder as PD
from repro_torch.models import mlp as PMlp
from repro_torch.models import ssm as PSsm
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as PA
from repro_torch.optim.schedule import warmup_cosine

CPU = "cpu"
DENSE = ("granite-3-8b", "yi-9b", "gemma3-1b", "llama3-405b", "deepseek-v3-671b",
         "llama4-scout-17b-a16e")  # the attention families (the others: test_torch_lm_families.py)


def _as(cls, obj):
    """A reference config dataclass field for field as the port's ``cls``."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def _port_config(rcfg):
    """A reference ``ModelConfig`` field for field as the port's."""
    fields = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    a = rcfg.attn
    if a is not None:
        fields["attn"] = dataclasses.replace(
            _as(PAttn.AttnConfig, a), mla=None if a.mla is None else _as(PAttn.MLAConfig, a.mla))
    for name, cls in (("moe", PMlp.MoEConfig), ("rwkv", PSsm.RWKV6Config),
                      ("mamba", PSsm.Mamba2Config)):
        if fields[name] is not None:
            fields[name] = _as(cls, fields[name])
    fields["pattern"] = tuple(PD.LayerSpec(**dataclasses.asdict(s)) for s in rcfg.pattern)
    return PD.ModelConfig(**fields)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_build_stages_agrees_on_every_reference_pattern(arch):
    for reduced in (False, True):
        rcfg = RC.get_config(arch, reduced=reduced)
        want = [([dataclasses.asdict(s) for s in st.specs], st.count)
                for st in RD.build_stages(rcfg.pattern)]
        got = [([dataclasses.asdict(s) for s in st.specs], st.count)
               for st in PD.build_stages(_port_config(rcfg).pattern)]
        assert got == want


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_registry_builds_the_dense_family_and_refuses_the_rest(arch):
    """All ten archs build, in the reference's order, with its configs
    (full and reduced) and families: the decoders as ``DecoderLM``, whisper
    as ``EncDecLM``.  (The name is kept from when four were refused.)"""
    from repro_torch.models.encdec import EncDecLM

    assert PC.ARCH_IDS == RC.ARCH_IDS
    pcfg = _port_config(RC.get_config(arch, reduced=True))
    assert PC.get_config(arch, reduced=True) == pcfg
    assert PC.get_config(arch) == _port_config(RC.get_config(arch))
    family = RC.get_family(arch)
    assert PC.get_family(arch) == family == ("encdec" if arch == "whisper-small" else "decoder")
    model, cfg = PC.build_model(arch, reduced=True, device=CPU)
    assert cfg == pcfg
    assert isinstance(model, EncDecLM if family == "encdec" else PD.DecoderLM)


def _paths(ref_tree) -> list[str]:
    """A reference tree's leaf paths, ``/``-joined."""
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]


def _grads(loss, params):
    leaves = [p for _, p in tree.leaves(params)]
    return [g.to(torch.float32).numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("arch,dtype", [(a, "fp32") for a in DENSE] + [("granite-3-8b", "bf16")])
def test_logits_loss_and_gradients_match_the_reference(arch, dtype):
    rcfg = dataclasses.replace(RC.get_config(arch, reduced=True), dtype=dtype)
    pcfg = dataclasses.replace(PC.get_config(arch, reduced=True), dtype=dtype)
    rm, pm = RD.DecoderLM(rcfg), PD.DecoderLM(pcfg, device=CPU)
    rp = rm.init(jax.random.PRNGKey(0))
    pp = lm_params_from_arrays(jax.tree.map(np.asarray, rp), device=CPU)
    for (path, p), r in zip(tree.leaves(pp), jax.tree.leaves(rp)):
        assert p.dtype == pcfg.compute_dtype and tuple(p.shape) == r.shape, path
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks, tgts = (rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32) for _ in range(2))
    pos = np.arange(S)
    rl = np.asarray(rm.apply(rp, jnp.asarray(toks), jnp.asarray(pos))[0], np.float32)
    (rloss, raux), rg = jax.value_and_grad(
        lambda p: rm.loss(p, jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(pos)),
        has_aux=True)(rp)
    for _, p in tree.leaves(pp):
        p.requires_grad_(True)
    pl = pm.apply(pp, torch.from_numpy(toks), torch.from_numpy(pos))[0]
    assert pl.dtype == pcfg.compute_dtype and tuple(pl.shape) == (B, S, rcfg.vocab)
    ploss, aux = pm.loss(pp, torch.from_numpy(toks), torch.from_numpy(tgts),
                         torch.from_numpy(pos))
    assert float(aux["aux"]) == pytest.approx(float(raux["aux"]), rel=1e-6, abs=0)
    assert (float(aux["aux"]) > 0) == (rcfg.moe is not None)
    pg = _grads(ploss, pp)
    pl, ploss = pl.detach().to(torch.float32).numpy(), ploss.detach()
    if dtype == "fp32":
        np.testing.assert_allclose(pl, rl, rtol=0, atol=2e-5)
        assert float(ploss) == pytest.approx(float(rloss), rel=1e-6)
        gtol = 2e-5
    else:
        np.testing.assert_allclose(pl, rl, rtol=0, atol=2.0**-5 * float(np.abs(rl).max()))
        assert float(ploss) == pytest.approx(float(rloss), rel=2e-3)
        gtol = 0.05
    for g, r in zip(pg, jax.tree.leaves(rg)):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g, r, rtol=0, atol=gtol * float(np.abs(r).max()))


def test_remat_changes_no_bit():
    cfg = dataclasses.replace(PC.get_config("llama3-405b", reduced=True), dtype="fp32")
    on, off = (PD.DecoderLM(dataclasses.replace(cfg, remat=r), device=CPU) for r in (True, False))
    params = on.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    pos = torch.arange(16)
    for _, p in tree.leaves(params):
        p.requires_grad_(True)
    (la, _), (lb, _) = (m.loss(params, toks, toks, pos) for m in (on, off))
    assert torch.equal(la, lb)
    for a, b in zip(_grads(la, params), _grads(lb, params)):
        assert np.array_equal(a, b)


def test_init_tree_is_the_references():
    """Stacked layers on a leading count axis, the reference's keys, shapes
    and dtypes (the draws are the port's own generator's)."""
    cfg = PC.get_config("granite-3-8b", reduced=True)
    pp = PD.DecoderLM(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    rp = RD.DecoderLM(RC.get_config("granite-3-8b", reduced=True)).init(jax.random.PRNGKey(0))
    assert _paths(rp) == ["/".join(k) for k, _ in tree.leaves(pp)]
    for (_, p), r in zip(tree.leaves(pp), jax.tree.leaves(rp)):
        assert tuple(p.shape) == r.shape and str(p.dtype).removeprefix("torch.") == str(r.dtype)
    assert "lm_head" not in pp and pp["stage0"][0]["attn"]["wq"].shape[0] == cfg.n_layers


def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": rng.normal(0, 1, (5, 7)).astype(np.float32),
         "b": {"c": rng.normal(0, 1, (3,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda v: rng.normal(0, 1, v.shape).astype(np.float32), p)
             for _ in range(12)]
    return p, grads


def _t(tree_):
    return tree.rebuild(tree_, lambda _, v: torch.from_numpy(np.array(v)))


@pytest.mark.parametrize("param_dtype", ["fp32", "bf16"])
def test_adamw_bf16_moments_match_the_reference(param_dtype):
    p, grads = _adam_inputs()
    if param_dtype == "bf16":
        p = jax.tree.map(lambda v: v.astype(ml_dtypes.bfloat16), p)
    rcfg = RAdamWConfig(weight_decay=0.1, moment_dtype="bf16")
    pcfg = AdamWConfig(weight_decay=0.1, moment_dtype="bf16")
    rp = jax.tree.map(jnp.asarray, p)
    rs = RA.init(rp, rcfg)
    pp = lm_params_from_arrays(p, device=CPU)
    ps = PA.init(pp, pcfg)
    assert ps["m"]["a"].dtype == torch.bfloat16
    for i, g in enumerate(grads):
        rp, rs = RA.update(rp, rs, jax.tree.map(jnp.asarray, g), 3e-2, rcfg)
        PA.update(pp, ps, _t(g), 3e-2, pcfg)
    assert ps["step"] == int(rs["step"]) == len(grads)
    for (path, got), want in zip(tree.leaves(pp), jax.tree.leaves(rp)):
        want = np.asarray(want, np.float32)
        tol = 1e-5 if param_dtype == "fp32" else 2.0**-8  # one bfloat16 ulp of |p|
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=tol, atol=1e-6)
    for name in ("m", "v"):
        for (path, got), want in zip(tree.leaves(ps[name]), jax.tree.leaves(rs[name])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                       np.asarray(want, np.float32), rtol=2.0**-7, atol=1e-30)


def test_adamw_int8_moments_keep_the_references_tree_and_properties():
    p, grads = _adam_inputs(1)
    rcfg, pcfg = RAdamWConfig(moment_dtype="int8"), AdamWConfig(moment_dtype="int8")
    rp = jax.tree.map(jnp.asarray, p)
    rs = RA.init(rp, rcfg)
    pp = lm_params_from_arrays(p, device=CPU)
    ps = PA.init(pp, pcfg)
    for st in (ps["m"], ps["v"]):
        assert st["a"]["q"].dtype == torch.int8 and st["a"]["s"].dtype == torch.float32
        assert st["a"]["s"].shape == () and st["b"]["c"]["q"].shape == (3,)
    assert _paths(rs) == ["/".join(k) for k, _ in tree.leaves(ps)]
    g = grads[0]
    rp, rs = RA.update(rp, rs, jax.tree.map(jnp.asarray, g), 1e-2, rcfg, jax.random.PRNGKey(0))
    rng = np.asarray([0, 7], np.uint32)
    PA.update(pp, ps, _t(g), 1e-2, pcfg, rng)
    for path, q in tree.leaves(ps["v"]):
        rq = np.asarray(tree.get(rs["v"], path[:-1])[path[-1]])
        if path[-1] == "s":
            assert abs(int(np.float32(q).view(np.int32)) - int(rq.view(np.int32))) <= 1
        else:
            assert np.abs(q.numpy().astype(int) - rq.astype(int)).max() <= 1
    # the first moment: stochastic rounding lands within one code of (1 - b1) g
    for path, gl in tree.leaves(g):
        m = tree.get(ps["m"], path)
        exact = np.float32(0.1) * gl / m["s"].numpy()
        assert m["q"].dtype == torch.int8
        assert np.all(np.abs(m["q"].numpy() - exact) < 1.0 + 1e-5)
    # the same key replays the same draws; another key draws others
    again, other = PA.init(_t(p), pcfg), PA.init(_t(p), pcfg)
    PA.update(_t(p), again, _t(g), 1e-2, pcfg, rng)
    PA.update(_t(p), other, _t(g), 1e-2, pcfg, np.asarray([0, 8], np.uint32))
    assert torch.equal(again["m"]["a"]["q"], ps["m"]["a"]["q"])
    assert not torch.equal(other["m"]["a"]["q"], ps["m"]["a"]["q"])


def _rosenbrock_ish(p):
    return ((p["a"] - 1.0) ** 2).sum() + 2.0 * ((p["b"] + 0.5) ** 2).sum()


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16", "int8"])
def test_adamw_converges(moment_dtype):
    """Mirror of ``test_optim.py::test_adamw_converges``."""
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    params = {"a": torch.zeros(4), "b": torch.ones(3)}
    opt = PA.init(params, cfg)
    loss0 = float(_rosenbrock_ish(params))
    for i in range(300):
        for p in params.values():
            p.requires_grad_(True)
        g = torch.autograd.grad(_rosenbrock_ish(params), list(params.values()))
        PA.update(params, opt, dict(zip(params, g)), 0.05, cfg, np.asarray([0, i], np.uint32))
    assert float(_rosenbrock_ish(params)) < loss0 * 0.05


def test_warmup_cosine_matches_in_float32():
    equal = total = 0
    for lr, warm, steps in ((1e-3, 10, 100), (3e-3, 4, 40), (3e-4, 2, 20), (1e-3, 0, 50),
                            (3e-4, 2000, 100_000)):
        ref, port = ref_warmup_cosine(lr, warm, steps), warmup_cosine(lr, warm, steps)
        for s in range(0, min(steps + 5, 3000)):
            a, b = np.float32(ref(s)), np.float32(port(s))
            assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 1, (lr, warm, s)
            equal += bool(a == b)
            total += 1
    assert equal >= 0.999 * total
    w = warmup_cosine(1e-3, 10, 100)
    assert w(0) == pytest.approx(1e-4) and w(100) < w(50)


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 4, 16, 0), (49155, 2, 33, 3)])
def test_token_batches_are_bit_equal(vocab, batch, seq, seed):
    ref = RPipe(RPipeCfg(vocab, batch, seq, seed=seed))
    port = TokenPipeline(TokenPipelineConfig(vocab, batch, seq, seed=seed))
    for step in (0, 1, 12, 39, 1000):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k])


def test_int8_moments_blow_up_where_the_second_moment_underflows_in_both_packages():
    """Known reference behaviour: the int8 second moment is scaled by its
    tensor's absmax, so an entry below 1/254 of the largest is stored as 0;
    when that entry's next gradient is 0 (an embedding row no token of the
    batch touches) its update is m / eps.  Both packages take the same
    step: the reference test's run diverges with int8 moments in both."""
    cfg_r, cfg_p = RAdamWConfig(moment_dtype="int8"), AdamWConfig(moment_dtype="int8")
    rp, pp = {"w": jnp.zeros(2)}, {"w": torch.zeros(2)}
    rs, ps = RA.init(rp, cfg_r), PA.init(pp, cfg_p)
    for i, g in enumerate(([1.0, 0.05], [1.0, 0.0])):
        rp, rs = RA.update(rp, rs, {"w": jnp.asarray(g)}, 1e-2, cfg_r, jax.random.PRNGKey(i))
        PA.update(pp, ps, {"w": torch.tensor(g)}, 1e-2, cfg_p, np.asarray([0, i], np.uint32))
        if i == 0:  # 0.001 * 0.05^2 is 0.32 of the scale's code: stored as 0
            assert int(ps["v"]["w"]["q"][1]) == int(rs["v"]["w"]["q"][1]) == 0
    assert abs(float(pp["w"][1])) > 1e3 and abs(float(rp["w"][1])) > 1e3
    assert abs(float(pp["w"][0])) < 0.1 and abs(float(rp["w"][0])) < 0.1
