"""Port parity: LM serving (``repro_torch.models`` attention, MoE, MLA and
decode caches, ``repro_torch.launch.serve``) against ``repro`` on the CPU.

Inputs come from numpy seeds; parameters are the reference's init carried
across by ``core.convert.lm_params_from_arrays``.  Tolerances (float32
unless stated):

* ``attend`` over the four mask modes, windows 0, 4 and 8, softcap off
  and on, banded off and on: within 2e-5 absolute.
* ``apply_moe`` (softmax top-1, sigmoid top-2, a capacity that drops
  tokens): output and aux loss within 2e-5 absolute; the routed expert
  ids equal.
* MLA prefill and absorbed decode, and the GQA ring cache's decode:
  within 2e-5 absolute of the reference's (and the ring's decode of the
  port's full-cache output).
* A reduced model's decode against its own prefill: max relative error
  < 2e-3 (the reference's ``test_decode_matches_prefill`` bound); the
  port's 12 decode steps against the reference's jitted ``decode_step``:
  within 2e-5 · max|logits|.
* gemma3 in bfloat16 (its configs' dtype): logits within 2^-5 max|logits|,
  loss within rtol 2e-3 and gradients within 0.05 of each leaf's largest
  (``tests/test_torch_lm.py``'s bfloat16 case).  The float32 logits, loss
  (with the MoE aux loss) and gradients of the three archs are
  ``tests/test_torch_lm.py::test_logits_loss_and_gradients_match_the_reference``'s
  cases.
* The serving driver's greedy tokens (bfloat16, as the drivers run):
  equal to the reference driver's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as RC
from repro.launch import serve as RServe
from repro.launch.steps import make_decode_step as ref_make_decode_step
from repro.models import attention as RA
from repro.models import decoder as RD
from repro.models import mlp as RM
from repro_torch import configs as PC
from repro_torch import tree
from repro_torch.core.convert import lm_params_from_arrays
from repro_torch.launch import serve as PServe
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention as PA
from repro_torch.models import decoder as PD
from repro_torch.models import mlp as PM

CPU = "cpu"
NEW = ("gemma3-1b", "llama4-scout-17b-a16e", "deepseek-v3-671b")


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _carry(ref_tree):
    return lm_params_from_arrays(jax.tree.map(np.asarray, ref_tree), device=CPU)


def _paths(ref_tree) -> list[str]:
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]


@pytest.mark.parametrize("mode,window", [
    (m, w) for m in (PA.MASK_CAUSAL, PA.MASK_SLIDING, PA.MASK_CHUNKED, PA.MASK_BIDIR)
    for w in (0, 4, 8) if not (m == PA.MASK_CHUNKED and w == 0)])
def test_attend_matches_the_reference(mode, window):
    rng = np.random.default_rng(mode * 10 + window)
    B, S, H, K, D = 2, 16, 4, 2, 8
    q, k, v = (rng.normal(0, 1, (B, S, n, D)).astype(np.float32) for n in (H, K, K))
    pos = np.arange(S, dtype=np.int32)
    for softcap in (0.0, 2.0):
        for banded in (False, True):
            want = RA.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                             jnp.asarray(pos), mask_mode=mode, window=window, q_block=4,
                             softcap=softcap, banded=banded)
            got = PA.attend(_t(q), _t(k), _t(v), _t(pos), _t(pos), mask_mode=mode,
                            window=window, q_block=4, softcap=softcap, banded=banded)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=2e-5,
                                       err_msg=f"softcap {softcap} banded {banded}")


@pytest.mark.parametrize("mode,window,qk_norm", [(PA.MASK_SLIDING, 4, True),
                                                 (PA.MASK_CHUNKED, 4, False)])
def test_ring_cache_equals_full_cache(mode, window, qk_norm):
    """Mirror of ``test_moe_attention.py::test_ring_cache_equals_full_cache_for_sliding``:
    the port's ring decode equals its full-sequence output and the
    reference's ring decode."""
    cfg_kw = dict(n_heads=2, n_kv_heads=1, head_dim=8, d_model=16, qk_norm=qk_norm)
    rcfg, pcfg = RA.AttnConfig(**cfg_kw), PA.AttnConfig(**cfg_kw)
    rp = RA.init_gqa_params(jax.random.PRNGKey(0), rcfg)
    pp = _carry(rp)
    S = 12
    x = np.random.default_rng(1).normal(0, 1, (1, S, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    full, none = PA.gqa_attention(pp, pcfg, _t(x), _t(pos), mask_mode=mode, window=window)
    assert none is None
    ring = PA.init_gqa_cache(1, S, pcfg, window=window, dtype=torch.float32, device=CPU)
    rring = RA.init_gqa_cache(1, S, rcfg, window=window, dtype=jnp.float32)
    assert tuple(ring["k"].shape) == rring["k"].shape == (1, window, 1, 8)
    rstep = jax.jit(lambda c, xt, pt: RA.gqa_attention(rp, rcfg, xt, pt, mask_mode=mode,
                                                       window=window, cache=c))
    outs, routs = [], []
    for t in range(S):
        y, ring = PA.gqa_attention(pp, pcfg, _t(x[:, t:t + 1]), _t(pos[t:t + 1]),
                                   mask_mode=mode, window=window, cache=ring)
        ry, rring = rstep(rring, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[t:t + 1]))
        outs.append(y)
        routs.append(_np(ry))
    got = torch.cat(outs, dim=1).numpy()
    assert int(ring["pos"]) == int(rring["pos"]) == S
    np.testing.assert_allclose(got, full.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, np.concatenate(routs, axis=1), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ring["k"].numpy(), _np(rring["k"]), rtol=0, atol=2e-5)


@pytest.mark.parametrize("router,top_k,cf,shared", [
    ("softmax", 1, 1.25, True),   # llama4-scout's router
    ("sigmoid", 2, 1.25, True),   # deepseek-v3's
    ("softmax", 1, 0.25, False),  # capacity drops most tokens
])
def test_apply_moe_matches_the_reference(router, top_k, cf, shared):
    kw = dict(n_experts=4 if shared else 2, top_k=top_k, d_ff=32, router=router,
              capacity_factor=cf, n_shared=int(shared), shared_d_ff=16 if shared else 0)
    rcfg, pcfg = RM.MoEConfig(**kw), PM.MoEConfig(**kw)
    d = 16
    rp = RM.init_moe_params(jax.random.PRNGKey(0), d, rcfg, "silu")
    pp = _carry(rp)
    x = np.random.default_rng(2).normal(0, 1, (2, 8, d)).astype(np.float32)
    rout, raux = jax.jit(RM.apply_moe, static_argnums=(2, 3))(rp, jnp.asarray(x), rcfg, "silu")
    pout, paux = PM.apply_moe(pp, _t(x), pcfg)
    np.testing.assert_allclose(pout.numpy(), _np(rout), rtol=0, atol=2e-5)
    assert abs(float(paux) - float(raux)) <= 2e-5 and float(paux) > 0
    logits = x.reshape(-1, d) @ np.asarray(rp["router"])
    _, ridx = RM._route(jnp.asarray(logits), rcfg)
    _, pidx = PM._route(_t(logits), pcfg)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(ridx))
    if cf < 1:  # as the reference test: most rows dropped to zero
        assert int((pout[0].abs().sum(-1) < 1e-6).sum()) >= 4


def test_mla_prefill_and_absorbed_decode_match_the_reference():
    kw = dict(q_lora=16, kv_lora=8, rope_dim=4, nope_dim=8, v_dim=8)
    rcfg = RA.AttnConfig(n_heads=2, n_kv_heads=2, head_dim=12, d_model=16,
                         mla=RA.MLAConfig(**kw))
    pcfg = PA.AttnConfig(n_heads=2, n_kv_heads=2, head_dim=12, d_model=16,
                         mla=PA.MLAConfig(**kw))
    rp = RA.init_mla_params(jax.random.PRNGKey(0), rcfg)
    pp = _carry(rp)
    B, S = 2, 10
    x = np.random.default_rng(3).normal(0, 1, (B, S, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    rstep = jax.jit(lambda c, xt, pt: RA.mla_attention(rp, rcfg, xt, pt, cache=c))
    rfull, _ = rstep(None, jnp.asarray(x), jnp.asarray(pos))
    pfull, none = PA.mla_attention(pp, pcfg, _t(x), _t(pos))
    assert none is None
    np.testing.assert_allclose(pfull.numpy(), _np(rfull), rtol=0, atol=2e-5)
    # the latent cache: kv_lora + rope_dim a token, not per head
    assert tuple(PA.init_mla_cache(3, 64, pcfg)["c_kv"].shape) == (3, 64, 8)
    assert tuple(PA.init_mla_cache(3, 64, pcfg)["k_rope"].shape) == (3, 64, 4)
    cache = PA.init_mla_cache(B, 16, pcfg, dtype=torch.float32, device=CPU)
    rcache = RA.init_mla_cache(B, 16, rcfg, dtype=jnp.float32)
    outs = []
    for t in range(S):
        y, cache = PA.mla_attention(pp, pcfg, _t(x[:, t:t + 1]), _t(pos[t:t + 1]), cache=cache)
        ry, rcache = rstep(rcache, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos[t:t + 1]))
        np.testing.assert_allclose(y.numpy(), _np(ry), rtol=0, atol=2e-5, err_msg=f"step {t}")
        outs.append(y)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(), _np(rcache[name]), rtol=0, atol=2e-5)
    assert int(cache["pos"]) == S
    dec = torch.cat(outs, dim=1).numpy()
    assert np.abs(dec - pfull.numpy()).max() / np.abs(pfull.numpy()).max() < 2e-3


def _fp32(arch):
    """The reduced config in float32 without remat, in both packages."""
    rcfg = dataclasses.replace(RC.get_config(arch, reduced=True), dtype="fp32", remat=False)
    pcfg = dataclasses.replace(PC.get_config(arch, reduced=True), dtype="fp32", remat=False)
    return rcfg, pcfg


@pytest.mark.parametrize("arch", NEW)
def test_init_tree_and_caches_are_the_references(arch):
    rcfg, pcfg = RC.get_config(arch, reduced=True), PC.get_config(arch, reduced=True)
    rm, pm = RD.DecoderLM(rcfg), PD.DecoderLM(pcfg, device=CPU)
    rp = jax.eval_shape(rm.init, jax.random.PRNGKey(0))  # shapes and dtypes only
    pp = pm.init(torch.Generator().manual_seed(0))
    rc = jax.eval_shape(lambda: rm.init_cache(2, 16))
    for ref_tree, port_tree in ((rp, pp), (rc, pm.init_cache(2, 16))):
        assert _paths(ref_tree) == ["/".join(k) for k, _ in tree.leaves(port_tree)]
        for (path, p), r in zip(tree.leaves(port_tree), jax.tree.leaves(ref_tree)):
            assert tuple(p.shape) == r.shape, path
            assert str(p.dtype).removeprefix("torch.") == str(r.dtype), path


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_prefill(arch):
    """The reference's ``test_decode_matches_prefill``, on the port."""
    _, pcfg = _fp32(arch)
    pm = PD.DecoderLM(pcfg, device=CPU)
    params = pm.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, pcfg.vocab, (B, S)))
    full, none, _ = pm.apply(params, toks, torch.arange(S))
    assert none is None
    cache = pm.init_cache(B, S, dtype=torch.float32)
    outs = []
    with torch.no_grad():
        for t in range(S):
            lg, cache = pm.decode_step(params, cache, toks[:, t:t + 1], t)
            outs.append(lg)
    dec, full = torch.stack(outs, dim=1), full.detach()
    rel = float((full - dec).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, rel


@pytest.mark.parametrize("arch", NEW)
def test_decode_steps_match_the_references_jitted_decode(arch):
    rcfg, pcfg = _fp32(arch)
    rm, pm = RD.DecoderLM(rcfg), PD.DecoderLM(pcfg, device=CPU)
    rp = rm.init(jax.random.PRNGKey(0))
    pp = _carry(rp)
    B, S, ctx = 2, 12, 16
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    rstep = jax.jit(ref_make_decode_step(rm, rcfg))
    pstep = make_decode_step(pm)
    rcache = rm.init_cache(B, ctx, dtype=jnp.float32)
    pcache = pm.init_cache(B, ctx, dtype=torch.float32)
    with torch.no_grad():
        for t in range(S):
            rl, rcache = rstep(rp, rcache, {"token": jnp.asarray(toks[:, t:t + 1]),
                                            "pos": jnp.asarray(t, jnp.int32)})
            pl, pcache = pstep(pp, pcache, {"token": _t(toks[:, t:t + 1]),
                                            "pos": torch.tensor(t, dtype=torch.int32)})
            rl = _np(rl)
            np.testing.assert_allclose(pl.numpy(), rl, rtol=0,
                                       atol=2e-5 * float(np.abs(rl).max()), err_msg=f"step {t}")
    for (path, p), r in zip(tree.leaves(pcache), jax.tree.leaves(rcache)):
        if path[-1] == "pos":
            assert np.array_equal(p.numpy(), np.asarray(r)), path


def test_gemma3_bf16_with_its_embedding_scale_matches_the_reference():
    """bfloat16 as the config runs: sqrt(1152) = 33.94 is rounded to
    bfloat16 (34.0) before it scales the embedding, in both packages."""
    rcfg, pcfg = RC.get_config("gemma3-1b", reduced=True), PC.get_config("gemma3-1b",
                                                                          reduced=True)
    assert pcfg.emb_scale and pcfg.dtype == "bf16"
    assert float(torch.tensor(1152 ** 0.5, dtype=torch.bfloat16)) == 34.0
    assert float(torch.tensor(pcfg.d_model ** 0.5, dtype=torch.bfloat16)) == float(
        jnp.asarray(rcfg.d_model ** 0.5, jnp.bfloat16))
    rm, pm = RD.DecoderLM(rcfg), PD.DecoderLM(pcfg, device=CPU)
    rp = rm.init(jax.random.PRNGKey(0))
    pp = _carry(rp)
    rng = np.random.default_rng(0)
    B, S = 2, 24
    toks, tgts = (rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32) for _ in range(2))
    pos = np.arange(S)
    rl = _np(rm.apply(rp, jnp.asarray(toks), jnp.asarray(pos))[0])
    (rloss, _), rg = jax.jit(jax.value_and_grad(
        lambda p: rm.loss(p, jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(pos)),
        has_aux=True))(rp)
    leaves = [p.requires_grad_(True) for _, p in tree.leaves(pp)]
    pl, _, _ = pm.apply(pp, _t(toks), _t(pos))
    ploss, _ = pm.loss(pp, _t(toks), _t(tgts), _t(pos))
    assert pl.dtype == torch.bfloat16
    np.testing.assert_allclose(pl.detach().float().numpy(), rl, rtol=0,
                               atol=2.0 ** -5 * float(np.abs(rl).max()))
    assert float(ploss.detach()) == pytest.approx(float(rloss), rel=2e-3)
    for g, r in zip(torch.autograd.grad(ploss, leaves), jax.tree.leaves(rg)):
        r = _np(r)
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=0.05 * float(np.abs(r).max()))


SERVE_ARGS = ["--arch", "gemma3-1b", "--reduced", "--batch", "2", "--prompt-len", "4",
              "--gen-len", "8", "--ctx", "32"]


def test_serve_driver_generates():
    """Mirror of ``test_system.py::test_serve_driver_generates``."""
    gen = PServe.main(SERVE_ARGS + ["--device", "cpu"])
    assert gen.shape == (2, 8) and gen.dtype == np.int32
    assert np.all(gen >= 0) and np.all(gen < PC.get_config("gemma3-1b", reduced=True).vocab)


def test_serve_driver_tokens_equal_the_reference_drivers():
    """The reference driver's parameters (its seed's init, carried across)
    and the same prompt through the port's decode loop give the reference
    driver's greedy tokens."""
    want = RServe.main(SERVE_ARGS)
    rp = RD.DecoderLM(RC.get_config("gemma3-1b", reduced=True)).init(jax.random.PRNGKey(0))
    got = PServe.main(SERVE_ARGS + ["--device", "cpu"], params=_carry(rp))
    np.testing.assert_array_equal(got, want)


def test_serve_driver_without_a_card_is_a_usage_error(capsys):
    """``--device cuda`` (the default) needs a card: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(SystemExit) as exc:
        PServe.main(SERVE_ARGS)
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        PD.DecoderLM(PC.get_config("gemma3-1b", reduced=True))
