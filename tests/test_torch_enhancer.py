"""Port parity: the enhancer forward, ``enhancer_fused`` and the group-wise op.

Both packages get the same weights (the reference's He-normal draw, with
non-trivial biases and BN statistics added from numpy), made into the
port's module by ``repro_torch.core.convert``.  Tolerance: |diff| <= 1e-5
(1 + max|reference|).  The two sides compute the same float32 function but
sum in different orders (XLA's einsum over 9 taps x C channels; torch's
grouped convolution, or the port's fixed elementwise loop), which moves
results by a few ulp of the largest partial sums.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import enhancer as RE
from repro.core import trainer as RT
from repro.kernels import ops as RO
from repro_torch.core import convert, grouping
from repro_torch.core import trainer as PT
from repro_torch.kernels import enhancer_fused, ops, ref

G, C = 4, 9


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())


@pytest.fixture(scope="module")
def weights():
    keys = jax.random.split(jax.random.PRNGKey(0), G)
    params = {k: np.asarray(v) for k, v in
              jax.vmap(lambda k: RE.init_params(k, C))(keys).items()}
    rng = np.random.default_rng(1)
    params["b1"] = rng.normal(0, 0.2, (G, C)).astype(np.float32)
    params["beta"] = rng.normal(0, 0.2, (G, C)).astype(np.float32)
    params["gamma"] = (1 + rng.normal(0, 0.2, (G, C))).astype(np.float32)
    params["b2"] = rng.normal(0, 0.2, (G, 1)).astype(np.float32)
    state = {"mean": rng.normal(0, 0.2, (G, C)).astype(np.float32),
             "var": (1 + rng.random((G, C))).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("train", [False, True])
def test_apply_matches_reference(weights, train):
    params, state = weights
    rng = np.random.default_rng(2)
    mask = (rng.random((G, 3, 16, 12)) < 0.4).astype(np.float32)
    x = rng.normal(0, 1, mask.shape).astype(np.float32) * mask
    enh = convert.enhancers_from_arrays(params, state, device="cpu")
    pred, st = enh(torch.from_numpy(x), train=train,
                   mask=torch.from_numpy(mask) if train else None)

    def one(p, s, xx, mm):
        return RE.apply(p, s, xx, train=train, mask=mm if train else None)

    rpred, rst = jax.vmap(one)(params, state, jnp.asarray(x), jnp.asarray(mask))
    _close(pred.detach().numpy(), rpred)
    for k in ("mean", "var"):
        _close(st[k].numpy(), rst[k])


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 3, 100), (2, 17, 45)])
def test_enhancer_fused_op_matches_reference_kernel(weights, shape):
    params, state = weights
    one_p = {k: np.array(v[1]) for k, v in params.items()}
    one_s = {k: np.array(v[1]) for k, v in state.items()}
    x = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)
    got = ops.enhancer_fused_op(torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in one_p.items()},
                                {k: torch.from_numpy(v) for k, v in one_s.items()})
    want = RO.enhancer_fused_op(jnp.asarray(x), one_p, one_s, use_pallas=True, interpret=True)
    _close(got.numpy(), want)


@pytest.mark.parametrize("residual,clamp", [(True, None), (False, None), (True, 0.02)])
def test_grouped_op_matches_enhance_slices(weights, residual, clamp):
    params, state = weights
    rng = np.random.default_rng(4)
    xs = np.exp(rng.normal(0, 1, (3, 20, 24))).astype(np.float32)
    edges = grouping.compute_edges(torch.from_numpy(xs), G)
    rscale = np.array([0.05, 0.0, 0.2, 0.1], np.float32)  # group 1 inactive
    model = convert.model_from_arrays(params, state, edges.numpy(), rscale, device="cpu",
                                      residual_learning=residual)
    got = PT._enhance_slices(model, torch.from_numpy(xs), clamp_eb=clamp)
    want = RT._enhance_slices(params, state, jnp.asarray(xs), jnp.asarray(edges.numpy()),
                              jnp.asarray(rscale), n_groups=G, residual_learning=residual)
    if clamp is not None:
        want = jnp.clip(want, xs - jnp.float32(clamp), xs + jnp.float32(clamp))
    _close(got.numpy(), want)
    ids = grouping.assign_groups(torch.from_numpy(xs), edges).numpy()
    if residual:  # identity on the inactive group, bit for bit
        np.testing.assert_array_equal(got.numpy()[ids == 1], xs[ids == 1])
    if clamp is not None:
        # x -+ eb is rounded to float32 itself: allow half an ulp of x
        assert (np.abs(got.numpy() - xs) <= np.float32(clamp) + np.spacing(xs)).all()


def test_grouped_plain_version_is_independent_of_the_batch(weights):
    """Each slice enhances to the same bits alone as in any batch: what the
    region decode needs from the plain version on the CPU."""
    params, state = weights
    xs = torch.from_numpy(np.random.default_rng(5).normal(2, 1, (6, 16, 16)).astype(np.float32))
    edges = grouping.compute_edges(xs, G)
    model = convert.model_from_arrays(params, state, edges.numpy(),
                                      np.full(G, 0.1, np.float32), device="cpu")
    whole = PT._enhance_slices(model, xs)
    for i in (0, 3, 5):
        assert torch.equal(PT._enhance_slices(model, xs[i : i + 1]), whole[i : i + 1])
    assert torch.equal(PT._enhance_slices(model, xs[2:5]), whole[2:5])


def test_packed_table_layout(weights):
    params, state = weights
    edges = np.linspace(0, 1, G + 1).astype(np.float32)
    model = convert.model_from_arrays(params, state, edges, np.arange(G, dtype=np.float32),
                                      device="cpu")
    packed = model.packed()
    assert packed.shape == (G, 4 + 21 * C) and enhancer_fused.enhancer_channels(packed) == C
    np.testing.assert_array_equal(packed[:, 0].numpy(), edges[:-1])
    np.testing.assert_array_equal(packed[:, 3].numpy(), np.arange(G, dtype=np.float32))
    np.testing.assert_array_equal(packed[:, 4 : 4 + 9 * C].numpy(),
                                  params["w1"].reshape(G, 9 * C))
    np.testing.assert_array_equal(packed[:, 4 + 12 * C :].numpy(),
                                  params["w2"].reshape(G, 9 * C))


def test_enhance_volume_matches_reference_and_enhance_tiles(weights):
    params, state = weights
    rng = np.random.default_rng(6)
    vol = np.exp(rng.normal(1, 0.5, (8, 12, 16))).astype(np.float32)
    edges = grouping.compute_edges(torch.from_numpy(vol), G)
    rscale = np.array([0.05, 0.1, 0.0, 0.2], np.float32)
    model = convert.model_from_arrays(params, state, edges.numpy(), rscale, device="cpu")
    got = PT.enhance(vol, model, device="cpu")
    rmodel = RT.GWLZModel(params=params, bn_state=state, edges=jnp.asarray(edges.numpy()),
                          rscale=jnp.asarray(rscale), cfg=RT.GWLZTrainConfig(n_groups=G))
    _close(got.numpy(), RT.enhance(jnp.asarray(vol), rmodel))
    # a batch of tiles enhances each tile exactly as enhance() does alone
    tiles = torch.from_numpy(np.stack([vol[:4], vol[4:]]))
    out = PT.enhance_tiles(tiles, model)
    for i in range(2):
        assert torch.equal(out[i], PT.enhance(tiles[i], model, device="cpu"))


@pytest.mark.parametrize("G,C", [(1, 9), (20, 9), (287, 9), (4096, 9), (4096, 1), (20, 64)])
def test_kernel_table_layout(G, C):
    """The kernel reads group g's channel c as 24 contiguous floats of a
    transposed table (w1 taps, b1, BN scale and shift, w2 taps, 3 zeros);
    any number of groups up to group_hist's 4,096 -- the table is not held
    in shared memory, so the 287-group limit of the first version is gone."""
    from repro_torch.kernels import enhancer_fused

    assert enhancer_fused.MAX_GROUPS >= max(G, 287)
    rng = np.random.default_rng(G + C)
    packed = torch.from_numpy(rng.normal(0, 1, (G, 4 + 21 * C)).astype(np.float32))
    tab = enhancer_fused.kernel_table(packed)
    assert tab.shape == (G, 4 + 24 * C) and tab.is_contiguous()
    torch.testing.assert_close(tab[:, :4], packed[:, :4], rtol=0, atol=0)
    w1 = packed[:, 4 : 4 + 9 * C].reshape(G, 9, C)
    bn = packed[:, 4 + 9 * C : 4 + 12 * C].reshape(G, 3, C)
    w2 = packed[:, 4 + 12 * C :].reshape(G, 9, C)
    for c in {0, C // 2, C - 1}:
        row = tab[:, 4 + 24 * c : 4 + 24 * (c + 1)]
        want = torch.cat([w1[:, :, c], bn[:, :, c], w2[:, :, c], torch.zeros(G, 3)], dim=1)
        torch.testing.assert_close(row, want, rtol=0, atol=0)
