"""Port parity: value-based grouping and the ``group_hist`` plain version.

``quantile`` edges must equal the reference's (``jnp.quantile`` on the CPU)
bit for bit.  ``range`` matches to 2 ulp (XLA fuses the linspace
arithmetic in ways torch cannot pin down exactly).  ``log`` goes through
``exp``/``log``, whose XLA and torch implementations differ by ulps, and
then subtracts the shift, which can cancel; it is held to 2e-6 of the
largest edge magnitude.  Group ids and histograms are integers: exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grouping as RG
from repro.kernels import ops as RO
from repro_torch.core import grouping as PG
from repro_torch.data import nyx_like_field
from repro_torch.kernels import ops


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("field", ["temperature", "baryon_density"])
@pytest.mark.parametrize("G", [4, 20])
def test_quantile_edges_bitexact(n, field, G):
    x = nyx_like_field((n,) * 3, field, seed=0)
    want = np.asarray(RG.compute_edges(jnp.asarray(x), G))
    got = PG.compute_edges(torch.from_numpy(x), G).numpy()
    assert got.dtype == np.float32 and got.shape == (G + 1,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantile_index_clamps_at_the_top():
    """n - 1 rounds up to n in float32 above 2^24: the top index must clamp
    to the last value, not run past it."""
    x = torch.arange(2**24 + 3, dtype=torch.float32)
    e = PG._quantiles(x, 4)
    assert float(e[-1]) == float(x[-1]) and bool(torch.isfinite(e).all())


@pytest.mark.parametrize("strategy", ["range", "log"])
@pytest.mark.parametrize("field,seed", [("temperature", 0), ("baryon_density", 7),
                                        ("dark_matter_density", 3)])
def test_range_and_log_edges_within_bound(strategy, field, seed):
    x = nyx_like_field((24, 20, 16), field, seed=seed)
    for G in (4, 8, 20):
        want = np.asarray(RG.compute_edges(jnp.asarray(x), G, strategy))
        got = PG.compute_edges(torch.from_numpy(x), G, strategy).numpy()
        if strategy == "range":
            assert _ulps(got, want) <= 2
        else:
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def _edge_case_values(edges: np.ndarray, rng) -> np.ndarray:
    """Values exactly on every edge, below the first, above the last, and
    random ones; padded to a multiple of 128 for the reference's kernel."""
    lo, hi = float(edges[0]), float(edges[-1])
    v = np.concatenate([edges, [lo - 1.0, hi + 1.0, -np.inf, np.inf],
                        rng.uniform(lo - 0.5, hi + 0.5, 1000)]).astype(np.float32)
    pad = -len(v) % 128
    return np.concatenate([v, rng.uniform(lo, hi, pad).astype(np.float32)])


@pytest.mark.parametrize("G", [1, 4, 20])
def test_group_hist_matches_reference_kernel_and_assign_groups(G):
    rng = np.random.default_rng(G)
    edges = np.sort(rng.normal(0, 1, G + 1)).astype(np.float32)
    if G >= 4:
        edges[2] = edges[1]  # duplicate edge: an empty group
    x = _edge_case_values(edges, rng).reshape(-1, 8, 16)
    ids, hist = ops.group_hist_op(torch.from_numpy(x), torch.from_numpy(edges))
    rids, rhist = RO.group_hist_op(jnp.asarray(x), jnp.asarray(edges), n_groups=G,
                                   use_pallas=True, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(rhist))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(RG.assign_groups(jnp.asarray(x),
                                                                           jnp.asarray(edges))))
    assert ids.dtype == torch.int32 and ids.shape == x.shape and int(hist.sum()) == x.size


def test_group_hist_takes_any_size():
    x = torch.linspace(-2, 2, 1001)  # not a multiple of 128
    ids, hist = ops.group_hist_op(x, torch.tensor([-1.0, 0.0, 1.0]))
    assert ids.shape == x.shape and hist.tolist() == [int((x < 0).sum()), int((x >= 0).sum())]


def test_normalizers_masks_and_stats_match_reference():
    x = nyx_like_field((16, 16, 16), "temperature", seed=5)
    edges = PG.compute_edges(torch.from_numpy(x), 6)
    ids = PG.assign_groups(torch.from_numpy(x), edges)
    redges = jnp.asarray(edges.numpy())
    rids = RG.assign_groups(jnp.asarray(x), redges)
    for got, want in zip(PG.group_normalizers(edges), RG.group_normalizers(redges)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(PG.group_masks(ids, 6).numpy(),
                                  np.asarray(RG.group_masks(rids, 6)))
    got, want = PG.group_stats(torch.from_numpy(x), ids, 6), RG.group_stats(jnp.asarray(x),
                                                                             rids, 6)
    for k in ("count", "min", "max"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the mean's float32 sums run in another order
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]), rtol=1e-5)
