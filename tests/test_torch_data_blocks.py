"""Port parity: ``TokenPipeline.prefetch`` and ``NyxBlockPipeline``
(``repro_torch.data.tokens``) against ``repro.data.tokens`` on the CPU,
mirroring ``tests/test_data_sharding.py``: prefetched batches equal
``batch_at`` bit for bit, the block shards cover the volume once, and
every host's shards equal the reference's on the same seeded volume."""
import threading

import numpy as np
import pytest

from repro.data.tokens import NyxBlockPipeline as RBlocks
from repro.data.tokens import TokenPipeline as RPipe
from repro.data.tokens import TokenPipelineConfig as RCfg
from repro_torch.data.synthetic import nyx_like_field
from repro_torch.data.tokens import NyxBlockPipeline, TokenPipeline, TokenPipelineConfig


def test_token_prefetch_matches_batch_at_and_the_reference():
    pipe = TokenPipeline(TokenPipelineConfig(vocab=64, batch=2, seq=8, seed=0))
    ref = RPipe(RCfg(vocab=64, batch=2, seq=8, seed=0))
    before = threading.active_count()
    gen = pipe.prefetch(5)
    for want_step in (5, 6, 7):
        step, batch = next(gen)
        assert step == want_step
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(batch[k], pipe.batch_at(step)[k])
            np.testing.assert_array_equal(batch[k], ref.batch_at(step)[k])
    gen.close()  # stops and joins the worker
    assert threading.active_count() == before


def test_block_pipeline_shards_cover_volume():
    vol = np.arange(4 * 4 * 4, dtype=np.float32).reshape(4, 4, 4)
    pipe = NyxBlockPipeline(vol, (2, 2, 2))
    seen = set()
    for host in range(2):
        for coords, blk in pipe.shard(host, 2):
            assert blk.shape == (2, 2, 2)
            assert coords not in seen
            seen.add(coords)
    assert len(seen) == 8
    with pytest.raises(ValueError):
        NyxBlockPipeline(vol, (3, 2, 2))


@pytest.mark.parametrize("n_hosts", [1, 3, 4])
def test_block_shards_equal_the_references(n_hosts):
    vol = nyx_like_field((16, 16, 16), "temperature", seed=3)
    pipe, ref = NyxBlockPipeline(vol, (8, 4, 8)), RBlocks(vol, (8, 4, 8))
    assert pipe.grid == ref.grid
    for host in range(n_hosts):
        got, want = list(pipe.shard(host, n_hosts)), list(ref.shard(host, n_hosts))
        assert [c for c, _ in got] == [c for c, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
