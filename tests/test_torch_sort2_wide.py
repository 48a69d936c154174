"""The pair sort past 16,384 pairs and the sharded multi-hit union it
serves, against the JAX package's 3-key `jax.lax.sort`.

The union sorts rows of K x n_sp (mm * 2 + rc, chunk, local locus)
triples (biokanga_tpu/parallel/sharded.py:234); the port folds the first
two keys into one and sorts (key * n_sp + chunk, locus) pairs through
`sort2_rows` (biokanga_tpu_torch/parallel/sharded.py merge_gathered).
The widths are the two reaches of the old 16,384-pair limit: 3,277 sp
ranks at the default -R 5 (16,385 pairs) and 33 at -R 500 (16,500).
Inputs are made from a seed with numpy: keys with ties and the invalid
row's (255, no rc), loci with ties, -1 and the int32 extremes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.ops import sort
from biokanga_tpu_torch.parallel.sharded import merge_gathered

WIDTHS = [(5, 3_277), (500, 33)]            # (K, n_sp): 16,385 and 16,500


def _gathered(K, n_sp, B, seed):
    """(n_sp, B, 8 + 2K) int32 summaries in merge_over_sp's layout."""
    rng = np.random.default_rng(seed)
    g = np.zeros((n_sp, B, 8 + 2 * K), np.int32)
    best = rng.integers(0, 8, (n_sp, B))
    g[..., 0] = best
    g[..., 1] = best + rng.integers(0, 3, (n_sp, B))
    g[..., 2] = rng.integers(0, 3, (n_sp, B))
    g[..., 3] = rng.integers(0, 2, (n_sp, B))
    g[..., 4] = rng.integers(0, 1 << 20, (n_sp, B))
    g[..., 6] = rng.integers(0, 2, (n_sp, B))
    mm = rng.integers(0, 6, (n_sp, B, K))
    rc = rng.integers(0, 2, (n_sp, B, K))
    loci = rng.integers(0, 1 << 12, (n_sp, B, K))
    loci[rng.random(loci.shape) < 0.05] = 2**31 - 1
    loci[rng.random(loci.shape) < 0.05] = -2**31
    bad = rng.random((n_sp, B, K)) < 0.3         # invalid rows of a chunk
    mm[bad], rc[bad], loci[bad] = 255, 0, -1
    g[..., 8:8 + K] = mm * 2 + rc
    g[..., 8 + K:] = loci
    return g


def _jax_union(g, K):
    """The JAX package's 3-key sort of the union (sharded.py:222-236)."""
    n_sp, B = g.shape[:2]
    mlk = jnp.asarray(g[..., 8:8 + K])
    mll = jnp.asarray(g[..., 8 + K:])
    chunk = jnp.broadcast_to(jnp.arange(n_sp, dtype=jnp.int32)[:, None, None],
                             mlk.shape)

    def flat(a):
        return jnp.moveaxis(a, 1, 0).reshape(B, n_sp * K).T

    s_key, s_chunk, s_loc = jax.lax.sort(
        (flat(mlk), flat(chunk), flat(mll)), dimension=0, num_keys=3)
    return tuple(np.asarray(a).T for a in (s_key, s_chunk, s_loc))


@pytest.mark.parametrize("K,n_sp", WIDTHS)
def test_sort2_rows_plain_equals_the_3_key_sort(K, n_sp):
    g = _gathered(K, n_sp, 3, seed=K + n_sp)
    want_key, want_chunk, want_loc = _jax_union(g, K)
    n, B = n_sp, g.shape[1]
    chunk = np.arange(n, dtype=np.int32)[:, None, None]
    key = (g[..., 8:8 + K] * n + chunk).transpose(1, 0, 2).reshape(B, -1)
    loc = g[..., 8 + K:].transpose(1, 0, 2).reshape(B, -1)
    assert key.shape[1] == K * n_sp > sort.MAX_SORT2_C
    s_key, s_loc = sort.sort2_rows_plain(torch.from_numpy(key.copy()),
                                         torch.from_numpy(loc.copy()))
    assert np.array_equal(s_key.numpy() // n, want_key)
    assert np.array_equal(s_key.numpy() % n, want_chunk)
    assert np.array_equal(s_loc.numpy(), want_loc)
    # the wrapper takes the same rows on the CPU
    w_key, w_loc = sort.sort2_rows(torch.from_numpy(key.copy()),
                                   torch.from_numpy(loc.copy()))
    assert torch.equal(w_key, s_key) and torch.equal(w_loc, s_loc)


@pytest.mark.parametrize("K,n_sp", WIDTHS)
def test_merged_union_equals_the_3_key_sort(K, n_sp):
    g = _gathered(K, n_sp, 4, seed=3 * K + n_sp)
    want_key, want_chunk, want_loc = _jax_union(g, K)
    lengths = torch.full((4,), 100, dtype=torch.int32)
    out = merge_gathered(torch.from_numpy(g), lengths,
                         AlignParams(max_multi=K))
    assert np.array_equal(out["ml_loci"].numpy(), want_loc[:, :K])
    assert np.array_equal(out["ml_chunk"].numpy(), want_chunk[:, :K])
    assert np.array_equal(out["ml_mm"].numpy(),
                          np.minimum(want_key[:, :K] >> 1, 255))
    assert np.array_equal(out["ml_rc"].numpy(), (want_key[:, :K] & 1) == 1)
