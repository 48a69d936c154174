"""biokanga_tpu_torch.ops.sort against the JAX package's column sorts.

Same seeded inputs through `lax.sort`, the Pallas kernels in interpret
mode (`_run_sort` / `_run_sort2`, on (C, B) as tests/test_pallas_sort.py
runs them) and the port's row sorts on the transposed (B, C) matrix.
Tolerance 0: the outputs are integers and must be equal.  The CUDA
kernels themselves are held against the plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.ops.pallas_sort import TILE_B, _run_sort, _run_sort2
from biokanga_tpu_torch.ops import sort

torch.set_num_threads(2)

I32_MAX = np.int32(2**31 - 1)


def _values(rng, C, B):
    """(C, B) int32: bit 31 set in about half, ties, INT32_MAX sentinels."""
    x = rng.integers(-2**31, 2**31, size=(C, B), dtype=np.int64)
    x = x.astype(np.int32)
    r = rng.random((C, B))
    x[r < 0.2] = rng.integers(0, 16, size=int((r < 0.2).sum()))
    x[r > 0.75] = I32_MAX
    return x


def _port_sort_cols(x):
    """The port's row sort applied to a JAX-layout (C, B) matrix."""
    return sort.sort_rows(torch.from_numpy(x.T.copy())).numpy().T


@pytest.mark.parametrize("C", [2, 8, 64, 256])
def test_sort_rows_matches_pallas_and_lax(C):
    x = _values(np.random.default_rng(C), C, TILE_B)
    want = np.asarray(jax.lax.sort(jnp.asarray(x), dimension=0))
    pallas = np.asarray(_run_sort(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_port_sort_cols(x), want)


@pytest.mark.parametrize("C", [3, 384, 480, 1000])
def test_sort_rows_any_width_matches_lax(C):
    """Widths that are not powers of two (the pipeline's S*H) need no pad."""
    x = _values(np.random.default_rng(C + 7), C, 64)
    want = np.asarray(jax.lax.sort(jnp.asarray(x), dimension=0))
    np.testing.assert_array_equal(_port_sort_cols(x), want)


@pytest.mark.parametrize("C", [4, 32, 512])
def test_sort2_rows_matches_pallas_and_lax(C):
    rng = np.random.default_rng(C + 100)
    k = rng.integers(0, 20, size=(C, TILE_B), dtype=np.int32)
    k[rng.random(k.shape) < 0.1] = I32_MAX
    v = _values(rng, C, TILE_B)
    wk, wv = jax.lax.sort((jnp.asarray(k), jnp.asarray(v)), dimension=0,
                          num_keys=2)
    pk, pv = _run_sort2(jnp.asarray(k), jnp.asarray(v), interpret=True)
    np.testing.assert_array_equal(np.asarray(pk), np.asarray(wk))
    np.testing.assert_array_equal(np.asarray(pv), np.asarray(wv))
    gk, gv = sort.sort2_rows(torch.from_numpy(k.T.copy()),
                             torch.from_numpy(v.T.copy()))
    np.testing.assert_array_equal(gk.numpy().T, np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy().T, np.asarray(wv))


def test_sort2_rows_negative_keys_and_extremes():
    k = np.array([[5, -3, 5, -2**31, 2**31 - 1, -3]], np.int32)
    v = np.array([[-1, 7, -2**31, 0, 2**31 - 1, -7]], np.int32)
    gk, gv = sort.sort2_rows(torch.from_numpy(k), torch.from_numpy(v))
    order = sorted(zip(k[0].tolist(), v[0].tolist()))
    assert gk[0].tolist() == [a for a, _ in order]
    assert gv[0].tolist() == [b for _, b in order]


def test_limits_are_refused_on_every_device():
    # both sorts take any width (rows past the block path's 32,768 values
    # or 16,384 pairs take the scratch-row path on the card); only a wrong
    # type or rank is refused
    x = _values(np.random.default_rng(3), 2, sort.MAX_SORT_C + 1).reshape(
        1, -1)[:, :sort.MAX_SORT_C + 1]
    x = torch.from_numpy(np.ascontiguousarray(x))
    assert torch.equal(sort.sort_rows(x), torch.sort(x, dim=1).values)
    rng = np.random.default_rng(4)
    k = rng.integers(-3, 4, size=(2, sort.MAX_SORT2_C + 1)).astype(np.int32)
    v = _values(rng, 2, sort.MAX_SORT2_C + 1)
    gk, gv = sort.sort2_rows(torch.from_numpy(k), torch.from_numpy(v))
    for r in range(2):
        order = np.lexsort((v[r], k[r]))
        assert np.array_equal(gk[r].numpy(), k[r][order])
        assert np.array_equal(gv[r].numpy(), v[r][order])
    with pytest.raises(ValueError, match="int32"):
        sort.sort_rows(torch.zeros((2, 4), dtype=torch.int64))
