"""The port's gather checksum against the JAX package, tolerance 0.

Seeded numpy tables of 64-byte rows and index vectors (R not a multiple
of the TPU kernel's 8 x 512 rows, duplicate indices, rows 0 and R-1
present, n smaller and larger than R) go through

  (a) the gather probe's JAX reference, written as
      scripts/probe_stream_gather.py:54-63 writes it (a jnp gather, four
      byte planes XORed with the index bytes, a uint32 sum);
  (b) the JAX package's `stream_gather_consume` itself, its Pallas
      kernel run in interpret mode by patching `pl.pallas_call` inside
      the test (the function takes no `interpret` flag; nothing in the
      JAX package changes), on the cases small enough for that;
  (c) the port's `stream_gather_consume` on CPU tensors, which runs its
      plain version, with and without `sort_rows`.

All three integers must be equal.  The CUDA kernel is held against the
same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from biokanga_tpu.ops import stream_gather as jax_sg
from biokanga_tpu_torch.device import u32_from_numpy
from biokanga_tpu_torch.ops import stream_gather as sg

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _jax_reference(table: np.ndarray, idx: np.ndarray) -> int:
    """The probe's plain JAX expression of the checksum."""
    def consume_bytes(v, i_):
        acc = jnp.uint32(0)
        for k in range(4):
            bk = (v >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
            gk = (i_[:, None].astype(jnp.uint32)
                  >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)
            acc += jnp.sum(bk ^ gk, dtype=jnp.uint32)
        return acc

    t_, i_ = jnp.asarray(table), jnp.asarray(idx)
    return int(jax.device_get(jax.jit(consume_bytes)(t_[i_], i_)))


def _inputs(R: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(R, 16), dtype=np.uint32)
    table[rng.integers(0, R, max(R // 8, 1))] = 0xFFFFFFFF   # byte sums peak
    idx = rng.integers(0, R, size=n, dtype=np.int32)
    if n >= 4:
        idx[0], idx[-1] = R - 1, 0
        idx[n // 2] = idx[n // 3]                            # a duplicate
    return table, idx


@pytest.mark.parametrize("R,n,seed", [
    (1_000, 300, 0),            # n < R
    (37, 5_000, 1),             # n > R, every row many times
    (4_097, 4_097, 2),          # one past 8 x 512
    (70_001, 20_000, 3),        # row numbers with three index bytes
    (1, 9, 4),                  # one row
    (12, 0, 5),                 # no index
])
def test_checksum_matches_jax_reference(R, n, seed):
    table, idx = _inputs(R, n, seed)
    want = _jax_reference(table, idx)
    t, i = u32_from_numpy(table, CPU), torch.from_numpy(idx)
    got = sg.stream_gather_consume(t, i)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    assert int(sg.stream_gather_consume(t, i, sort_rows=True)) == want
    assert int(sg.stream_gather_consume_plain(t, i)) == want
    assert 0 <= want < 2**32


@pytest.mark.parametrize("R,n,seed", [(1_000, 300, 0), (4_097, 2_500, 2)])
def test_checksum_matches_the_pallas_kernel_interpreted(R, n, seed,
                                                        monkeypatch):
    monkeypatch.setattr(jax_sg.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    table, idx = _inputs(R, n, seed)
    want = int(jax.device_get(jax_sg.stream_gather_consume.__wrapped__(
        jnp.asarray(table), jnp.asarray(idx), tile_lines=64, block=128)))
    assert want == _jax_reference(table, idx)
    got = sg.stream_gather_consume(u32_from_numpy(table, CPU),
                                   torch.from_numpy(idx))
    assert int(got) == want


def test_wrapper_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((8, 16), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="table"):
        sg.stream_gather_consume(table.to(torch.int64), idx)
    with pytest.raises(ValueError, match="table"):
        sg.stream_gather_consume(table[:, :8], idx)
    with pytest.raises(ValueError, match="idx"):
        sg.stream_gather_consume(table, idx.to(torch.int64))
    with pytest.raises(ValueError, match="idx"):
        sg.stream_gather_consume(table, idx[None, :])
    with pytest.raises(ValueError, match="empty"):
        sg.stream_gather_consume(table[:0], idx)
    with pytest.raises(ValueError, match="table on"):
        sg.stream_gather_consume(table, idx.to("meta"))
    before = sg.stream_gather_consume.launches
    assert int(sg.stream_gather_consume(table, idx)) == 0
    assert sg.stream_gather_consume.launches == before   # no kernel on CPU


H100_L2 = 50 * 2**20           # cudaDevAttrL2CacheSize of an H100 SXM
REGION = H100_L2 // 2 // 64    # 409,600 rows: half the L2


@pytest.mark.parametrize("mb,regions", [
    (2.3, 1), (16.0, 1), (40.0, 2), (64.0, 3), (128.0, 5), (512.0, 1),
    (2048.0, 1)])
def test_gather_plan_at_the_probe_sizes(mb, regions):
    """The gather probe's tables (scripts/probe_stream_gather_torch.py
    DEFAULT_MB) under its 6,291,456 random gathers: regions of half the
    L2 up to 128 MB, one pass over the whole table past n = R."""
    rows = int(mb * 1e6 / 64)
    region = sg.gather_plan(rows, 6_291_456, H100_L2)
    assert region == (REGION if mb <= 128 else rows)
    assert -(-rows // region) == regions


@pytest.mark.parametrize("rows,n,regions", [
    (1, 1, 1),                                   # one row, once
    (1_000, 999, 1), (1_000, 1_000, 1),          # n = R
    (REGION, REGION - 1, 1), (REGION + 1, REGION, 1),   # n < R
    (REGION + 1, REGION + 1, 2),                 # two regions
    (10 * REGION, 10 * REGION, 10),              # MAX_SWEEPS regions
    (10 * REGION + 1, 10**9, 1),                 # one past it
    (2**31 - 1, 2**31 - 1, 1),
])
def test_gather_plan_at_the_edges_of_its_rule(rows, n, regions):
    assert sg.MAX_SWEEPS == 10
    region = sg.gather_plan(rows, n, H100_L2)
    assert -(-rows // region) == regions
    # regions of half the L2, or the whole table as one
    assert region in (REGION, rows)
    # an L2 smaller than two rows still gives regions of at least a row
    assert sg.gather_plan(rows, n, 64) >= 1
