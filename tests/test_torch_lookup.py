"""biokanga_tpu_torch.ops.lookup and index.device against the JAX package.

Seeded reads are packed into seed-core queries and looked up in the same
index by both packages: the LUT-only path (core_len <= lut_bases) and the
fixed-trip binary search (core_len > lut_bases, one and two key words).
Keys compare as unsigned; a random genome gives keys with bit 31 set in
about half the suffixes.  Equality is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biokanga_tpu.index.build import build_index
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.ops import lookup as jlk
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.device import resolve_device
from biokanga_tpu_torch.index.device import from_arrays, to_device
from biokanga_tpu_torch.ops import lookup as tlk

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def index():
    seqs = random_genome([("c1", 30_000), ("c2", 12_000)], seed=4)
    seqs[0][1][5_000:5_600] = np.tile(np.array([0, 0, 1], np.int8), 200)
    seqs[1][1][100:140] = 4
    return seqs, build_index(seqs, lut_bases=7)


def _reads(seqs, rng, B=128, L=100):
    g = np.concatenate([s for _, s in seqs])
    origin = rng.integers(0, len(g) - L, size=B)
    reads = g[origin[:, None] + np.arange(L)]
    reads[rng.random(reads.shape) < 0.01] = 4
    reads[5] = g[5_000:5_000 + L]                  # low-complexity repeat
    return reads


@pytest.mark.parametrize("k", [5, 7, 12, 16, 20, 32])
def test_seed_range_lookup_matches_jax(index, k):
    seqs, idx = index
    reads = _reads(seqs, np.random.default_rng(k))
    offsets = tuple(range(0, 100 - k + 1, 9))
    jq = jlk.pack_read_kmers(jnp.asarray(reads), offsets, k)
    tq = tlk.pack_read_kmers(torch.from_numpy(reads), offsets, k)
    for a, b in zip(jq, tq):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd = jax_to_device(idx)
    td = to_device(idx, CPU)
    assert td.max_bsearch_steps == jd.max_bsearch_steps
    js, je = jlk.seed_range_lookup(
        jd.key_hi, jd.key_lo, jd.lut, jd.lut_bases, *jq[:4], core_len=k,
        max_steps=jd.max_bsearch_steps)
    ts, te = tlk.seed_range_lookup(
        td.key_hi, td.key_lo, td.lut, td.lut_bases, *tq[:4], core_len=k,
        max_steps=td.max_bsearch_steps)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    size = np.asarray(je) - np.asarray(js)
    assert (size > 0).any()
    if k > idx.lut_bases:                 # the search narrowed the buckets
        lut = np.asarray(idx.lut)
        bucket = lut[(np.asarray(jq[2]) >> (32 - 2 * idx.lut_bases)) + 1] \
            - lut[np.asarray(jq[0]) >> (32 - 2 * idx.lut_bases)]
        assert (size < bucket).any()
    assert (np.asarray(idx.key_hi) >= 2**31).any()


def test_from_arrays_equals_to_device(index):
    _, idx = index
    jd = jax_to_device(idx)
    arrays = {f: np.asarray(getattr(jd, f)) for f in (
        "genome", "entry_starts", "pos_rows", "key_hi", "key_lo", "lut")}
    arrays.update(lut_bases=jd.lut_bases, entry_names=jd.entry_names,
                  max_bsearch_steps=jd.max_bsearch_steps,
                  packed_rows=np.asarray(jd.packed.rows),
                  packed_n_rows=np.asarray(jd.packed.n_rows),
                  packed_length=jd.packed.length)
    a = from_arrays(arrays, CPU)
    b = to_device(idx, CPU)
    for f in ("genome", "entry_starts", "pos_sorted", "key_hi", "key_lo",
              "lut"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.packed.rows, b.packed.rows)
    assert torch.equal(a.packed.n_rows, b.packed.n_rows)
    assert (a.lut_bases, a.entry_names, a.max_bsearch_steps, a.total_len) == \
        (b.lut_bases, b.entry_names, b.max_bsearch_steps, b.total_len)
    # the tail pad keeps the JAX row layout's length and zero fill
    assert a.pos_sorted.shape[0] == jd.pos_rows.size
    assert int(a.pos_sorted[idx.total_len:].abs().sum()) == 0


def test_resolve_device_is_explicit(monkeypatch):
    assert resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")


def _int64_ranges(idx, q):
    """(start, end) of each query's [qlow, qhigh] over the host index's
    keys taken whole as unsigned 64-bit numbers: the search as it was
    with int64 keys, by np.searchsorted."""
    whole = (idx.key_hi.astype(np.uint64) << np.uint64(32)) \
        | idx.key_lo.astype(np.uint64)
    lo = (q[0].numpy().astype(np.uint64) << np.uint64(32)) \
        | q[1].numpy().astype(np.uint64)
    hi = (q[2].numpy().astype(np.uint64) << np.uint64(32)) \
        | q[3].numpy().astype(np.uint64)
    return (np.searchsorted(whole, lo, side="left"),
            np.searchsorted(whole, hi, side="right"))


@pytest.mark.parametrize("k", [9, 16, 20, 32])
@pytest.mark.parametrize("build", ["host", "device", "chunk"])
def test_key32_lookup_equals_the_int64_search(index, k, build):
    """The int32 keys with the sign bit flipped and the flipped queries
    find the ranges of the unsigned 64-bit search, for keys and queries at
    and above 2^31 (hi words starting with G or T), at the all-T top and
    the all-A bottom, in every index build."""
    from biokanga_tpu_torch.device import u32_from_key32
    from biokanga_tpu_torch.index import chunked as tch
    from biokanga_tpu_torch.index.build import build_index as t_build
    from biokanga_tpu_torch.index.device_build import device_build_index

    seqs, _ = index
    seqs = [(n, s.copy()) for n, s in seqs]
    seqs[0][1][9_000:9_300] = 3                     # all-T keys: 0xFFFFFFFF
    seqs[0][1][9_300:9_600] = 0
    idx = t_build(seqs, lut_bases=7)
    if build == "host":
        td = to_device(idx, CPU)
    elif build == "device":
        td = device_build_index(idx.codes, idx.entry_starts, lut_bases=7,
                                device="cpu")
    else:
        ci = tch.build_chunked_index(seqs, num_chunks=1, lut_bases=7)
        td = tch.chunk_to_device(ci, 0, device=CPU)
    assert td.key_hi.dtype == td.key_lo.dtype == torch.int32
    n = idx.total_len
    for t, want in ((td.key_hi, idx.key_hi), (td.key_lo, idx.key_lo)):
        np.testing.assert_array_equal(u32_from_key32(t[:n]).numpy(), want)
    assert (idx.key_hi >= 2**31).mean() > 0.4
    assert (td.key_hi[:n] >= 0).any() and (td.key_hi[:n] < 0).any()
    rng = np.random.default_rng(k)
    reads = _reads(seqs, rng).astype(np.int8)
    reads[7, :40] = 3
    reads[8, :40] = 0
    reads[9, :40] = 2                               # G: 0xAAAAAAAA
    q = tlk.pack_read_kmers(torch.from_numpy(reads), (0, 20, 60), k)
    assert (q[0] >= 2**31).any() and (q[0] < 2**31).any()
    start, end = tlk.seed_range_lookup(
        td.key_hi, td.key_lo, td.lut, td.lut_bases, *q[:4], core_len=k,
        max_steps=td.max_bsearch_steps)
    want_s, want_e = _int64_ranges(idx, q)
    np.testing.assert_array_equal(start.numpy(), want_s)
    np.testing.assert_array_equal(end.numpy(), want_e)
    assert (end - start)[7, 0] > 0 and (end - start)[8, 0] > 0
