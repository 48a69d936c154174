"""The port's device index build against the JAX package's.

A read set like the error-correction index's (reads and their reverse
complements, concatenated) with N runs, single Ns and a repeat, made from
a numpy seed, is indexed by both packages; keys, LUT, sorted positions
and the binary-search trip bound must be equal.  The port builds on the
CPU here; on the card the same torch code runs on CUDA tensors.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.index.device_build import device_build_index as jax_build
from biokanga_tpu_torch.device import u32_from_key32
from biokanga_tpu_torch.index.device_build import device_build_index
from biokanga_tpu_torch.seq.encode import revcomp

torch.set_num_threads(2)


def _read_set(seed, n_reads=40):
    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, int(rng.integers(150, 600))).astype(np.int8)
             for _ in range(n_reads)]
    reads[3][10:30] = 4
    reads[7][::37] = 4
    reads[9] = reads[2].copy()                   # ties of whole keys
    reads[11] = np.tile(np.array([0, 1, 1, 3], np.int8), 60)
    seqs = reads + [revcomp(r) for r in reads]
    codes = np.concatenate(seqs)
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=starts[1:])
    return codes, starts.astype(np.int32)


@pytest.mark.parametrize("lut_bases", [8, 10])
def test_device_build_matches_jax(lut_bases):
    codes, starts = _read_set(lut_bases)
    n = len(codes)
    want = jax_build(codes, starts, lut_bases=lut_bases)
    got = device_build_index(codes, starts, lut_bases=lut_bases,
                             device="cpu")
    assert got.key_hi.dtype == got.key_lo.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want.key_hi, np.int64),
                                  u32_from_key32(got.key_hi).numpy())
    np.testing.assert_array_equal(np.asarray(want.key_lo, np.int64),
                                  u32_from_key32(got.key_lo).numpy())
    np.testing.assert_array_equal(np.asarray(want.lut), got.lut.numpy())
    pos = np.asarray(want.pos_rows).reshape(-1)
    np.testing.assert_array_equal(pos, got.pos_sorted.numpy())
    assert got.pos_sorted.shape[0] >= n + 4096
    assert want.max_bsearch_steps == got.max_bsearch_steps
    np.testing.assert_array_equal(np.asarray(want.entry_starts),
                                  got.entry_starts.numpy())
    np.testing.assert_array_equal(codes, got.genome.numpy())
    assert got.packed.has_n and got.packed.length == n
