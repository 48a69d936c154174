"""Target-chunked error correction: the port against the JAX package.

The 12 reads of tests/test_pacbio.py's chunked case are corrected with at
most 5 target reads indexed at a time (3 target chunks; votes add up
across chunks).  The corrected reads and `overlaps_used` must equal the
JAX package's.  A file of its own, so that its JAX run, the slowest of
the parity runs, goes to its own test worker.
"""
import numpy as np
import torch

from biokanga_tpu.pacbio import ecreads as jax_ec
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.pacbio import ecreads as port_ec
from test_torch_ecreads import CHUNK_BYTES, assert_same_reads, noisy_copy

torch.set_num_threads(2)


def test_target_chunked_ec_matches_jax():
    rng = np.random.default_rng(21)
    true = random_genome([("t", 800)], seed=51)[0][1]
    reads = [noisy_copy(rng, true) for _ in range(12)]
    kw = {"min_overlap_score": 100, "sw_chunk_bytes": CHUNK_BYTES}
    want, ws = jax_ec.ec_reads(reads, jax_ec.ECParams(**kw), target_chunk=5)
    got, gs = port_ec.ec_reads(reads, port_ec.ECParams(**kw),
                               target_chunk=5, device="cpu")
    assert_same_reads(want, got)
    assert gs["target_chunks"] == ws["target_chunks"] == 3
    assert gs["overlaps_used"] == ws["overlaps_used"] > 0
