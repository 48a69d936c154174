"""ec_reads(mesh=...) on the port: two gloo ranks on the CPU split each
SW chunk's pairs and sum the vote planes, and must give the JAX
package's ec_reads(mesh=...) output (tests/test_pacbio.py's mesh case:
ten noisy copies of a 700 bp sequence, the conftest's 8 virtual CPU
devices) and the port's single-rank output, read for read, exactly, on
both ranks."""
import jax
import numpy as np
from jax.sharding import Mesh

from biokanga_tpu.pacbio.ecreads import ECParams as JaxParams
from biokanga_tpu.pacbio.ecreads import ec_reads as jax_ec_reads
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.pacbio.ecreads import ECParams, ec_reads
from test_pacbio import noisy_copy
from torch_dist_ranks import ec_mesh_ranks, load, spawn


def test_ec_reads_two_ranks_equal_jax_mesh_and_one_rank(tmp_path):
    rng = np.random.default_rng(33)
    true = random_genome([("t", 700)], seed=52)[0][1]
    reads = [noisy_copy(rng, true) for _ in range(10)]
    # chunks of 16 pairs (the smallest): several chunks, uneven shares
    p = ECParams(min_overlap_score=100, sw_chunk_bytes=1)
    spawn(ec_mesh_ranks, 2, str(tmp_path), reads, p)
    devs = np.asarray(jax.devices())
    want, want_st = jax_ec_reads(reads, JaxParams(min_overlap_score=100),
                                 mesh=Mesh(devs.reshape(len(devs)), ("dp",)))
    one, one_st = ec_reads(reads, p, device="cpu")
    assert one_st["pairs"] > 3 * 16
    for rank in range(2):
        got, st = load(str(tmp_path), f"ec_rank{rank}")
        assert st["overlaps_used"] == one_st["overlaps_used"] == \
            want_st["overlaps_used"]
        assert len(got) == len(want) == len(one)
        for g, w, o in zip(got, want, one):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, o)
