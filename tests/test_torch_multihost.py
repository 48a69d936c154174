"""Several hosts on the port (parallel/multihost.py) and the mesh's
collectives (parallel/dist.py), as gloo ranks on the CPU.

Two "hosts" of two ranks each join one world through init_multihost.
Each host parses only its round-robin blocks of one FASTQ
(host_block_iter), every rank aligns its dp block of each with the
sharded aligner at (2, 2) (one dp coordinate a host) and at (4, 1) (two),
and local_results gives each rank its host's rows, which must equal the
single-device engines' results on the same blocks: the JAX package's and
the port's, exactly.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.align.params import AlignParams
from biokanga_tpu.align.pipeline import AlignEngine
from biokanga_tpu.index.build import build_index
from biokanga_tpu.index.device import to_device
from biokanga_tpu.seq.fasta import read_blocks, write_fastq
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.align.pipeline import AlignEngine as PortEngine
from biokanga_tpu_torch.index.build import build_index as port_build_index
from biokanga_tpu_torch.index.device import to_device as port_to_device
from biokanga_tpu_torch.parallel.multihost import host_block_iter
from torch_dist_ranks import (
    collective_ranks,
    global_mesh_ranks,
    load,
    multihost_world,
    save,
    spawn,
)

BLOCK = 256
KEYS = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus", "is_rc",
        "ml_loci", "ml_mm", "ml_rc")


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    seqs = random_genome([("c1", 30000), ("c2", 20000)], seed=31)
    names, reads, _ = simulate_reads(seqs, 6 * BLOCK, read_len=100,
                                     sub_rate=0.02, seed=13)
    reads[:8] = np.ascontiguousarray(seqs[0][1][500:600])   # N-free repeat
    reads[8:12, 40] = 4
    fastq = str(out / "reads.fq")
    write_fastq(fastq, ((n, r, None) for n, r in zip(names, reads)))
    save(str(out), "genome", seqs)
    spawn(multihost_world, 4, str(out), fastq, BLOCK, join=False)
    return seqs, fastq, str(out)


@pytest.mark.parametrize("layout", ["2x2", "4x1"])
def test_each_host_gets_the_single_rank_rows(two_hosts, layout):
    seqs, fastq, out = two_hosts
    params = AlignParams(cand_per_core=32)
    jax_engine = AlignEngine(to_device(build_index(seqs, lut_bases=8)), params)
    port_engine = PortEngine(port_to_device(port_build_index(
        seqs, lut_bases=8), torch.device("cpu")), params)
    blocks = list(read_blocks(fastq, block_size=BLOCK))
    assert len(blocks) == 6
    for rank in range(4):
        host = rank // 2
        got = load(out, f"host_{layout}_rank{rank}")
        mine = blocks[host::2]
        assert len(got) == len(mine) == 3
        for (names, rows), blk in zip(got, mine):
            assert names == blk.names
            want = jax_engine.align_with_rescue(blk.codes, blk.lengths)
            port = port_engine.align_with_rescue(blk.codes, blk.lengths)
            for k in KEYS:
                np.testing.assert_array_equal(rows[k], want[k], err_msg=k)
                np.testing.assert_array_equal(rows[k], port[k], err_msg=k)
            assert rows["unique"].sum() > 0.9 * len(names) - 8


def test_host_block_iter_is_round_robin(two_hosts):
    _, fastq, _ = two_hosts
    every = [b.names for b in read_blocks(fastq, block_size=100)]
    for host in range(3):
        got = [b.names for b in host_block_iter(fastq, 100, host, 3)]
        assert got == every[host::3]


def test_collective_helpers(tmp_path):
    spawn(collective_ranks, 4, str(tmp_path))
    for rank in range(4):
        got = load(str(tmp_path), f"collectives_rank{rank}")
        dp, sp = divmod(rank, 2)
        assert got["coords"] == (dp, sp, rank)
        # sp group of dp coordinate d: ranks 2d, 2d+1; dp group of s: s, s+2
        np.testing.assert_array_equal(
            got["gather"][:, 0], [[2 * dp, 20 * dp], [2 * dp + 1,
                                                      20 * dp + 10]])
        np.testing.assert_array_equal(got["sum"], [[2 * sp + 2,
                                                    20 * sp + 20]])
        np.testing.assert_array_equal(got["bcast"], [[4, 31]])
        np.testing.assert_array_equal(got["bool"][:, 0], [True, False])


def test_global_mesh_is_the_world_and_gathers_within_a_host(tmp_path):
    spawn(global_mesh_ranks, 4, str(tmp_path))
    for rank in range(4):
        got = load(str(tmp_path), f"global_mesh_rank{rank}")
        smaller, too_few, uneven, foreign = got["refused"]
        # a mesh of 2 of the 4 ranks would put both dp blocks on host 0
        assert smaller is not None and "the world 4" in smaller
        assert too_few is not None and "the world 4" in too_few
        assert uneven is not None and "multiple of the 3 hosts" in uneven
        assert foreign is not None and "global_mesh" in foreign
        # (2, 2) over 2 hosts: one dp block a host, so a host's group at
        # one sp coordinate is the rank itself; (4, 1): ranks 0-1 and 2-3
        assert got["2x2"] == [rank]
        assert got["rows_2x2"] == [rank]
        host = [0, 1] if rank < 2 else [2, 3]
        assert got["4x1"] == host
        assert got["rows_4x1"] == host
