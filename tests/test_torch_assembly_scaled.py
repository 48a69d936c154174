"""The scaled assembly pass of the port (assembly/scale_overlap.py, the
windowed extension #3w) and `contigs` against the JAX package.

Inputs are made from numpy seeds, at the sizes of the JAX package's own
tests/test_assembly_scaled.py: 600 error-free 100 bp reads of an 8 kb
genome, and 500 reads of a 6 kb genome with 0.5% substitutions, half of
them reverse-complemented.  The winner arrays of `best_right_extensions`
(`PassEdges`), the sequences and merge count of `one_pass_scaled`, and
the contigs and stats of `assemble(scaled=True)` over a few passes must
be equal; the FASTA of `contigs` (host pass, then the k-mer containment
collapse) byte-identical to the JAX CLI's.  The 20 kb, 2,400-read
end-to-end case runs in chip_smoke.py, card against CPU.  The port runs
on the CPU.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.assembly import assemble as jas
from biokanga_tpu.assembly import scale_overlap as jso
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.encode import revcomp
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.assembly import assemble as tas
from biokanga_tpu_torch.assembly import scale_overlap as tso
from biokanga_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _reads(glen, n, seed, sub, rc):
    g = random_genome([("chr1", glen)], seed=seed)[0][1]
    _, reads, _ = simulate_reads([("chr1", g)], n, read_len=100,
                                 sub_rate=sub, seed=seed + 2)
    reads = [np.asarray(r, np.int8) for r in reads]
    if rc:
        rng = np.random.default_rng(0)
        reads = [revcomp(r) if rng.random() < 0.5 else r for r in reads]
    return reads


CASES = {"clean": (8_000, 600, 3, 0.0, False),
         "errors_rc": (6_000, 500, 11, 0.005, True)}


def _same_seqs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_edges_and_scaled_pass_match_jax(case):
    reads = _reads(*CASES[case])
    want = jso.best_right_extensions(reads, 40)
    got = tso.best_right_extensions(reads, 40, device=CPU)
    for f in ("win_q", "win_ov", "win_subs", "ambiguous"):
        w = getattr(want, f)
        assert getattr(got, f).dtype == w.dtype, f
        np.testing.assert_array_equal(getattr(got, f), w, err_msg=f)
    assert (want.win_q >= 0).sum() > len(reads) and want.ambiguous.any()
    a, ma = jas.one_pass_scaled([r.copy() for r in reads], 40)
    b, mb = tas.one_pass_scaled([r.copy() for r in reads], 40, device=CPU)
    assert mb == ma > 0
    _same_seqs(a, b)


def test_scaled_assembly_matches_jax():
    reads = _reads(*CASES["clean"])
    want, ws = jas.assemble(reads, scaled=True, max_passes=6)
    got, gs = tas.assemble(reads, scaled=True, max_passes=6, device=CPU)
    _same_seqs(want, got)
    assert vars(gs) == vars(ws) and ws.merges > len(reads) // 2
    g = random_genome([("chr1", 8_000)], seed=3)[0][1].tobytes()
    assert all(c.tobytes() in g or revcomp(c).tobytes() in g for c in got)


def test_contigs_cli_matches_jax(tmp_path):
    """contigs: long corrected-read-like sequences with indels."""
    rng = np.random.default_rng(6)
    g = random_genome([("g", 3_000)], seed=6)[0][1]
    longs = []
    for s in range(0, 2_400, 200):
        r = g[s:s + 600].copy()
        r = np.delete(r, rng.integers(0, len(r), 2))
        longs.append(revcomp(r) if s % 600 == 0 else r)
    write_fasta(str(tmp_path / "ec.fa"), ((f"ec{i}", r) for i, r in
                                          enumerate(longs)))
    for extra in ([], ["--no-kmer-dedup"]):
        args = ["-i", str(tmp_path / "ec.fa"), "--min-overlap", "300",
                "--final-overlap", "200"] + extra
        assert jax_main(["contigs", "-o", str(tmp_path / "jc.fa")]
                        + args) == 0
        assert torch_main(["contigs", "-o", str(tmp_path / "tc.fa"),
                           "--device", "cpu"] + args) == 0
        assert (tmp_path / "tc.fa").read_bytes() == \
            (tmp_path / "jc.fa").read_bytes()
