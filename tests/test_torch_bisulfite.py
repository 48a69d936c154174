"""Bisulfite mode of the port against the JAX package.

The collapse tables, the (CT, GA) index pair and its file, the
two-engine aligner's result dict and the CLI's `index -m 1` and `align`
outputs (SAM and BAM) must equal the JAX package's exactly.  Reads are
simulated from a seed as tests/test_bisulfite.py simulates them (top and
bottom strand, C->T at 0.98; tests/bs_reads.py), plus a few with Ns and
junk reads.  The port runs on the CPU, its kernels' plain versions.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bs_reads import bs_reads

from biokanga_tpu.align.bisulfite import BisulfiteAligner as JaxBS
from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu.align.pipeline import pad_rows
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.index import build as jax_build
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.seq import encode as jax_encode
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.align.bisulfite import BisulfiteAligner
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import AlignEngine
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.index import build as torch_build
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.seq import encode as torch_encode

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bs")
    seqs = random_genome([("chr1", 50_000), ("chr2", 20_000)], seed=13)
    seqs[1][1][5_000:5_030] = 4
    g = np.concatenate([s for _, s in seqs])
    rng = np.random.default_rng(11)
    names, reads, _, _ = bs_reads(g[:50_000], 300, 100, rng)
    reads[::23, rng.integers(0, 100)] = 4                  # Ns in reads
    reads[5::37] = rng.integers(0, 4, (len(reads[5::37]), 100))  # junk
    write_fasta(str(d / "ref.fa"), seqs)
    write_fastq(str(d / "reads.fq"),
                ((n, r, None) for n, r in zip(names, reads)))
    return d, seqs, reads


def test_collapse_tables_match_jax():
    codes = np.random.default_rng(0).integers(0, 6, 500).astype(np.int8)
    for fn in ("ct_collapse", "ga_collapse"):
        want = getattr(jax_encode, fn)(codes)
        got = getattr(torch_encode, fn)(codes)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_index_pair_and_file_match_jax(sample, tmp_path):
    _, seqs, _ = sample
    jct, jga = jax_build.build_bisulfite_indexes(seqs, lut_bases=8)
    tct, tga = torch_build.build_bisulfite_indexes(seqs, lut_bases=8)
    jax_build.save_bisulfite_index(jct, jga, str(tmp_path / "j.npz"))
    torch_build.save_bisulfite_index(tct, tga, str(tmp_path / "t.npz"))
    _assert_same_file(tmp_path / "j.npz", tmp_path / "t.npz")
    assert torch_build.is_bisulfite_index(str(tmp_path / "j.npz"))
    for a, b in zip(torch_build.load_bisulfite_index(str(tmp_path / "j.npz")),
                    (tct, tga)):
        for f in ("codes", "entry_starts", "pos_sorted", "key_hi", "key_lo",
                  "lut"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.entry_names == b.entry_names and a.lut_bases == b.lut_bases


def _assert_same_file(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        ma = json.loads(za["meta"].tobytes().decode())
        mb = json.loads(zb["meta"].tobytes().decode())
        assert ma.pop("created_unix") > 0 and mb.pop("created_unix") > 0
        assert ma == mb
        for k in za.files:
            if k != "meta":
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("opts", [{}, {"max_subs_per100": 5, "max_multi": 3,
                                       "min_edit_dist": 2}])
def test_aligner_result_matches_jax(sample, opts):
    _, seqs, reads = sample
    ct, ga = jax_build.build_bisulfite_indexes(seqs, lut_bases=8)
    jc = JaxParams(strand="sense", batch_size=64, **opts)
    jbs = JaxBS(JaxEngine(jax_to_device(ct), jc),
                JaxEngine(jax_to_device(ga),
                          dataclasses.replace(jc, strand="antisense")))
    tc = AlignParams(strand="sense", batch_size=64, **opts)
    tbs = BisulfiteAligner(
        AlignEngine(to_device(ct, CPU), tc),
        AlignEngine(to_device(ga, CPU),
                    dataclasses.replace(tc, strand="antisense")))
    codes, lens = pad_rows(reads, np.full(len(reads), 100, np.int32))
    want = jbs.align_batch(codes, lens)
    got = tbs.align_batch(codes, lens)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert want["unique"][:len(reads)].mean() > 0.8


@pytest.mark.parametrize("out", ["o.sam", "o.bam"])
def test_cli_index_and_align_match_jax(sample, tmp_path, out):
    d, _, _ = sample
    for main, tag in ((jax_main, "j"), (torch_main, "t")):
        assert main(["index", "-m", "1", "-i", str(d / "ref.fa"), "-o",
                     str(tmp_path / f"{tag}.npz"), "--lut-bases", "8"]) == 0
    _assert_same_file(tmp_path / "j.npz", tmp_path / "t.npz")
    common = ["-i", str(d / "reads.fq"), "-I", str(tmp_path / "j.npz"),
              "--batch-size", "128"]
    assert jax_main(["align", "-o", str(tmp_path / f"j.{out}")]
                    + common) == 0
    assert torch_main(["align", "-o", str(tmp_path / f"t.{out}"),
                       "--device", "cpu"] + common) == 0
    want = (tmp_path / f"j.{out}").read_bytes()
    assert (tmp_path / f"t.{out}").read_bytes() == want
    if out.endswith(".sam"):
        flags = [ln.split("\t")[1] for ln in want.decode().splitlines()
                 if not ln.startswith("@")]
        assert {"0", "16", "4"} <= set(flags)


def test_aligner_matches_jax_at_bacterial_scale():
    """chip_smoke.py phase 21's genome (4.6 Mbp, random_genome(seed=42)):
    the JAX package's bisulfite path keeps the core length it derives for
    a 4-letter genome, so in the 3-letter collapsed genome every read's
    cores over-occur, are skipped, and most reads get no hit.  The port
    gives the same dicts, so the same low recall."""
    seqs = random_genome([("chr", 4_600_000)], seed=42)
    _, reads, starts, bottom = bs_reads(seqs[0][1], 256, 100,
                                        np.random.default_rng(21))
    ct, ga = jax_build.build_bisulfite_indexes(seqs, lut_bases=10)
    lens = np.full(256, 100, np.int32)
    want = JaxBS(JaxEngine(jax_to_device(ct), JaxParams(strand="sense")),
                 JaxEngine(jax_to_device(ga), JaxParams(strand="antisense"))
                 ).align_batch(reads, lens)
    got = BisulfiteAligner(
        AlignEngine(to_device(ct, CPU), AlignParams(strand="sense")),
        AlignEngine(to_device(ga, CPU), AlignParams(strand="antisense"))
    ).align_batch(reads, lens)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert want["overflow"].all()
    placed = want["unique"]
    assert placed.mean() < 0.5
    assert ((want["locus"] == starts) & (want["is_rc"] == bottom))[
        placed].all()
