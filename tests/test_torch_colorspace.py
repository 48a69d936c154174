"""SOLiD colorspace mode of the port against the JAX package.

The colour transform, the `.csfasta` reader and writer (a round trip
through both packages), the colorspace index file, the two-pass
aligner's result dict and the CLI's `index -C` and `align` outputs (SAM
and BAM) must equal the JAX package's exactly.  Colour reads come from
the JAX CLI's `simreads -C` (primer T; both strands), from a seed, with
a few no-calls and a read of no-calls added.  The port runs on the CPU, its kernels' plain
versions.
"""
import json

import numpy as np
import pytest
import torch

from biokanga_tpu.align.colorspace import ColorspaceAligner as JaxCS
from biokanga_tpu.align.colorspace import reverse_rows as jax_reverse_rows
from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.align.pipeline import AlignEngine as JaxEngine
from biokanga_tpu.align.pipeline import pad_rows
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.index import build as jax_build
from biokanga_tpu.index.device import to_device as jax_to_device
from biokanga_tpu.seq import encode as jax_encode
from biokanga_tpu.seq import fasta as jax_fasta
from biokanga_tpu.sim.simreads import random_genome
from biokanga_tpu_torch.align.colorspace import ColorspaceAligner, reverse_rows
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pipeline import AlignEngine
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.index import build as torch_build
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.seq import encode as torch_encode
from biokanga_tpu_torch.seq import fasta as torch_fasta

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cs")
    seqs = random_genome([("chrA", 30_000), ("chrB", 20_000)], seed=5)
    seqs[1][1][3_000:3_020] = 4
    jax_fasta.write_fasta(str(d / "g.fa"), seqs)
    assert jax_main(["simreads", "-i", str(d / "g.fa"), "-o",
                     str(d / "sim.csfasta"), "-n", "300", "-l", "75", "-C",
                     "--seed", "6"]) == 0
    # no-calls, and one record a line of another shape: a read of Ns
    text = (d / "sim.csfasta").read_text().splitlines()
    rng = np.random.default_rng(2)
    for i in range(1, len(text), 26):
        p = int(rng.integers(3, 60))
        text[i] = text[i][:p] + "." + text[i][p + 1:]
    text += [">allN", "T" + "." * 74]
    (d / "reads.csfasta").write_text("\n".join(text) + "\n")
    return d, seqs


def test_colour_transform_matches_jax():
    codes = np.random.default_rng(3).integers(0, 5, 400).astype(np.int8)
    np.testing.assert_array_equal(torch_encode.to_colorspace(codes),
                                  jax_encode.to_colorspace(codes))
    np.testing.assert_array_equal(torch_encode.to_colorspace(codes[:1]),
                                  jax_encode.to_colorspace(codes[:1]))


def test_csfasta_round_trip_matches_jax(sample, tmp_path):
    rng = np.random.default_rng(4)
    recs = [(f"r{i}", rng.integers(0, 5, int(rng.integers(1, 90))).astype(
        np.int8)) for i in range(40)]
    jax_fasta.write_csfasta(str(tmp_path / "j.csfasta"), recs)
    torch_fasta.write_csfasta(str(tmp_path / "t.csfasta"), recs)
    assert (tmp_path / "t.csfasta").read_bytes() == \
        (tmp_path / "j.csfasta").read_bytes()
    d, _ = sample
    for path in (str(tmp_path / "j.csfasta"), str(d / "reads.csfasta")):
        want = list(jax_fasta.read_csfasta(path))
        got = list(torch_fasta.read_csfasta(path))
        assert [r.name for r in got] == [r.name for r in want]
        for g, w in zip(got, want):
            assert g.codes.dtype == w.codes.dtype
            np.testing.assert_array_equal(g.codes, w.codes)
        for g, w in zip(torch_fasta.read_csfasta_blocks(path, 64),
                        jax_fasta.read_csfasta_blocks(path, 64)):
            assert g.names == w.names
            np.testing.assert_array_equal(g.codes, w.codes)
            np.testing.assert_array_equal(g.lengths, w.lengths)


def test_reverse_rows_matches_jax():
    rng = np.random.default_rng(5)
    reads = rng.integers(0, 5, (30, 40)).astype(np.int8)
    lens = rng.integers(0, 41, 30).astype(np.int32)
    np.testing.assert_array_equal(reverse_rows(reads, lens),
                                  jax_reverse_rows(reads, lens))


@pytest.mark.parametrize("opts", [{}, {"max_subs_per100": 4, "max_multi": 2,
                                       "min_edit_dist": 2}])
def test_aligner_result_matches_jax(sample, opts):
    d, seqs = sample
    idx = jax_build.build_colorspace_index(seqs, lut_bases=8)
    blk = next(jax_fasta.read_csfasta_blocks(str(d / "reads.csfasta"), 512))
    codes, lens = pad_rows(blk.codes, blk.lengths)
    want = JaxCS(JaxEngine(jax_to_device(idx), JaxParams(
        strand="sense", **opts))).align_batch(codes, lens)
    tidx = torch_build.build_colorspace_index(seqs, lut_bases=8)
    assert tidx.space == "color"
    got = ColorspaceAligner(AlignEngine(to_device(tidx, CPU), AlignParams(
        strand="sense", **opts))).align_batch(codes, lens)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    n = len(blk.names)
    assert want["unique"][:n].mean() > 0.8 and want["is_rc"][:n].any()


@pytest.mark.parametrize("out", ["o.sam", "o.bam"])
def test_cli_index_and_align_match_jax(sample, tmp_path, out):
    d, _ = sample
    for main, tag in ((jax_main, "j"), (torch_main, "t")):
        assert main(["index", "-C", "-i", str(d / "g.fa"), "-o",
                     str(tmp_path / f"{tag}.npz"), "--lut-bases", "8"]) == 0
    with np.load(tmp_path / "j.npz") as za, np.load(tmp_path / "t.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        ma = json.loads(za["meta"].tobytes().decode())
        mb = json.loads(zb["meta"].tobytes().decode())
        assert ma.pop("created_unix") > 0 and mb.pop("created_unix") > 0
        assert ma == mb and ma["space"] == "color"
        for k in set(za.files) - {"meta"}:
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    common = ["-i", str(d / "reads.csfasta"), "-I", str(tmp_path / "t.npz"),
              "--batch-size", "100"]
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
