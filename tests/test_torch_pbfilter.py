"""The rest of the PacBio family against the JAX package: `pbfilter`
(SMRTbell adapter removal) and resumable error correction
(`ecreads --checkpoint-dir`).

pbfilter: reads with zero, one and two retained adapters (exact and with
up to 9 mismatches), short flanks and ragged ends, made from a seed; the
hits, the split subreads, the stats and the CLI's FASTA must equal the
JAX package's.  Checkpointed EC: the 12 noisy long reads of
tests/test_torch_ecreads.py; the JAX package's `ec_reads_checkpointed`
is the oracle, and the port's unbroken run, a run resumed after half its
group files were deleted, and the CLI's FASTA must all equal it.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_ecreads import params, twelve_reads

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.pacbio import ecreads as jax_ec
from biokanga_tpu.pacbio import pbfilter as jax_pb
from biokanga_tpu.seq.fasta import write_fasta
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.pacbio import ecreads as port_ec
from biokanga_tpu_torch.pacbio import pbfilter as port_pb
from biokanga_tpu_torch.seq.encode import ascii_to_codes

torch.set_num_threads(2)


def _reads(seed):
    rng = np.random.default_rng(seed)
    ad = ascii_to_codes(port_pb.SMRTBELL.encode())
    out = []
    for i in range(40):
        parts = [rng.integers(0, 4, int(rng.integers(100, 900))).astype(
            np.int8)]
        for _ in range(i % 3):
            a = ad.copy()
            for p in rng.choice(len(a), int(rng.integers(0, 11)),
                                replace=False):
                a[p] = (a[p] + 1) % 4
            parts += [a, rng.integers(0, 4, int(rng.integers(30, 800))
                                      ).astype(np.int8)]
        r = np.concatenate(parts)
        r[rng.random(len(r)) < 0.002] = 4
        out.append((f"pb{i}", r))
    return out


@pytest.mark.parametrize("kw", [{}, {"min_subread_len": 200, "trim_ends": 7,
                                     "max_adapter_mm": 5}])
def test_pb_filter_matches_jax(kw):
    reads = _reads(3)
    want, ws = jax_pb.pb_filter(reads, jax_pb.PBFilterParams(**kw))
    got, gs = port_pb.pb_filter(reads, port_pb.PBFilterParams(**kw))
    assert vars(gs) == vars(ws) and ws.reads_with_adapter > 10
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ad = ascii_to_codes(port_pb.SMRTBELL.encode())
    for _, r in reads[:12]:
        np.testing.assert_array_equal(
            port_pb.find_adapter_hits(r, ad, 9),
            jax_pb.find_adapter_hits(r, ad, 9))


def test_pbfilter_cli_matches_jax(tmp_path):
    write_fasta(str(tmp_path / "raw.fa"), _reads(5))
    args = ["-i", str(tmp_path / "raw.fa"), "--min-subread-len", "300",
            "--trim-ends", "3"]
    assert jax_main(["pbfilter", "-o", str(tmp_path / "j.fa")] + args) == 0
    assert torch_main(["pbfilter", "-o", str(tmp_path / "t.fa")] + args) == 0
    want = (tmp_path / "j.fa").read_bytes()
    assert (tmp_path / "t.fa").read_bytes() == want and want.count(b">") > 40


@pytest.fixture(scope="module")
def jax_checkpointed(tmp_path_factory):
    reads = twelve_reads()
    d = tmp_path_factory.mktemp("jax_ck")
    want, st = jax_ec.ec_reads_checkpointed(reads, params(jax_ec, 100),
                                            checkpoint_dir=str(d / "ck"))
    return reads, want, st["overlaps_used"]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_checkpointed_ec_resumes_to_the_jax_result(jax_checkpointed,
                                                   tmp_path):
    reads, want, overlaps = jax_checkpointed
    ck = str(tmp_path / "ck")
    got, st = port_ec.ec_reads_checkpointed(
        reads, params(port_ec, 100), checkpoint_dir=ck, group=4,
        device="cpu")
    _same(want, got)
    assert st["overlaps_used"] == overlaps > 0
    cells = sorted(f for f in os.listdir(ck) if f.startswith("c"))
    assert len(cells) == 3
    for f in cells[::2]:                       # half the groups lost
        os.remove(os.path.join(ck, f))
    resumed, st2 = port_ec.ec_reads_checkpointed(
        reads, params(port_ec, 100), checkpoint_dir=ck, group=4,
        device="cpu")
    _same(want, resumed)
    assert st2["overlaps_used"] == overlaps
    # one round of ec_reads gives the same reads
    _same(want, port_ec.ec_reads(reads, params(port_ec, 100),
                                 device="cpu")[0])


def test_ecreads_cli_checkpoint_dir(jax_checkpointed, tmp_path):
    reads, want, _ = jax_checkpointed
    names = [f"r{i}" for i in range(len(reads))]
    write_fasta(str(tmp_path / "pb.fa"), zip(names, reads))
    # what the JAX CLI writes: its checkpointed reads under their names
    write_fasta(str(tmp_path / "want.fa"), zip(names, want))
    ck = str(tmp_path / "ck")
    argv = ["ecreads", "-i", str(tmp_path / "pb.fa"), "--min-score", "100",
            "--checkpoint-dir", ck, "--device", "cpu"]
    assert torch_main(argv + ["-o", str(tmp_path / "t1.fa")]) == 0
    assert torch_main(argv + ["-o", str(tmp_path / "t2.fa")]) == 0  # loads
    for f in os.listdir(ck):
        if f.startswith("c"):
            os.remove(os.path.join(ck, f))
    assert torch_main(argv + ["-o", str(tmp_path / "t3.fa")]) == 0
    for k in (1, 2, 3):
        assert (tmp_path / f"t{k}.fa").read_bytes() == \
            (tmp_path / "want.fa").read_bytes()
