"""`python -m biokanga_tpu_torch index` against `python -m biokanga_tpu
index`.

Both CLIs index the same FASTA files (two files, four entries, Ns, one
entry in lower case) and the synthetic genome of `-m 2`; every array of
the two `.npz` files and every meta field but `created_unix` must be
equal.  The port's index must give the JAX `align` the SAM of the JAX
index, byte for byte, and the `-q` rows of both CLIs must be equal
outside their time fields.
"""
import json
import shutil

import numpy as np
import pytest

from options_reads import sumrslts_rows

from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.cli import main as torch_main


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_index")
    seqs = random_genome([("chr1", 40_000), ("chr2", 15_000),
                          ("plasmid", 3_000), ("chr3", 22_000)], seed=8)
    seqs[1][1][7_000:7_050] = 4
    write_fasta(str(d / "a.fa"), seqs[:2])
    write_fasta(str(d / "b.fa"), seqs[2:])
    text = (d / "b.fa").read_text().splitlines()
    (d / "b.fa").write_text("\n".join(
        ln if ln.startswith(">") else ln.lower() for ln in text) + "\n")
    return d, seqs


def _index_file(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(z["meta"].tobytes().decode())
    assert meta.pop("created_unix") > 0
    return arrays, meta


def _assert_same_index(a, b):
    arr_a, meta_a = _index_file(a)
    arr_b, meta_b = _index_file(b)
    assert meta_a == meta_b
    assert sorted(arr_a) == sorted(arr_b)
    for k in arr_a:
        assert arr_a[k].dtype == arr_b[k].dtype, k
        np.testing.assert_array_equal(arr_a[k], arr_b[k], err_msg=k)


def _both(argv, out):
    """Run the JAX CLI, then the port's, on the same arguments and output
    path; returns the two files (the JAX one renamed)."""
    assert jax_main(["index"] + argv + ["-o", str(out)]) == 0
    jax_out = out.with_name("jax_" + out.name)
    shutil.move(out, jax_out)
    assert torch_main(["index"] + argv + ["-o", str(out)]) == 0
    return jax_out, out


def test_index_of_two_fasta_files_equals_jax(fastas):
    d, seqs = fastas
    jax_out, torch_out = _both(["-i", str(d / "a.fa"), "-i", str(d / "b.fa"),
                                "--lut-bases", "0", "-r", "mixed"],
                               d / "two.npz")
    _assert_same_index(jax_out, torch_out)
    arrays, meta = _index_file(torch_out)
    assert meta["entry_names"] == ["chr1", "chr2", "plasmid", "chr3"]
    assert meta["lut_bases"] == 10
    assert len(arrays["codes"]) == sum(len(s) for _, s in seqs)


def test_synthetic_index_equals_jax(fastas):
    d, _ = fastas
    jax_out, torch_out = _both(["-m", "2", "-s", "1", "--lut-bases", "9"],
                               d / "synth.npz")
    _assert_same_index(jax_out, torch_out)
    arrays, meta = _index_file(torch_out)
    assert meta["entry_names"] == ["synth"]
    assert len(arrays["codes"]) == 1_000_000


def test_port_index_gives_the_jax_sam(fastas):
    d, seqs = fastas
    jax_out, torch_out = _both(["-i", str(d / "a.fa"), "-i", str(d / "b.fa"),
                                "--lut-bases", "9"], d / "ref.npz")
    names, reads, _ = simulate_reads(seqs, 300, read_len=100, sub_rate=0.01,
                                     seed=4)
    write_fastq(str(d / "reads.fq"),
                ((n, r, None) for n, r in zip(names, reads)))
    sams = []
    for idx in (jax_out, torch_out):
        out = d / f"{idx.stem}.sam"
        assert jax_main(["align", "-i", str(d / "reads.fq"), "-I", str(idx),
                         "-o", str(out)]) == 0
        sams.append(out.read_bytes())
    assert sams[0] == sams[1]
    assert sams[0].count(b"\t60\t100M\t") > 250


def test_index_sumrslts_rows_equal_jax(fastas):
    d, _ = fastas
    for who, main in (("jax", jax_main), ("torch", torch_main)):
        out = d / "q.npz"
        assert main(["index", "-i", str(d / "a.fa"), "-o", str(out),
                     "--lut-bases", "8", "-q", str(d / f"{who}.db")]) == 0
        out.unlink()
    rows = sumrslts_rows(d / "torch.db")
    assert rows == sumrslts_rows(d / "jax.db")
    assert ("entries", "2") in [r[3:] for r in rows[3]]
