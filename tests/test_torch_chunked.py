"""The chunked (genome-range) index and the aligners on it: the port
against the JAX package, tolerance 0.

Seeded numpy genomes with repeats, Ns and entry boundaries inside chunks
go through biokanga_tpu and biokanga_tpu_torch on the CPU:
`merge_chunk_results` on random per-chunk results (ties across chunks,
rows with no valid candidate, saturated next-best values);
`ChunkedAligner` (also against the port's single-index engine), with the
fast pass on and off; the device build of padded chunks (`owned`,
`true_len`, `with_keys`, with and without Ns) and
`DeviceBuildChunkedAligner` with `two_level_chunk_sweep` (clean reads and
12-substitution reads, with and without key arrays) against JAX's sweep
and the port's classic per-chunk merge; `ChunkedPEAligner` with orphans
whose rescue window crosses a chunk cut; `ChunkedExtendedAligner` with
indel and junction reads; checkpointed sweeps resumed; and the CLI:
`index --chunks 3` gives the JAX CLI's file, and `align` on it gives the
JAX CLI's SAM, BAM and SNP CSV byte for byte (SE, PE, -a -A, -O,
--checkpoint-dir resumed).
"""
import numpy as np
import pytest
import torch

from biokanga_tpu.align.params import AlignParams as JaxParams
from biokanga_tpu.align.pe import PEParams as JaxPEParams
from biokanga_tpu.cli import main as jax_main
from biokanga_tpu.index import chunked as jax_chunked
from biokanga_tpu.index import device_build as jax_db
from biokanga_tpu.parallel import chunked as jax_par
from biokanga_tpu.seq.fasta import write_fasta, write_fastq
from biokanga_tpu.sim.simreads import random_genome, simulate_reads
from biokanga_tpu_torch.align.params import AlignParams
from biokanga_tpu_torch.align.pe import PEParams
from biokanga_tpu_torch.align.pipeline import AlignEngine, pad_rows
from biokanga_tpu_torch.cli import main as torch_main
from biokanga_tpu_torch.device import u32_from_key32
from biokanga_tpu_torch.index import chunked as tch
from biokanga_tpu_torch.index import device_build as tdb
from biokanga_tpu_torch.index.build import build_index
from biokanga_tpu_torch.index.device import to_device
from biokanga_tpu_torch.parallel import chunked as tpar
from torch_align_data import KEYS

torch.set_num_threads(2)

CPU = torch.device("cpu")
FIELDS = ("unique", "any_hit", "best_mm", "next_mm", "inst", "locus",
          "is_rc")


def _assert_equal(got: dict, want: dict, keys, where=""):
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (where, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def _genome_with_repeats(seed=11):
    """tests/test_chunked.py's genome: a 600 bp block in three copies and
    50 Ns in each entry."""
    seqs = random_genome(
        [("chr1", 70000), ("chr2", 70000), ("chr3", 60000)], seed=seed
    )
    seg = seqs[0][1][1000:1600].copy()
    seqs[1][1][5000:5600] = seg
    seqs[2][1][30000:30600] = seg
    rng = np.random.default_rng(3)
    for _, s in seqs:
        s[rng.choice(len(s), size=50, replace=False)] = 4
    return seqs


@pytest.fixture(scope="module")
def repeats():
    seqs = _genome_with_repeats()
    _, reads, _ = simulate_reads(seqs, 2000, read_len=100, sub_rate=0.02,
                                 seed=5)
    reads[:32] = np.ascontiguousarray(seqs[0][1][1100:1200])  # multi-hit
    reads[32:40, 10] = 4                                       # Ns
    lengths = np.full(len(reads), 100, np.int32)
    lengths[40:60] = 93                                        # ragged
    reads[40:60, 93:] = 4
    reads, lengths = pad_rows(reads, lengths)
    ci_j = jax_chunked.build_chunked_index(seqs, num_chunks=3, overlap=256)
    ci_t = tch.build_chunked_index(seqs, num_chunks=3, overlap=256)
    return seqs, reads, lengths, ci_j, ci_t


def test_build_chunked_index_matches_jax(repeats):
    *_, ci_j, ci_t = repeats
    assert ci_t.num_chunks == 3 and ci_t.pad_shapes() == ci_j.pad_shapes()
    for f in ("bases", "owned", "entry_starts"):
        np.testing.assert_array_equal(getattr(ci_t, f), getattr(ci_j, f))
    assert (ci_t.entry_names, ci_t.overlap) == (ci_j.entry_names,
                                                ci_j.overlap)
    for a, b in zip(ci_t.chunks, ci_j.chunks):
        for f in ("codes", "entry_starts", "pos_sorted", "key_hi", "key_lo",
                  "lut"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # a chunk on the device: padded arrays, the ownership limit
    jd = jax_chunked.chunk_to_device(ci_j, 1)
    td = tch.chunk_to_device(ci_t, 1, device=CPU)
    for f in ("genome", "entry_starts", "key_hi", "key_lo", "lut"):
        t = getattr(td, f)
        if f.startswith("key_"):
            assert t.dtype == torch.int32
            t = u32_from_key32(t)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jd, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(td.pos_sorted.numpy(),
                                  np.asarray(jd.pos_rows).reshape(-1))
    np.testing.assert_array_equal(td.packed.rows.numpy().view(np.uint32),
                                  np.asarray(jd.packed.rows))
    np.testing.assert_array_equal(td.packed.n_rows.numpy().view(np.uint32),
                                  np.asarray(jd.packed.n_rows))
    assert td.packed.length == jd.packed.length
    assert (td.owned, td.max_bsearch_steps) == (int(jd.owned),
                                                jd.max_bsearch_steps)


def _random_partials(rng, K, B=300, Kml=5):
    """Per-chunk result dicts as an engine gives them: ties of best mm
    across chunks, rows with no valid candidate (255), saturated
    next-best values, multi-hit lists with -1 tails."""
    parts = []
    for _ in range(K):
        best = rng.integers(0, 5, B).astype(np.uint8)
        best[rng.random(B) < 0.2] = 255
        nxt = np.minimum(best.astype(np.int32) + rng.integers(0, 3, B),
                         255).astype(np.uint8)
        ml_mm = np.sort(rng.integers(0, 6, (B, Kml)), axis=1).astype(np.uint8)
        ml_mm[rng.random((B, Kml)) < 0.3] = 255
        ml_mm.sort(axis=1)
        ml_loci = np.where(ml_mm < 255, rng.integers(0, 5000, (B, Kml)),
                           -1).astype(np.int32)
        parts.append({
            "unique": rng.random(B) < 0.5, "any_hit": rng.random(B) < 0.7,
            "best_mm": best, "next_mm": nxt,
            "inst": rng.integers(0, 4, B).astype(np.int32),
            "locus": rng.integers(0, 5000, B).astype(np.int32),
            "is_rc": rng.random(B) < 0.5,
            "overflow": rng.random(B) < 0.1,
            "n_over": rng.integers(0, 3, B).astype(np.int32),
            "cap_trunc": rng.random(B) < 0.05,
            "ml_loci": ml_loci, "ml_mm": ml_mm,
            "ml_rc": (rng.random((B, Kml)) < 0.5) & (ml_mm < 255),
        })
    return parts


@pytest.mark.parametrize("K,med", [(1, 1), (3, 1), (4, 2)])
def test_merge_chunk_results_matches_jax(K, med):
    rng = np.random.default_rng(K)
    parts = _random_partials(rng, K)
    bases = np.arange(K, dtype=np.int64) * 2_400_000_000   # past 2^31
    lengths = rng.integers(60, 150, 300).astype(np.int32)
    want = jax_par.merge_chunk_results(parts, bases, lengths,
                                       JaxParams(min_edit_dist=med))
    got = tpar.merge_chunk_results(parts, bases, lengths,
                                   AlignParams(min_edit_dist=med))
    assert sorted(got) == sorted(want)
    _assert_equal(got, want, want.keys())
    if K > 1:
        assert got["locus"].max() > 2**31


@pytest.mark.parametrize("fast_pass", [False, True])
def test_chunked_aligner_matches_jax_and_single_index(repeats, fast_pass):
    seqs, reads, lengths, ci_j, ci_t = repeats
    n = len(reads)
    want = jax_par.ChunkedAligner(
        ci_j, JaxParams(batch_size=n, fast_pass=fast_pass)).align(reads,
                                                                 lengths)
    params = AlignParams(batch_size=n, fast_pass=fast_pass)
    got = tpar.ChunkedAligner(ci_t, params, device="cpu").align(reads,
                                                                lengths)
    _assert_equal(got, want, KEYS)
    # the exact merge reproduces the unchunked index (the multi-hit tail
    # past the tied best only in single-level mode, as in the JAX tests)
    single = AlignEngine(to_device(build_index(seqs), CPU),
                         params).align_with_rescue(reads, lengths)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], single[k], err_msg=k)
    keep = (single["ml_mm"] == single["best_mm"][:, None]) if fast_pass \
        else single["ml_mm"] != 255
    np.testing.assert_array_equal(got["ml_mm"][keep],
                                  single["ml_mm"][keep])
    np.testing.assert_array_equal(got["ml_loci"][keep],
                                  single["ml_loci"][keep])
    assert (got["inst"][:32] >= 3).all() and got["unique"].mean() > 0.9


@pytest.mark.parametrize("with_n,with_keys", [(False, True), (True, True),
                                              (True, False)])
def test_device_build_of_a_padded_chunk_matches_jax(with_n, with_keys):
    """device_build_index on an N-padded chunk slice: the N plane only
    when the interior holds N, the packed length the true length, a
    LUT-only index with one-element key tensors."""
    rng = np.random.default_rng(7)
    true_len, pad_n = 30_000, 30_208
    codes = np.full(pad_n, 4, np.int8)
    codes[:true_len] = rng.integers(0, 4, true_len)
    if with_n:
        codes[rng.choice(true_len, 40, replace=False)] = 4
    es = np.array([0, 12_000, true_len, true_len], np.int64)
    want = jax_db.device_build_index(codes, es, lut_bases=8, owned=28_000,
                                     true_len=true_len, with_keys=with_keys)
    got = tdb.device_build_index(codes, es, lut_bases=8, owned=28_000,
                                 device="cpu", true_len=true_len,
                                 with_keys=with_keys)
    for f in ("genome", "entry_starts", "key_hi", "key_lo", "lut"):
        t = getattr(got, f)
        if f.startswith("key_"):
            assert t.dtype == torch.int32
            t = u32_from_key32(t)
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, f),
                                                 np.int64), err_msg=f)
    np.testing.assert_array_equal(got.pos_sorted.numpy(),
                                  np.asarray(want.pos_rows).reshape(-1))
    assert got.key_hi.shape[0] == (pad_n if with_keys else 1)
    np.testing.assert_array_equal(got.packed.rows.numpy().view(np.uint32),
                                  np.asarray(want.packed.rows))
    assert (got.packed.n_rows is None) == (want.packed.n_rows is None) \
        == (not with_n)
    if with_n:
        np.testing.assert_array_equal(
            got.packed.n_rows.numpy().view(np.uint32),
            np.asarray(want.packed.n_rows))
    assert got.packed.length == want.packed.length == true_len
    assert (got.owned, got.max_bsearch_steps) == (28_000,
                                                  want.max_bsearch_steps)


def _sweep_setup(seed, heavy_frac, lut_bases, with_keys):
    """tests/test_two_level_sweep.py's setup: 280 kb in two entries, 1,024
    reads, chunks of at most 100 kb (three, cut inside an entry)."""
    seqs = random_genome([("c1", 150_000), ("c2", 130_000)], seed=seed)
    seqs[1][1][60_000:60_050] = 4
    _, reads, _ = simulate_reads(seqs, 1024, read_len=100, sub_rate=0.01,
                                 seed=seed + 1)
    if heavy_frac:
        rng = np.random.default_rng(seed + 2)
        for i in np.nonzero(rng.random(len(reads)) < heavy_frac)[0]:
            mut = rng.random(100) < 0.12   # ~12 subs: past the fast bound
            reads[i, mut] = (reads[i, mut] + rng.integers(
                1, 4, mut.sum())) % 4
    lengths = np.full(len(reads), 100, np.int32)
    blocks = [pad_rows(reads[i:i + 512], lengths[i:i + 512])
              for i in range(0, len(reads), 512)]
    kw = dict(max_chunk=100_000, overlap=512, lut_bases=lut_bases,
              with_keys=with_keys)
    return (jax_db.DeviceBuildChunkedAligner(seqs, JaxParams(batch_size=512),
                                             **kw),
            tdb.DeviceBuildChunkedAligner(seqs, AlignParams(batch_size=512),
                                          device="cpu", **kw),
            blocks)


@pytest.mark.parametrize("case,lut_bases,with_keys", [
    ("clean", 8, None), ("heavy", 8, None), ("clean", 10, False),
    ("heavy", 10, True)])
def test_two_level_chunk_sweep_matches_jax(case, lut_bases, with_keys):
    heavy = 0.15 if case == "heavy" else 0.0
    ca_j, ca_t, blocks = _sweep_setup(47 if heavy else 31, heavy, lut_bases,
                                      with_keys)
    assert ca_t.num_chunks == 3 and ca_t.pad_n == ca_j.pad_n
    assert ca_t._auto_with_keys() == ca_j._auto_with_keys()
    want = jax_par.two_level_chunk_sweep(ca_j, blocks)
    got = tpar.two_level_chunk_sweep(ca_t, blocks)
    classic = ca_t.align_blocks(blocks)
    for g, w, c in zip(got, want, classic):
        _assert_equal(g, w, KEYS, "jax sweep")
        for k in FIELDS:
            np.testing.assert_array_equal(g[k], c[k], err_msg=f"classic {k}")
    if ca_t._auto_with_keys() is False:
        assert ca_t._engine.didx.key_hi.shape[0] == 1


def test_checkpointed_sweeps_resume_to_the_same_result(tmp_path):
    ca_j, ca_t, blocks = _sweep_setup(31, 0.0, 8, None)
    fresh = tpar.two_level_chunk_sweep(ca_t, blocks)
    ck = str(tmp_path / "two_level")
    tpar.two_level_chunk_sweep(ca_t, blocks, checkpoint_dir=ck)
    resumed = tpar.two_level_chunk_sweep(ca_t, blocks, checkpoint_dir=ck)
    ck2 = str(tmp_path / "blocks")
    first = ca_t.align_blocks(blocks, checkpoint_dir=ck2)
    built = len(ca_t.build_s)
    again = ca_t.align_blocks(blocks, checkpoint_dir=ck2)
    assert len(ca_t.build_s) == built      # every cell from the disk
    for f, r, a, b in zip(fresh, resumed, first, again):
        _assert_equal(r, f, KEYS, "two-level resumed")
        _assert_equal(b, a, KEYS, "align_blocks resumed")


def _kill_seeds(r):
    """A substitution in every seed core: no seed hit, within the budget."""
    r = r.copy()
    r[4:93:11] = (r[4:93:11] + 1) % 4
    return r


@pytest.fixture(scope="module")
def pe_case():
    """Pairs of 2 x 100 bp on three chunks; seed-dead mates whose anchors
    lie just below each chunk cut, so that their rescue windows cross the
    cut, and mates in a three-copy repeat."""
    seqs = random_genome([("chrA", 50_000), ("chrB", 40_000)], seed=55)
    g = seqs[0][1]
    g[25_000:25_300] = g[5_000:5_300]
    seqs[1][1][12_000:12_300] = g[5_000:5_300]
    cat = np.concatenate([s for _, s in seqs])
    _, reads, _ = simulate_reads(seqs, 96, read_len=100, sub_rate=0.01,
                                 seed=12, pe=True, insert_min=200,
                                 insert_max=500)
    r1, r2 = reads[0::2].copy(), reads[1::2].copy()
    rc = lambda x: np.where(x >= 4, x, 3 - x)[::-1]
    ci_t = tch.build_chunked_index(seqs, num_chunks=3, overlap=1024,
                                   lut_bases=8)
    for i, cut in enumerate(ci_t.bases[1:]):
        for j, back in enumerate((150, 300, 420)):
            s, ins = int(cut) - back, 440
            a, b = cat[s:s + 100], rc(cat[s + ins - 100:s + ins])
            r1[6 * i + 2 * j], r2[6 * i + 2 * j] = a, _kill_seeds(b)
            # minus fragment: the reverse mate anchors, its window ends
            # past the cut
            r1[6 * i + 2 * j + 1] = _kill_seeds(b)
            r2[6 * i + 2 * j + 1] = a
    for i, c in enumerate((5_000, 25_000)):
        r1[20 + i] = cat[c + 40:c + 140]
        r2[20 + i] = rc(cat[c + 40 + 320:c + 40 + 420])
    ci_j = jax_chunked.build_chunked_index(seqs, num_chunks=3, overlap=1024,
                                           lut_bases=8)
    lengths = np.full(len(r1), 100, np.int32)
    r1, l1 = pad_rows(r1, lengths)
    r2, l2 = pad_rows(r2, lengths)
    return ci_j, ci_t, r1, l1, r2, l2


def test_chunked_pe_aligner_matches_jax(pe_case):
    ci_j, ci_t, r1, l1, r2, l2 = pe_case
    kw = dict(pair_min_len=100, pair_max_len=600)
    want = jax_par.ChunkedPEAligner(jax_par.ChunkedAligner(ci_j),
                                    JaxPEParams(**kw)).align_pairs(
        r1, l1, r2, l2)
    got = tpar.ChunkedPEAligner(tpar.ChunkedAligner(ci_t, device="cpu"),
                                PEParams(**kw)).align_pairs(r1, l1, r2, l2)
    for side in ("res1", "res2"):
        _assert_equal(got[side], want[side], KEYS, side)
    _assert_equal(got, want, ("proper", "orphan1", "orphan2", "insert"))
    assert got["proper"][:12].all()        # every window across a cut
    assert not got["orphan1"][:12].any() and not got["orphan2"][:12].any()


def test_chunked_extended_aligner_matches_jax():
    """-a/-A over chunks: deletion reads and 5 kb junction reads, some of
    them across a chunk cut (tests/test_chunked.py's case)."""
    seqs = random_genome([("c1", 60000)], seed=17)
    s = seqs[0][1]
    L = 100
    rows = []
    for st in list(range(200, 200 + 40 * 400, 400)) + [19_950, 39_960]:
        w = s[st:st + L + 3]       # a 3-base deletion mid read
        rows.append(np.concatenate([w[:50], w[53:]]))
    for st in list(range(30000, 30000 + 24 * 50, 50)) + [14_990]:
        rows.append(np.concatenate([s[st:st + 50],
                                    s[st + 5050:st + 5000 + L]]))
    reads = np.stack(rows).astype(np.int8)
    lengths = np.full(len(reads), L, np.int32)
    reads, lengths = pad_rows(reads, lengths)
    params = dict(micro_indel_len=9, splice_junct_len=50_000)
    ci_j = jax_chunked.build_chunked_index(seqs, num_chunks=3, overlap=8192,
                                           lut_bases=10)
    ci_t = tch.build_chunked_index(seqs, num_chunks=3, overlap=8192,
                                   lut_bases=10)
    want = jax_par.ChunkedExtendedAligner(
        jax_par.ChunkedAligner(ci_j, JaxParams(batch_size=len(reads))),
        **params).align(reads, lengths)
    got = tpar.ChunkedExtendedAligner(
        tpar.ChunkedAligner(ci_t, AlignParams(batch_size=len(reads)),
                            device="cpu"), **params).align(reads, lengths)
    _assert_equal(got, want, KEYS + ("cigar_op", "op_len", "split"))
    assert got["unique"][:67].sum() > 60 and got["cigar_op"].any()


# ------------------------------------------------------------------ CLI --

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A 70 kb genome with a repeat and planted SNPs; single reads (some
    with a deletion), pairs (some seed-dead, so the rescue runs), and the
    JAX CLI's `index --chunks 3` file."""
    from biokanga_tpu.sim.simreads import plant_snps

    d = tmp_path_factory.mktemp("torch_chunked_cli")
    seqs = random_genome([("chr1", 40_000), ("chr2", 30_000)], seed=21)
    seqs[0][1][20_000:20_300] = seqs[1][1][5_000:5_300]
    mut, _ = plant_snps(seqs, snp_rate_per_mbp=600, seed=2)
    write_fasta(str(d / "ref.fa"), seqs)
    names, reads, _ = simulate_reads(mut, 2_000, read_len=100,
                                     sub_rate=0.005, seed=6)
    cat = np.concatenate([s for _, s in mut])
    for i, st in enumerate(range(1_000, 61_000, 3_000)):
        w = cat[st:st + 104]
        reads[7 * i] = np.concatenate([w[:40], w[44:]])
    write_fastq(str(d / "r.fq"), ((n, r, None) for n, r in zip(names, reads)))
    pn, pr, _ = simulate_reads(mut, 600, read_len=100, sub_rate=0.01,
                               seed=7, pe=True, insert_min=200,
                               insert_max=400)
    p1, p2 = pr[0::2].copy(), pr[1::2].copy()
    p2[::9] = np.stack([_kill_seeds(r) for r in p2[::9]])
    write_fastq(str(d / "p1.fq"), ((n, r, None) for n, r in
                                   zip(pn[0::2], p1)))
    write_fastq(str(d / "p2.fq"), ((n, r, None) for n, r in
                                   zip(pn[1::2], p2)))
    assert jax_main(["index", "-i", str(d / "ref.fa"), "-o",
                     str(d / "jax.npz"), "--chunks", "3", "--chunk-overlap",
                     "1024", "--lut-bases", "10"]) == 0
    return d


def test_chunked_index_file_equals_jax_cli(cli_inputs):
    d = cli_inputs
    assert torch_main(["index", "-i", str(d / "ref.fa"), "-o",
                       str(d / "torch.npz"), "--chunks", "3",
                       "--chunk-overlap", "1024", "--lut-bases", "10"]) == 0
    import json

    with np.load(d / "jax.npz") as zj, np.load(d / "torch.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            if k != "meta":
                assert zt[k].dtype == zj[k].dtype, k
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        mj = json.loads(zj["meta"].tobytes().decode())
        mt = json.loads(zt["meta"].tobytes().decode())
    mj.pop("created_unix"), mt.pop("created_unix")
    assert mt == mj and mt["num_chunks"] == 3


@pytest.mark.parametrize("case", ["se", "se-bam", "pe", "indel-splice",
                                  "snp", "checkpoint"])
def test_chunked_align_is_byte_identical_to_jax_cli(cli_inputs, case,
                                                     tmp_path):
    d = cli_inputs
    ext = ".bam" if case == "se-bam" else ".sam"
    if case == "pe":
        reads = ["-i", str(d / "p1.fq"), "-u", str(d / "p2.fq"), "-d",
                 "150", "-D", "450", "--peinsertdist", "INS"]
    else:
        reads = ["-i", str(d / "r.fq")]
    extra = {"indel-splice": ["-a", "10", "-A", "5000"],
             "snp": ["-O", "SNP", "-a", "10", "--snpvcf", "VCF"],
             "checkpoint": ["--checkpoint-dir", "CK"]}.get(case, [])
    outs = {}
    for who, main, dev in (("jax", jax_main, []),
                           ("torch", torch_main, ["--device", "cpu"])):
        names = {"INS": tmp_path / f"{who}_ins.csv",
                 "SNP": tmp_path / f"{who}_snps.csv",
                 "VCF": tmp_path / f"{who}.vcf",
                 "CK": tmp_path / f"{who}_ck"}
        argv = [str(names.get(a, a)) for a in reads + extra]
        out = tmp_path / f"{who}{ext}"
        assert main(["align", "-I", str(d / "jax.npz"), "-o", str(out),
                     "--batch-size", "512"] + argv + dev) == 0
        outs[who] = (out, names)
    (jo, jn), (to, tn) = outs["jax"], outs["torch"]
    assert to.read_bytes() == jo.read_bytes()
    records = [ln for ln in jo.read_bytes().splitlines()
               if not ln.startswith(b"@")] if ext == ".sam" else []
    if case == "pe":                       # the chunked branch writes none
        assert not jn["INS"].exists() and not tn["INS"].exists()
        assert sum(int(r.split(b"\t")[1]) & 2 != 0 for r in records) > 1000
    if case == "snp":
        assert tn["SNP"].read_bytes() == jn["SNP"].read_bytes()
        assert len(jn["SNP"].read_bytes().splitlines()) > 10
        assert not jn["VCF"].exists() and not tn["VCF"].exists()
    if case == "indel-splice":
        assert any(b"D" in r.split(b"\t")[5] for r in records)
    if case == "checkpoint":
        sam = to.read_bytes()
        assert any(p.suffix == ".npz" for p in tn["CK"].iterdir())
        assert torch_main(["align", "-I", str(d / "jax.npz"), "-o",
                           str(tmp_path / "resumed.sam"), "--batch-size",
                           "512", "-i", str(d / "r.fq"), "--checkpoint-dir",
                           str(tn["CK"]), "--device", "cpu"]) == 0
        assert (tmp_path / "resumed.sam").read_bytes() == sam


def test_chunked_align_never_replaces_cuda_by_the_cpu(cli_inputs,
                                                      monkeypatch):
    d = cli_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_main(["align", "-i", str(d / "r.fq"), "-I",
                    str(d / "jax.npz"), "-o", str(d / "x.sam")])
    assert not (d / "x.sam").exists()
