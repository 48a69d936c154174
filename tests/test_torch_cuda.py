"""The port's CUDA kernels and CLI on the card, against the plain paths.

Every test here needs a CUDA card and skips without one.  The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel wrapper must launch its kernel (its launch count rises by
one) and agree exactly with its plain torch version on the same card
tensors; the CLI's SAM with `--device cuda` must equal the SAM with
`--device cpu` byte for byte on a repeat-rich genome, and so must the
error-corrected FASTA, and the paired-end SAM with its insert-size CSV
on pairs that need the orphan rescue, and the SAM and side files of
`-O -a -A -C`, and of the chunked-index `align` (SE with `-a -A -O`, PE,
and 6 kb reads); the consensus call breaks ties towards the first maximum
on the card as on the CPU; the indel and splice scans, the SNP pileup,
the dense extension, the device index build of a padded chunk and the
long-read aligner on CUDA tensors equal them on CPU tensors; the
windowed extension (#3w) equals its plain version on
tests/win_edge_cases.py, the pair sort its plain version past 16,384
pairs, and the bisulfite and colorspace CLI and the scaled assembly on
the card equal the CPU's; the uhamming sweep (#7) and the blitz chain DP
(#8) equal their plain versions, and `uhamming`, `blitz`,
`mergeoverlaps` and `findapproxmatches` on the card equal the CPU's; the
contaminant vector screen on two full blocks and a partial one, and
`filter -c` and `ngsqc -c`, on the card equal the CPU's; the octamer
gather, `predconfnucs` and `genstructprofile` on the card equal the CPU's.
"""
import numpy as np
import pytest
import torch

from biokanga_tpu_torch.ops import banded_sw as bsw
from biokanga_tpu_torch.ops import extend_packed as ep
from biokanga_tpu_torch.ops import sort, stream_gather, sw_trace

I32_MAX = 2**31 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _values(rng, B, C):
    x = rng.integers(-2**31, 2**31, size=(B, C), dtype=np.int64)
    x = x.astype(np.int32)
    r = rng.random((B, C))
    x[r < 0.2] = rng.integers(0, 16, size=int((r < 0.2).sum()))
    x[r > 0.75] = I32_MAX
    return x


# the sort kernels' dispatch: one warp a row up to 1,024 values (512
# pairs), one warp a block and one wave of blocks (at most 132 SMs x 32
# blocks on an H100), each walking rows grid-stride; one block a row past
# that.  The warp kernel holds V = 1, 2, 4, ... values a lane, the least V
# with 32 V >= C: the one-key sort switches at 32, 64, 128, 256 and 512
# values, the pair sort at 32, 64, 128 and 256 pairs.  The widths sit on
# each side of every switch, and 4,225 rows make some warp take a second
# row.
SORT_BATCHES = (1, 7, 4_225)


def _sort_shapes(widths, warp_max, fixed):
    """fixed (B, C), then every width at every batch (at most 65 rows of
    the block path, whose blocks take one row each)."""
    grid = [(min(B, 65) if C > warp_max else B, C)
            for C in widths for B in SORT_BATCHES]
    return fixed + [bc for k, bc in enumerate(grid) if bc not in grid[:k]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", _sort_shapes(
    [1, 31, 32, 33, 64, 65, 128, 129, 256, 257, 480, 512, 513, 720, 1024,
     1025, 1440, 24576], 1024,
    [(4096, 480), (512, 2048), (64, 8192), (8, 24576), (3, 1000), (5, 1)]))
def test_sort_rows_kernel_matches_plain(cuda_device, B, C):
    x = torch.from_numpy(_values(np.random.default_rng(C), B, C)).to(
        cuda_device)
    before = sort.sort_rows.launches
    got = sort.sort_rows(x)
    assert sort.sort_rows.launches == before + 1
    assert torch.equal(got, sort.sort_rows_plain(x))
    # rows that start off 16-byte alignment take the scalar loads
    if B > 1:
        y = x.reshape(-1)[1:1 + (B - 1) * C].view(B - 1, C)
        assert torch.equal(sort.sort_rows(y), sort.sort_rows_plain(y))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", _sort_shapes(
    [1, 32, 33, 64, 65, 128, 129, 192, 256, 257, 384, 512, 513, 4096], 512,
    [(4096, 192), (512, 3072), (64, 16384), (3, 1000)]))
def test_sort2_rows_kernel_matches_plain(cuda_device, B, C):
    rng = np.random.default_rng(C + 1)
    key = np.where(rng.random((B, C)) < 0.1, I32_MAX,
                   rng.integers(-3, 512, size=(B, C))).astype(np.int32)
    key = torch.from_numpy(key).to(cuda_device)
    val = torch.from_numpy(_values(rng, B, C)).to(cuda_device)
    before = sort.sort2_rows.launches
    got = sort.sort2_rows(key, val)
    assert sort.sort2_rows.launches == before + 1
    for g, w in zip(got, sort.sort2_rows_plain(key, val)):
        assert torch.equal(g, w)


def _edge_rows(kind, B, C, rng):
    if kind == "all_max":
        return np.full((B, C), I32_MAX, np.int32)
    if kind == "no_max":
        x = rng.integers(-2**31, 2**31 - 1, size=(B, C), dtype=np.int64)
        return x.astype(np.int32)
    if kind == "one_value":
        return np.full((B, C), -5, np.int32)
    if kind == "min_and_max":
        pick = rng.random((B, C))
        x = np.where(pick < 0.4, -2**31, np.where(pick < 0.8, I32_MAX, 0))
        return x.astype(np.int32)
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 33, 480, 720, 1025, 2048])
@pytest.mark.parametrize("kind", ["all_max", "no_max", "one_value",
                                  "min_and_max"])
def test_sort_rows_kernel_edge_rows(cuda_device, kind, C):
    rng = np.random.default_rng(C)
    B = 17
    x = _edge_rows(kind, B, C, rng)
    x[B // 2] = _values(rng, 1, C)[0]          # one mixed row among them
    x = torch.from_numpy(x).to(cuda_device)
    assert torch.equal(sort.sort_rows(x), sort.sort_rows_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 192, 513, 4096, 16_385, 40_000, 65_536])
@pytest.mark.parametrize("kind", ["all_max", "one_value", "min_and_max",
                                  "equal_keys"])
def test_sort2_rows_kernel_edge_rows(cuda_device, kind, C):
    rng = np.random.default_rng(C + 11)
    B = 17
    if kind == "equal_keys":
        # one key a row, values INT32_MAX, INT32_MIN and ties
        key = np.full((B, C), 7, np.int32)
        val = _edge_rows("min_and_max", B, C, rng)
    else:
        key = _edge_rows(kind, B, C, rng)
        val = _edge_rows(kind, B, C, rng)
    key, val = (torch.from_numpy(key).to(cuda_device),
                torch.from_numpy(val).to(cuda_device))
    for g, w in zip(sort.sort2_rows(key, val),
                    sort.sort2_rows_plain(key, val)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", [(1, 32_769), (512, 40_960), (3, 100_001),
                                 (512, 377_856), (2, 1 << 21),
                                 (1, (1 << 21) + 1), (1, 1 << 22),
                                 (1, (1 << 24) + 3), (1, (1 << 27) + 5)])
@pytest.mark.parametrize("kind", ["random", "all_max", "dups"])
def test_sort_limits_hold_on_the_card(cuda_device, B, C, kind):
    """Rows past the block path (the rescue ladder's dedup rows of reads
    past 400 bp, up to 369 cores x 1,024 positions) take the scratch-row
    path at any width, also past 64 chunks of 32,768 (merges in more than
    one pass); a pair row past 16,384 pairs takes the pair sort's wide
    path."""
    rng = np.random.default_rng(C)
    if kind == "random":
        x = _values(rng, B, C)
    elif kind == "all_max":
        x = np.full((B, C), I32_MAX, np.int32)
    else:
        x = rng.integers(-3, 4, size=(B, C)).astype(np.int32)
    x = torch.from_numpy(x).to(cuda_device)
    before = sort.sort_rows.launches
    assert torch.equal(sort.sort_rows(x), sort.sort_rows_plain(x))
    assert sort.sort_rows.launches == before + 1
    if B > 1:                                  # rows off 16-byte alignment
        y = x.reshape(-1)[1:1 + (B - 1) * C].view(B - 1, C)
        assert torch.equal(sort.sort_rows(y), sort.sort_rows_plain(y))
    big = torch.zeros((1, sort.MAX_SORT2_C + 1), dtype=torch.int32,
                      device=cuda_device)
    got = sort.sort2_rows(big, big)
    assert all(torch.equal(a, b) for a, b in
               zip(got, sort.sort2_rows_plain(big, big)))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [100, 150, 300])
def test_hamming_extend_kernel_matches_plain(cuda_device, L):
    rng = np.random.default_rng(L)
    n = 200_000
    genome = rng.integers(0, 4, size=n, dtype=np.int8)
    genome[5_000:5_100] = 4
    genome[rng.random(n) < 0.001] = 4
    starts = np.array([0, 70_000, 150_000, 150_200, n], np.int64)
    B, C = 512, 256
    lens = np.where(rng.random(B) < 0.3, L - rng.integers(1, 20, B),
                    L).astype(np.int32)
    origin = rng.integers(0, n - L, size=B)
    reads = genome[origin[:, None] + np.arange(L)]
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = (reads[sub] + 1) % 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.choice([0, 0, 1, -2], size=(B, C))
    edge = rng.choice(starts[1:-1], (B, C)) + rng.integers(-L, L, (B, C))
    pick = rng.random((B, C))
    loci = np.where(pick < 0.3, edge, loci)
    loci = np.where(pick > 0.95, I32_MAX, loci)
    loci = np.where((pick > 0.9) & (pick <= 0.95), -4, loci)
    dev = cuda_device
    pg = ep.pack_genome(genome, dev)
    r, ln = torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)
    rc, rn = ep.pack_reads(r, ln)
    args = (pg, torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(loci.astype(np.int32)).to(dev),
            torch.from_numpy(rng.random((B, C)) < 0.9).to(dev), rc, rn, ln)
    before = ep.hamming_extend_packed.launches
    got = ep.hamming_extend_packed(*args)
    assert ep.hamming_extend_packed.launches == before + 1
    want = ep.hamming_extend_packed_plain(*args)
    assert torch.equal(got, want)
    assert bool((want <= 3).any()) and bool((want == 255).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(60))
def test_hamming_extend_kernel_on_edge_cases(cuda_device, case):
    """tests/extend_edge_cases.py, every case, and each input again off
    16-byte alignment."""
    import extend_edge_cases as edges

    case = edges.cases()[case]
    genome, starts, reads, lens, loci, valid = edges.extend_case(*case)
    dev = cuda_device
    pg = ep.pack_genome(genome, dev)
    r, ln = torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)
    rc, rn = ep.pack_reads(r, ln)
    args = (pg, torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(loci).to(dev), torch.from_numpy(valid).to(dev),
            rc, rn, ln)
    before = ep.hamming_extend_packed.launches
    want = ep.hamming_extend_packed_plain(*args)
    assert torch.equal(ep.hamming_extend_packed(*args), want)
    assert ep.hamming_extend_packed.launches == before + 1

    def off(t):                                # same values, 1 element on
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    moved = ep.PackedGenome(off(pg.rows), None if pg.n_rows is None else
                            off(pg.n_rows), pg.length)
    assert torch.equal(ep.hamming_extend_packed(
        moved, *(off(t) for t in args[1:])), want)


@pytest.mark.cuda
def test_cli_sam_on_the_card_equals_cpu(cuda_device, tmp_path):
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.index.build import build_index, save_index
    from biokanga_tpu_torch.seq.fasta import write_fastq
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([("chrA", 80_000), ("chrB", 40_000)], seed=3)
    g = seqs[0][1]
    g[30_000:33_000] = np.tile(np.array([0, 1, 2, 3, 3, 1], np.int8), 500)
    block = g[1_000:1_400].copy()
    for dst in (7_000, 21_000, 60_000):
        g[dst:dst + 400] = block
    seqs[1][1][9_000:9_050] = 4
    save_index(build_index(seqs, lut_bases=8), str(tmp_path / "ref.npz"))
    names, reads, _ = simulate_reads(seqs, 2_000, read_len=150,
                                     sub_rate=0.02, seed=5)
    for i in range(0, 200, 2):
        s = (29_900, 1_000)[i % 4 // 2] + i
        reads[i] = g[s:s + 150]
    write_fastq(str(tmp_path / "reads.fq"),
                ((nm, rd, None) for nm, rd in zip(names, reads)))
    common = ["-i", str(tmp_path / "reads.fq"), "-I", str(tmp_path / "ref.npz")]
    assert main(["align", "-o", str(tmp_path / "cpu.sam"), "--device",
                 "cpu"] + common) == 0
    before = sort.sort_rows.launches
    assert main(["align", "-o", str(tmp_path / "cuda.sam"), "--device",
                 "cuda"] + common) == 0
    assert sort.sort_rows.launches > before
    cpu_sam = (tmp_path / "cpu.sam").read_bytes()
    assert (tmp_path / "cuda.sam").read_bytes() == cpu_sam
    assert b"\t3\t150M\t" in cpu_sam            # multi-hit assignment ran


def _sw_pairs(rng, B, La, W):
    """Overlap-like pairs: noisy copies, ragged lengths, both diagonal
    signs, Ns on both sides, one pair with no positive cell."""
    a = np.full((B, La), 4, np.int8)
    b = np.full((B, La), 4, np.int8)
    alen = np.zeros(B, np.int32)
    blen = np.zeros(B, np.int32)
    diag = np.zeros(B, np.int32)
    for p in range(B):
        src = rng.integers(0, 4, 2 * La + 2 * W).astype(np.int8)
        d = int(rng.integers(-W, W + 1))
        q, t = src[max(d, 0):][:La].copy(), src[max(-d, 0):][:La].copy()
        for x in (q, t):
            err = rng.random(La) < 0.05
            x[err] = rng.integers(0, 4, int(err.sum()))
        keep = rng.random(La) > 0.03
        t = np.insert(t[keep], rng.integers(0, int(keep.sum()), La // 40),
                      rng.integers(0, 4, La // 40))[:La]
        n = La - int(rng.integers(0, La // 8))
        a[p, :n], alen[p] = q[:n], n
        m = len(t) - int(rng.integers(0, La // 8))
        b[p, :m], blen[p] = t[:m], m
        diag[p] = d + int(rng.integers(-4, 5))
    a[rng.integers(0, B, B), rng.integers(0, La // 2, B)] = 4
    b[rng.integers(0, B, B), rng.integers(0, La // 2, B)] = 4
    a[0] = 4
    return a, b, alen, blen, diag


def _sw_args(dev, a, b, alen, blen, diag, La, W):
    bwin, jlo, jhi = bsw.normalize_band(
        torch.from_numpy(b).to(dev), torch.from_numpy(blen).to(dev),
        torch.from_numpy(diag).to(dev), La, W)
    return (torch.from_numpy(a).to(dev), bwin,
            torch.from_numpy(alen).to(dev), jlo, jhi)


@pytest.mark.cuda
@pytest.mark.parametrize("B,La,W", [(96, 2048, 96), (40, 1000, 24),
                                    (7, 600, 255), (33, 512, 5),
                                    (3, 300, 96), (130, 777, 40)])
def test_banded_sw_kernels_match_plain(cuda_device, B, La, W):
    rng = np.random.default_rng(La + W)
    args = _sw_args(cuda_device, *_sw_pairs(rng, B, La, W), La, W)
    before = (bsw.banded_sw_moves.launches, bsw.banded_sw_score.launches)
    got = bsw.banded_sw_moves(*args, W)
    score = bsw.banded_sw_score(*args, W)
    assert (bsw.banded_sw_moves.launches,
            bsw.banded_sw_score.launches) == (before[0] + 1, before[1] + 1)
    want = bsw.banded_sw_moves_plain(*args, W)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(score, want[:3]):
        assert torch.equal(g, w)
    assert int(want[0][0]) == 0 and int(want[0].max()) > La // 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,La,W", [(9, 700, 256), (7, 800, 320),
                                    (3, 1200, 1000), (2, 600, 4_095),
                                    (4, 256, 4_096), (3, 200, 10_000),
                                    (2, 160, 15_000)])
def test_wide_band_kernels_match_plain(cuda_device, B, La, W):
    """Bands past the one-warp path: one block a pair with the band in
    registers up to W = 4,095, then in segments with the state row in
    shared memory (4,096; 10,000 without moves) or in device memory
    (10,000 with moves, 15,000); the decode at the same planes."""
    rng = np.random.default_rng(W)
    args = _sw_args(cuda_device, *_sw_pairs(rng, B, La, min(W, La // 4)),
                    La, W)
    before = (bsw.banded_sw_moves.launches, bsw.banded_sw_score.launches,
              sw_trace.traceback_cols_packed.launches)
    got = bsw.banded_sw_moves(*args, W)
    score = bsw.banded_sw_score(*args, W)
    want = bsw.banded_sw_moves_plain(*args, W)
    for g, w in zip((*got, *score), (*want, *want[:3])):
        assert torch.equal(g, w)
    _, bi, bk, mv = want
    dec = sw_trace.traceback_cols_packed(mv, bi, bk, args[1], W, La)
    for g, w in zip(dec, sw_trace.traceback_cols_packed_plain(
            mv, bi, bk, args[1], W, La)):
        assert torch.equal(g, w)
    assert (bsw.banded_sw_moves.launches, bsw.banded_sw_score.launches,
            sw_trace.traceback_cols_packed.launches) == tuple(
                n + 1 for n in before)
    assert int(want[0].max()) > La // 4 and (dec[0] < 4).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,La,W", [(96, 2048, 96), (40, 1000, 24),
                                    (7, 333, 96)])
def test_sw_trace_kernel_matches_plain(cuda_device, B, La, W):
    rng = np.random.default_rng(B)
    args = _sw_args(cuda_device, *_sw_pairs(rng, B, La, W), La, W)
    _, bi, bk, mv = bsw.banded_sw_moves(*args, W)
    before = sw_trace.traceback_cols_packed.launches
    got = sw_trace.traceback_cols_packed(mv, bi, bk, args[1], W, La)
    assert sw_trace.traceback_cols_packed.launches == before + 1
    want = sw_trace.traceback_cols_packed_plain(mv, bi, bk, args[1], W, La)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out, ins_cnt, _ = want
    assert (out == 5).any() and (ins_cnt > 0).any() and (out < 4).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,La,W", [(12, 100, 24), (13, 77, 40),
                                    (25, 256, 96), (6, 2048, 96),
                                    (5, 300, 255)])
def test_sw_trace_kernel_on_edge_planes(cuda_device, B, La, W):
    from sw_edge_cases import decode_planes

    planes = [torch.from_numpy(x).to(cuda_device)
              for x in decode_planes(La + W, B, La, W)]
    before = sw_trace.traceback_cols_packed.launches
    got = sw_trace.traceback_cols_packed(*planes, W, La)
    assert sw_trace.traceback_cols_packed.launches == before + 1
    want = sw_trace.traceback_cols_packed_plain(*planes, W, La)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want[1].max()) > 32


@pytest.mark.cuda
@pytest.mark.parametrize("past", [False, True])
def test_banded_sw_scores_near_and_past_2_15(cuda_device, past):
    import sw_edge_cases as edges

    La, W, B = (320, 24, 9) if past else (256, 24, 9)
    scoring = edges.SCORING_PAST_2_15 if past else edges.SCORING_BELOW_2_15
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_ext"), scoring))
    args = _sw_args(cuda_device, *edges.near_identical_pairs(La, B, La, W),
                    La, W)
    want = bsw.banded_sw_moves_plain(*args, W, **kw)
    before = (bsw.banded_sw_moves.launches, bsw.banded_sw_score.launches)
    got = bsw.banded_sw_moves(*args, W, **kw)
    score = bsw.banded_sw_score(*args, W, **kw)
    assert (bsw.banded_sw_moves.launches,
            bsw.banded_sw_score.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip((*got, *score), (*want, *want[:3])):
        assert torch.equal(g, w)
    top = int(want[0].max())
    assert top > 32_767 if past else 24_000 < top <= 32_767


@pytest.mark.cuda
def test_consensus_ties_on_the_card_equal_the_cpu(cuda_device):
    from biokanga_tpu_torch.pacbio import ecreads as ec

    rng = np.random.default_rng(5)
    N, La = 8, 256
    got = {}
    for dev in (torch.device("cpu"), cuda_device):
        v = ec._Votes(N, La, dev)
        v.votes[:] = torch.from_numpy(
            rng.integers(0, 3, (N, La, 7)).astype(np.int32)).to(dev)
        v.votes[0] = 2                           # five-way ties
        v.ins_cnt[:] = 3
        v.ins_base[:] = 1                        # four-way ties
        probes = torch.full((N, La), 2, dtype=torch.int8, device=dev)
        plens = torch.full((N,), La, dtype=torch.int32, device=dev)
        got[dev.type] = [t.cpu() for t in ec._consensus(v, probes, plens, 2)]
        rng = np.random.default_rng(5)
    for c, g in zip(got["cpu"], got["cuda"]):
        assert torch.equal(c, g)
    call, _, ins_b = got["cuda"]
    assert (call[0] == 0).all() and (ins_b == 0).all()


@pytest.mark.cuda
def test_ecreads_on_the_card_equals_cpu(cuda_device, tmp_path):
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import write_fasta

    rng = np.random.default_rng(9)
    true = rng.integers(0, 4, 1_200).astype(np.int8)
    reads = []
    for i in range(12):
        r = true[rng.random(len(true)) > 0.03].copy()
        sub = rng.random(len(r)) < 0.03
        r[sub] = (r[sub] + 1) % 4
        r = np.insert(r, rng.integers(0, len(r), 20), rng.integers(0, 4, 20))
        reads.append(revcomp(r.astype(np.int8)) if i % 3 == 0
                     else r.astype(np.int8))
    write_fasta(str(tmp_path / "pb.fa"),
                ((f"read{i}", r) for i, r in enumerate(reads)))
    common = ["-i", str(tmp_path / "pb.fa"), "--target-chunk", "5"]
    assert main(["ecreads", "-o", str(tmp_path / "cpu.fa"), "--device",
                 "cpu"] + common) == 0
    before = bsw.banded_sw_moves.launches
    assert main(["ecreads", "-o", str(tmp_path / "cuda.fa"), "--device",
                 "cuda"] + common) == 0
    assert bsw.banded_sw_moves.launches > before
    want = (tmp_path / "cpu.fa").read_bytes()
    assert (tmp_path / "cuda.fa").read_bytes() == want
    assert want != (tmp_path / "pb.fa").read_bytes()


# both sides of the wrapper's region rule on a card with 50 MB of L2 (one
# region of the whole table below n = R or past ten regions of 409,600
# rows; regions of half the L2 from n = R): tables inside one region, n <
# R by one and n = R, R not a multiple of a region, 10 and 11 regions, n
# not a multiple of a warp's 256 indices, n = 1 and n >> R
@pytest.mark.cuda
@pytest.mark.parametrize("R,n", [(36_000, 200_000), (1_000_003, 50_000),
                                 (1, 1_000), (4_097, 1), (500, 0),
                                 (1_000, 2_000_000), (1_000_003, 1_000_002),
                                 (1_000_003, 1_000_003),
                                 (450_001, 3_000_001), (600_001, 1),
                                 (2_621_441, 6_291_457),
                                 (4_096_000, 4_096_000),
                                 (4_096_001, 4_096_001)])
def test_stream_gather_kernel_matches_plain(cuda_device, R, n):
    rng = np.random.default_rng(R + n)
    table = rng.integers(0, 2**32, size=(R, 16), dtype=np.uint32)
    table[rng.integers(0, R, max(R // 8, 1))] = 0xFFFFFFFF
    idx = rng.integers(0, R, size=n, dtype=np.int32)
    if n > 2:
        idx[0], idx[-1] = R - 1, 0
        idx[n // 2] = idx[n // 3]                   # a duplicate
    t = torch.from_numpy(table.view(np.int32)).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    want = int(stream_gather.stream_gather_consume_plain(t, i))
    region = stream_gather.gather_plan(
        R, n, stream_gather.l2_bytes(cuda_device))
    before = stream_gather.stream_gather_consume.launches
    got = stream_gather.stream_gather_consume(t, i)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == want
    if n:
        assert stream_gather.stream_gather_consume.last_regions == \
            -(-R // region)
    assert int(stream_gather.stream_gather_consume(t, i, sort_rows=True)) \
        == want
    # one kernel launch a call, none for an empty index vector
    assert stream_gather.stream_gather_consume.launches == \
        before + (2 if n else 0)
    # indices that start off 16-byte alignment
    if n > 1:
        i_off = torch.empty(n + 1, dtype=torch.int32,
                            device=cuda_device)[1:]
        i_off.copy_(i)
        assert int(stream_gather.stream_gather_consume(t, i_off)) == want
    # the same on the CPU's plain version
    assert int(stream_gather.stream_gather_consume(t.cpu(), i.cpu())) == want
    # a table whose first word is not 16-byte aligned
    if R > 1:
        off = torch.empty(R * 16 + 1, dtype=torch.int32,
                          device=cuda_device)[1:].view(R, 16)
        off.copy_(t)
        assert int(stream_gather.stream_gather_consume(off, i)) == want


def _pe_case(n_pairs=600, L=100):
    """Pairs from a genome with a 300 bp block in three copies: every
    seventh pair has one mate in the block (an orphan for the rescue),
    every eleventh a mate with a substitution in every seed core, and
    the first pairs lie at the genome's start and end, where the rescue
    window leaves the genome."""
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([("chrA", 90_000), ("chrB", 50_000)], seed=13)
    g = seqs[0][1]
    block = g[8_000:8_300].copy()
    g[40_000:40_300] = block
    seqs[1][1][17_000:17_300] = block
    seqs[1][1][25_000:25_040] = 4
    cat = np.concatenate([s for _, s in seqs])
    names, reads, _ = simulate_reads(seqs, n_pairs, read_len=L,
                                     sub_rate=0.01, seed=6, pe=True,
                                     insert_min=200, insert_max=500)
    rc = lambda x: np.where(x >= 4, x, 3 - x)[::-1]
    for i in range(4, n_pairs, 7):
        s = (8_000, 40_000)[i % 2] + 30 + i % 50
        reads[2 * i] = g[s:s + L]
        reads[2 * i + 1] = rc(g[s + 320:s + 420])
    for i in range(5, n_pairs, 11):
        r = reads[2 * i + i % 2]
        r[4:93:11] = (r[4:93:11] + 1) % 4
    for i, (s, ins) in enumerate(((3, 330), (len(cat) - 410, 410))):
        for k in (0, 1):
            a, b = cat[s:s + L].copy(), rc(cat[s + ins - L:s + ins])
            dead = (a, b)[k]
            dead[4:93:11] = (dead[4:93:11] + 1) % 4
            reads[4 * i + 2 * k], reads[4 * i + 2 * k + 1] = a, b
    return seqs, names, reads


@pytest.mark.cuda
def test_rescue_window_on_the_card_equals_cpu(cuda_device):
    from biokanga_tpu_torch.align.pe import rescue_window
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device

    seqs, _, _ = _pe_case(8)
    idx = build_index(seqs, lut_bases=8)
    cat = np.concatenate([s for _, s in seqs])
    n, B, L, Wlen = len(cat), 192, 100, 500
    rng = np.random.default_rng(3)
    # windows from 400 below the genome's start to 100 before its end
    win = np.linspace(-400, n - 100, B).astype(np.int32)
    src = np.clip(win + rng.integers(0, Wlen - L, B), 0, n - L)
    reads = cat[src[:, None] + np.arange(L)].astype(np.int8)
    lens = np.where(rng.random(B) < 0.3, L - rng.integers(1, 30, B),
                    L).astype(np.int32)
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    reads[::9] = rng.integers(0, 4, (len(reads[::9]), L))
    mtm = np.full(B, 10, np.int32)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        didx = to_device(idx, dev)
        before = ep.hamming_extend_packed.launches
        res = rescue_window(didx, *[torch.from_numpy(a).to(dev) for a in
                                    (win, reads, lens, mtm)], Wlen)
        assert ep.hamming_extend_packed.launches == \
            before + (dev.type == "cuda")
        out[dev.type] = {k: v.cpu() for k, v in res.items()}
    for k in out["cpu"]:
        assert torch.equal(out["cpu"][k], out["cuda"][k]), k
    ok = out["cuda"]["ok"]
    assert ok[:8].any() and ok[-8:].any() and not ok[::9].any()
    assert int(ok.sum()) > B // 2


@pytest.mark.cuda
def test_pe_cli_sam_on_the_card_equals_cpu(cuda_device, tmp_path):
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.index.build import build_index, save_index
    from biokanga_tpu_torch.seq.fasta import write_fastq

    seqs, names, reads = _pe_case()
    save_index(build_index(seqs, lut_bases=8), str(tmp_path / "ref.npz"))
    for m in (0, 1):
        write_fastq(str(tmp_path / f"r{m + 1}.fq"),
                    ((nm, rd, None) for nm, rd in zip(names[m::2],
                                                      reads[m::2])))
    common = ["-i", str(tmp_path / "r1.fq"), "-u", str(tmp_path / "r2.fq"),
              "-I", str(tmp_path / "ref.npz"), "-d", "100", "-D", "600",
              "--batch-size", "256"]
    for dev in ("cpu", "cuda"):
        before = ep.hamming_extend_packed.launches
        assert main(["align", "-o", str(tmp_path / f"{dev}.sam"),
                     "--peinsertdist", str(tmp_path / f"{dev}.csv"),
                     "-F", str(tmp_path / f"{dev}.log"), "--device", dev]
                    + common) == 0
        launched = ep.hamming_extend_packed.launches - before
        assert (launched > 0) == (dev == "cuda")
    cpu_sam = (tmp_path / "cpu.sam").read_bytes()
    assert (tmp_path / "cuda.sam").read_bytes() == cpu_sam
    assert (tmp_path / "cuda.csv").read_bytes() == \
        (tmp_path / "cpu.csv").read_bytes()
    recs = [ln.split("\t") for ln in cpu_sam.decode().splitlines()
            if not ln.startswith("@")]
    assert len(recs) == 1_200
    assert sum(int(r[1]) & 2 > 0 for r in recs) > 1_000
    # the seed-dead mates at the genome's two ends were rescued
    assert all(int(r[1]) & 2 for r in recs[:8])
    assert " 0 mates rescued" not in (tmp_path / "cuda.log").read_text()


def _scan_tensors(dev, g, case):
    """The scans' arguments on `dev` from a scan_cases case."""
    import scan_cases

    reads, lens, loci, valid = case[:4]
    pg = ep.pack_genome(g, dev)
    r = torch.from_numpy(reads).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    rc, rn = ep.pack_reads(r, ln)
    return (pg, torch.from_numpy(scan_cases.STARTS.astype(np.int32)).to(dev),
            torch.from_numpy(loci).to(dev), torch.from_numpy(valid).to(dev),
            rc, rn, ln)


@pytest.mark.cuda
@pytest.mark.parametrize("with_n", [True, False])
def test_indel_and_splice_scans_on_the_card_equal_cpu(cuda_device, with_n,
                                                      monkeypatch):
    """indel_scan and splice_scan on CUDA tensors against CPU tensors,
    exact: candidates off both ends and at INT32_MAX, equal scores in two
    columns, ambiguous junctions (rightmost split), and the splice scan
    also in chunks of rows."""
    import scan_cases

    from biokanga_tpu_torch.align import splice_indel as si

    rng = np.random.default_rng(90 + with_n)
    g = scan_cases.genome(rng, with_n)
    case = scan_cases.scan_case(rng, g, L=100, B=256, max_gap=10)
    assert case[5] > 20                      # ambiguous junctions
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda_device)):
        args = _scan_tensors(dev, g, case)
        out[name] = {"indel": si.indel_scan(*args, 100, 10),
                     "splice": si.splice_scan(*args, 100, 50_000)}
        with monkeypatch.context() as m:      # seven rows a chunk
            m.setattr(si, "SPLICE_CHUNK_BYTES", 7 * 24 * 24 * 101 * 4)
            out[name]["chunked"] = si.splice_scan(*args, 100, 50_000)
    for scan in ("indel", "splice", "chunked"):
        for k, v in out["cpu"][scan].items():
            assert torch.equal(out["cuda"][scan][k].cpu(), v), (scan, k)
    assert int(out["cpu"]["indel"]["ok"].sum()) > 60
    assert int(out["cpu"]["splice"]["ok"].sum()) > 30


@pytest.mark.cuda
def test_pileup_on_the_card_equals_cpu(cuda_device):
    import scan_cases

    from biokanga_tpu_torch.align.snp import pileup_batch

    rng = np.random.default_rng(5)
    g = scan_cases.genome(rng, True)
    planes = {}
    for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda_device)):
        n = len(g)
        p = (torch.zeros((n, 4), dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))
        case_rng = np.random.default_rng(6)
        for _ in range(3):
            loci, seqs, lens, acc = scan_cases.pileup_case(case_rng, g,
                                                           B=4_000)
            p = pileup_batch(*p, torch.from_numpy(g).to(dev),
                             *(torch.from_numpy(a).to(dev)
                               for a in (loci, seqs, lens, acc)))
        planes[name] = p
    for a, b in zip(planes["cpu"], planes["cuda"]):
        assert torch.equal(a, b.cpu())
    assert int(planes["cpu"][0].sum()) > 500_000


@pytest.mark.cuda
def test_snp_indel_splice_cli_on_the_card_equals_cpu(cuda_device, tmp_path):
    """`align -O ... -a -A -C` with --device cuda against --device cpu:
    SAM, stats, SNP CSV and VCF, haplotype and centroid CSVs byte for
    byte."""
    import options_reads as opt

    from biokanga_tpu_torch.align import snp, splice_indel
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.index.build import build_index, save_index
    from biokanga_tpu_torch.seq.fasta import write_fastq
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    rng = np.random.default_rng(12)
    seqs = random_genome([("chrA", 60_000), ("chrB", 30_000)], seed=12)
    save_index(build_index(seqs, lut_bases=8), str(tmp_path / "ref.npz"))
    sample, snps = opt.plant_snps(seqs, 1_000, rng)
    names, reads, _ = simulate_reads(sample, 18_000, read_len=100,
                                     sub_rate=0.002, seed=13)
    events = opt.plan_events(seqs, 300, 300, snps, rng, spacing=100)
    opt.alter_reads(names, reads, sample, events, rng, 0.05, 0.05, 0.02,
                    block=8_192)
    write_fastq(str(tmp_path / "reads.fq"),
                ((nm, rd, None) for nm, rd in zip(names, reads)))
    side = {"-O": "snps.csv", "--snpvcf": "snps.vcf", "--disnp": "di.csv",
            "--trisnp": "tri.csv", "--snpcentroid": "cent.csv",
            "--stats": "stats.csv"}
    for dev in ("cpu", "cuda"):
        argv = ["align", "-i", str(tmp_path / "reads.fq"), "-I",
                str(tmp_path / "ref.npz"), "-o",
                str(tmp_path / f"{dev}_out.sam"),
                "-a", "10", "-A", "50000", "-C", "50", "--batch-size",
                "8192", "--device", dev]
        for flag, name in side.items():
            argv += [flag, str(tmp_path / f"{dev}_{name}")]
        assert main(argv) == 0
    for name in ["out.sam"] + list(side.values()):
        cpu = (tmp_path / f"cpu_{name}").read_bytes()
        assert (tmp_path / f"cuda_{name}").read_bytes() == cpu, name
    recs = [ln.split("\t") for ln in
            (tmp_path / "cpu_out.sam").read_text().splitlines()
            if not ln.startswith("@")]
    cigars = "".join(r[5] for r in recs if r[4] == "60")
    assert all(op in cigars for op in "DINS")
    assert (tmp_path / "cpu_snps.csv").read_text().count("\n") > 50


@pytest.mark.cuda
@pytest.mark.parametrize("L", [100, 4_097, 10_000])
def test_dense_extension_on_the_card_equals_cpu(cuda_device, L):
    """ops/extend.hamming_extend on CUDA tensors, in slabs of a few
    candidates and in one, against CPU tensors."""
    from biokanga_tpu_torch.ops import extend

    rng = np.random.default_rng(L)
    n, B, C = 60_000, 40, 16
    g = rng.integers(0, 4, n, dtype=np.int8)
    g[rng.random(n) < 0.003] = 4
    starts = np.array([0, 21_000, 21_100, n], np.int32)
    lens = np.where(rng.random(B) < 0.3, L - 7, L).astype(np.int32)
    origin = rng.integers(0, n - L, B)
    reads = g[origin[:, None] + np.arange(L)].copy()
    reads[rng.random(reads.shape) < 0.01] = 4
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    loci = origin[:, None] + rng.integers(-2, 3, (B, C))
    loci[:, -2:] = rng.choice([-9, n - 50, I32_MAX, 21_050], (B, 2))
    valid = rng.random((B, C)) < 0.9
    args = [torch.from_numpy(a) for a in (g, starts, loci.astype(np.int32),
                                          valid, reads, lens)]
    want = extend.hamming_extend(*args)
    got = extend.hamming_extend(*(a.to(cuda_device) for a in args))
    assert torch.equal(got.cpu(), want)
    slab = extend.SLAB_BASES
    try:
        extend.SLAB_BASES = 5 * L
        assert torch.equal(extend.hamming_extend(
            *(a.to(cuda_device) for a in args)).cpu(), want)
    finally:
        extend.SLAB_BASES = slab


@pytest.mark.cuda
@pytest.mark.parametrize("with_n,with_keys", [(False, True), (True, False)])
def test_device_build_on_the_card_equals_cpu(cuda_device, with_n, with_keys):
    """device_build_index of an N-padded chunk slice on the card: keys,
    order, LUT and packed rows equal the CPU build's."""
    from biokanga_tpu_torch.index.device_build import device_build_index

    rng = np.random.default_rng(3)
    true_len, pad_n = 300_000, 300_160
    codes = np.full(pad_n, 4, np.int8)
    codes[:true_len] = rng.integers(0, 4, true_len)
    if with_n:
        codes[rng.choice(true_len, 300, replace=False)] = 4
    es = np.array([0, 100_000, true_len], np.int64)
    kw = dict(lut_bases=10, owned=290_000, true_len=true_len,
              with_keys=with_keys)
    a = device_build_index(codes, es, device="cpu", **kw)
    b = device_build_index(codes, es, device=cuda_device, **kw)
    for f in ("genome", "entry_starts", "pos_sorted", "key_hi", "key_lo",
              "lut"):
        assert torch.equal(getattr(b, f).cpu(), getattr(a, f)), f
    assert torch.equal(b.packed.rows.cpu(), a.packed.rows)
    assert (b.packed.n_rows is None) == (a.packed.n_rows is None) == \
        (not with_n)
    if with_n:
        assert torch.equal(b.packed.n_rows.cpu(), a.packed.n_rows)
    assert (b.packed.length, b.owned, b.max_bsearch_steps) == \
        (a.packed.length, a.owned, a.max_bsearch_steps)


@pytest.mark.cuda
def test_chunked_cli_on_the_card_equals_cpu(cuda_device, tmp_path):
    """`index --chunks 3`, then `align -a -A -O`, `align -u` and 6 kb
    reads on the chunked index, --device cuda against --device cpu: SAM
    and SNP CSV byte for byte."""
    import options_reads as opt

    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.fasta import write_fasta, write_fastq
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    rng = np.random.default_rng(21)
    seqs = random_genome([("chrA", 60_000), ("chrB", 40_000)], seed=21)
    write_fasta(str(tmp_path / "ref.fa"), seqs)
    assert main(["index", "-i", str(tmp_path / "ref.fa"), "-o",
                 str(tmp_path / "ck.npz"), "--chunks", "3", "--lut-bases",
                 "8"]) == 0
    sample, snps = opt.plant_snps(seqs, 1_000, rng)
    names, reads, _ = simulate_reads(sample, 12_000, read_len=100,
                                     sub_rate=0.002, seed=13)
    events = opt.plan_events(seqs, 150, 150, snps, rng, spacing=100)
    opt.alter_reads(names, reads, sample, events, rng, 0.05, 0.05, 0.02,
                    block=12_000)
    write_fastq(str(tmp_path / "se.fq"),
                ((nm, rd, None) for nm, rd in zip(names, reads)))
    pn, pr, _ = simulate_reads(sample, 2_000, read_len=100, sub_rate=0.01,
                               seed=14, pe=True)
    for m in (0, 1):
        write_fastq(str(tmp_path / f"p{m + 1}.fq"),
                    ((nm, rd, None) for nm, rd in zip(pn[m::2], pr[m::2])))
    ln, lr, _ = simulate_reads(seqs, 64, read_len=6_000, sub_rate=0.002,
                               seed=15)
    write_fastq(str(tmp_path / "long.fq"),
                ((nm, rd, None) for nm, rd in zip(ln, lr)))
    runs = {"se": ["-i", "se.fq", "-a", "10", "-A", "5000", "-O", "SNPS"],
            "pe": ["-i", "p1.fq", "-u", "p2.fq", "-d", "100", "-D", "600"],
            "long": ["-i", "long.fq"]}
    for kind, opts in runs.items():
        for dev in ("cpu", "cuda"):
            argv = [str(tmp_path / o) if o.endswith(".fq") else o
                    for o in opts]
            argv = [str(tmp_path / f"{kind}_{dev}_snps.csv")
                    if o == "SNPS" else o for o in argv]
            assert main(["align", *argv, "-I", str(tmp_path / "ck.npz"),
                         "-o", str(tmp_path / f"{kind}_{dev}.sam"),
                         "--batch-size", "4096", "--device", dev]) == 0
        for f in (f"{kind}_{{}}.sam", f"{kind}_{{}}_snps.csv"):
            if (tmp_path / f.format("cpu")).exists():
                assert (tmp_path / f.format("cuda")).read_bytes() == \
                    (tmp_path / f.format("cpu")).read_bytes(), f
    assert (tmp_path / "se_cpu_snps.csv").read_text().count("\n") > 20


@pytest.mark.cuda
def test_long_read_aligner_on_the_card_equals_cpu(cuda_device):
    from biokanga_tpu_torch.align.longread import LongReadAligner
    from biokanga_tpu_torch.align.pipeline import AlignEngine
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("chr1", 500_000)], seed=11)
    idx = build_index(seqs, lut_bases=10)
    g = seqs[0][1]
    rng = np.random.default_rng(2)
    L = 30_000
    starts = rng.integers(0, len(g) - L, 6)
    reads = np.stack([g[s:s + L] for s in starts]).copy()
    reads[:, ::997] = (reads[:, ::997] + 1) % 4
    lens = np.full(6, L, np.int32)
    lens[5] = L - 3_333
    out = {d: LongReadAligner(AlignEngine(to_device(idx, torch.device(d))))
           .align(reads, lens) for d in ("cpu", "cuda")}
    for k in ("unique", "locus", "is_rc", "best_mm"):
        np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k])
    assert out["cuda"]["unique"].all()
    assert out["cuda"]["locus"].tolist() == starts.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 8, 24, 96])
def test_banded_sw_batch_on_the_card_equals_plain(cuda_device, W):
    """ops/sw.banded_sw_batch through kernels #6 and #5 on tie-rich pairs
    (tests/sw_edge_cases.tie_rich_pairs): best score, best cell (the first
    row to reach it, the lowest k there) and the unpacked move codes equal
    the plain lazy-F row scan's."""
    from sw_edge_cases import tie_rich_pairs

    from biokanga_tpu_torch.ops.sw import (
        banded_sw_batch,
        banded_sw_batch_plain,
    )

    cpu = [torch.from_numpy(x) for x in tie_rich_pairs(W, 60, 300)]
    want = banded_sw_batch_plain(*cpu, W, moves=True)
    for moves, kernel in ((False, bsw.banded_sw_score),
                          (True, bsw.banded_sw_moves)):
        before = kernel.launches
        got = banded_sw_batch(*[t.to(cuda_device) for t in cpu], W,
                              moves=moves)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for g, w, name in zip(got, want, ("best", "best_i", "best_k",
                                          "moves")):
            if name == "moves" and not moves:
                assert g is None
                continue
            assert g.device.type == "cuda" and g.dtype == w.dtype, name
            assert torch.equal(g.cpu(), w), name


@pytest.mark.cuda
def test_sharded_aligner_two_ranks_on_the_card_equal_the_engine(
        cuda_device, tmp_path):
    """parallel/sharded.ShardedAligner at (1, 2): two processes on the
    card (gloo between them), each holding one chunk, give the
    single-device AlignEngine's result, exactly."""
    from torch_dist_ranks import load, sharded_card_ranks, spawn

    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pipeline import (
        RESULT_KEYS,
        AlignEngine,
        pad_rows,
    )
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([("c1", 300_000), ("c2", 200_000)], seed=31)
    seg = seqs[0][1][2000:2600].copy()
    seqs[1][1][7000:7600] = seg                  # a repeat: multi-hits
    _, reads, _ = simulate_reads(seqs, 8_000, read_len=100, sub_rate=0.02,
                                 seed=13)
    reads[:16] = seg[100:200]
    reads[16:24, 3] = 4
    reads, lengths = pad_rows(reads, np.full(len(reads), 100, np.int32))
    spawn(sharded_card_ranks, 2, str(tmp_path),
          {"seqs": seqs, "reads": reads, "lengths": lengths})
    got, where = load(str(tmp_path), "card")
    assert where.startswith("cuda")
    want = AlignEngine(to_device(build_index(seqs, lut_bases=8), cuda_device),
                       AlignParams(cand_per_core=48)).align_with_rescue(
                           reads, lengths)
    for k in RESULT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["inst"][:16] >= 2).all() and got["unique"].sum() > 7_000


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [None, (11, 4_096, 192, 10, True),
                                   (12, 512, 192, 256, False)])
def test_windowed_extension_kernel_matches_plain(cuda_device, extra):
    """#3w on every case of tests/win_edge_cases.py (entry cuts, win <= 0
    and past 16 W, windows past the genome's end, Ns), or at the
    assembler's sweep shapes: exact, and one launch a call."""
    import win_edge_cases

    for case in win_edge_cases.cases() if extra is None else [extra]:
        g, starts, reads, lens, loci, valid, win = win_edge_cases.win_case(
            *case)
        pg = ep.pack_genome(g, cuda_device)
        rc, rn = ep.pack_reads(torch.from_numpy(reads).to(cuda_device),
                               torch.from_numpy(lens).to(cuda_device))
        args = (pg, torch.from_numpy(starts.astype(np.int32)).to(cuda_device),
                torch.from_numpy(loci).to(cuda_device),
                torch.from_numpy(valid).to(cuda_device), rc, rn,
                torch.from_numpy(win).to(cuda_device))
        before = ep.hamming_extend_packed_win.launches
        got = ep.hamming_extend_packed_win(*args)
        assert ep.hamming_extend_packed_win.launches == before + 1
        assert torch.equal(got, ep.hamming_extend_packed_win_plain(*args))


@pytest.mark.cuda
def test_bisulfite_and_colorspace_cli_on_the_card_equal_cpu(cuda_device,
                                                            tmp_path):
    """`index -m 1` / `index -C`, then `align` on either index: the SAM of
    --device cuda equals --device cpu's byte for byte."""
    from bs_reads import bs_reads

    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.fasta import write_csfasta, write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    seqs = random_genome([("c1", 80_000), ("c2", 30_000)], seed=5)
    write_fasta(str(tmp_path / "g.fa"), seqs)
    names, reads, _, _ = bs_reads(seqs[0][1], 2_000, 100,
                                  np.random.default_rng(1))
    write_fasta(str(tmp_path / "bs.fa"), zip(names, reads))
    names, reads, _ = simulate_reads(seqs, 2_000, read_len=75,
                                     sub_rate=0.01, seed=2)
    write_csfasta(str(tmp_path / "cs.csfasta"), zip(names, reads))
    for mode, reads_path in ((["-m", "1"], "bs.fa"), (["-C"], "cs.csfasta")):
        assert main(["index", *mode, "-i", str(tmp_path / "g.fa"), "-o",
                     str(tmp_path / "i.npz"), "--lut-bases", "9"]) == 0
        for d in ("cpu", "cuda"):
            assert main(["align", "-i", str(tmp_path / reads_path), "-I",
                         str(tmp_path / "i.npz"), "-o",
                         str(tmp_path / f"{d}.sam"), "--device", d,
                         "--batch-size", "512"]) == 0
        want = (tmp_path / "cpu.sam").read_bytes()
        assert (tmp_path / "cuda.sam").read_bytes() == want, mode


@pytest.mark.cuda
def test_scaled_assembly_on_the_card_equals_cpu(cuda_device):
    """assemble(scaled=True) on 600 reads of an 8 kb genome: the card's
    contigs and stats equal the CPU's, and the windowed kernel ran."""
    from biokanga_tpu_torch.assembly.assemble import assemble
    from biokanga_tpu_torch.sim.simreads import random_genome, simulate_reads

    g = random_genome([("chr1", 8_000)], seed=3)
    _, reads, _ = simulate_reads(g, 600, read_len=100, sub_rate=0.002,
                                 seed=5)
    reads = [np.asarray(r, np.int8) for r in reads]
    before = ep.hamming_extend_packed_win.launches
    got, gs = assemble(reads, scaled=True, max_passes=8, device=cuda_device)
    assert ep.hamming_extend_packed_win.launches > before
    want, ws = assemble(reads, scaled=True, max_passes=8, device="cpu")
    assert vars(gs) == vars(ws)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _uh_genome(rng, n, entries, palindrome=False):
    """Codes of n bases in `entries` entries (the second short), with an
    N run, an exact and a near repeat; with `palindrome`, a window of the
    last entry (its last K // 2 * 2 bases) that is its own reverse
    complement."""
    g = rng.integers(0, 4, n).astype(np.int8)
    g[n // 7:n // 7 + 9] = 4
    r = n // 6
    g[3 * r:4 * r] = g[:r]
    near = g[r:2 * r].copy()
    near[::40] = (near[::40] + 1) % 4
    g[4 * r:5 * r] = near
    cut = np.linspace(0, n, entries + 1).astype(int)
    if entries > 1:
        cut[2] = cut[1] + 40
    if palindrome:
        half = rng.integers(0, 4, palindrome // 2).astype(np.int8)
        pal = np.concatenate([half, 3 - half[::-1]])
        if cut[-2] + len(pal) <= n:
            g[n - len(pal):] = pal
    return g, cut


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,entries,palindrome",
                         [(300, 24, 1, 0), (2_500, 24, 3, 0),
                          (2_500, 100, 3, 0), (5_000, 100, 2, 0),
                          (90, 100, 1, 0), (31, 32, 1, 32), (33, 32, 1, 32),
                          (4_127, 32, 3, 32), (31, 300, 1, 300),
                          (33, 300, 1, 300), (4_127, 300, 3, 300)])
def test_uhamming_sweep_kernel_matches_plain(cuda_device, n, K, entries,
                                             palindrome):
    """#7 on the card against its plain version: the full watson and
    reverse-complement sweeps, a mode-2 shift range, a genome shorter
    than K, K a multiple of the word and K past 255 (the counts
    saturate), and a window that is its own reverse complement (the
    cross sweep's self-pair)."""
    from biokanga_tpu_torch.ops import uhamming_sweep as us
    from biokanga_tpu_torch.tools.uhamming import window_validity

    g, starts = _uh_genome(np.random.default_rng(n + K), n, entries,
                           palindrome)
    args = (torch.from_numpy(g).to(cuda_device),
            torch.from_numpy(window_validity(starts, n, K)).to(cuda_device),
            torch.full((n,), us.H_INVALID, dtype=torch.uint8,
                       device=cuda_device))
    top = n - K + 1
    for lo, hi, rc in ((1, top, True), (1, top, False),
                       (1 + top // 3, 1 + 2 * top // 3, False)):
        before = us.uhamming_sweep.launches
        got = us.uhamming_sweep(*args, K, lo, hi, rc)
        torch.cuda.synchronize()
        want = us.uhamming_sweep_plain(*args, K, lo, hi, rc)
        assert torch.equal(got, want)
        if top > 0 and hi > lo:
            assert us.uhamming_sweep.launches == before + 1 + rc
        if palindrome and rc and n >= K:
            assert int(got[n - K]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("C,M,kind", [(1, 1, "random"), (40, 64, "ties"),
                                      (300, 512, "random"),
                                      (5, 4_096, "random"),
                                      (20, 200, "gaps"), (12, 128, "ties"),
                                      (9, 31, "ties"),
                                      (9, 32, "ties"), (9, 33, "random"),
                                      ("wave", 129, "gaps"),
                                      ("wave", 200, "ties"),
                                      ("wave", 1_024, "random"),
                                      (3, 1_025, "ties"),
                                      (2, 12_289, "random"),
                                      (2, 20_000, "ties")])
def test_blitz_chain_kernel_matches_plain(cuda_device, C, M, kind):
    """#8 on the card against its plain version, with ties, invalid
    blocks, gaps past 100,000 and overlaps around -8, in every layout the
    kernel picks by shape: a warp a chain with rows in registers (1, 2
    and 4 a lane, M <= 128), a warp a chain with rows in shared memory
    (M 129-1,024 where the chains pass one wave of 256-thread blocks, 8
    an SM: C "wave"), a block a chain with rows in shared memory (fewer
    chains, or M past 1,024) and, past 14,336 blocks, a block a chain
    with rows in device memory."""
    from biokanga_tpu_torch.ops import blitz_chain as bc

    if C == "wave":
        props = torch.cuda.get_device_properties(cuda_device)
        C = 8 * props.multi_processor_count + 3
    rng = np.random.default_rng(C * M)
    q0 = rng.integers(0, 4_000, (C, M))
    t0 = np.sort(rng.integers(0, 8_000, (C, M)), axis=1)
    ln = rng.integers(16, 60, (C, M))
    if kind == "ties":
        q0 = np.broadcast_to(np.arange(M) * 30, (C, M)).copy()
        t0, ln = q0.copy(), np.full((C, M), 20)
    elif kind == "gaps":
        t0 = np.cumsum(rng.choice([-9, -8, -7, 0, 50, 99_990, 100_001],
                                  (C, M)) + 30, axis=1)
    valid = rng.random((C, M)) < 0.9
    a = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(cuda_device)
         for x in (q0, t0, ln, ln)] + [torch.from_numpy(valid).to(cuda_device)]
    before = bc.chain_scan.launches
    f, pred = bc.chain_scan(*a, 5)
    torch.cuda.synchronize()
    wf, wp = bc.chain_scan_plain(*a, 5)
    assert torch.equal(f, wf) and torch.equal(pred, wp)
    assert bc.chain_scan.launches == before + 1


@pytest.mark.cuda
def test_tools_cli_on_the_card_equal_cpu(cuda_device, tmp_path):
    """`uhamming`, `blitz`, `mergeoverlaps` and `findapproxmatches` with
    --device cuda against --device cpu, byte for byte."""
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.encode import revcomp
    from biokanga_tpu_torch.seq.fasta import write_fasta, write_fastq
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("c1", 30_000), ("c2", 9_000)], seed=3)
    g = seqs[0][1]
    write_fasta(str(tmp_path / "g.fa"), seqs)
    assert main(["index", "-i", str(tmp_path / "g.fa"), "-o",
                 str(tmp_path / "g.npz"), "--lut-bases", "8"]) == 0
    write_fasta(str(tmp_path / "q.fa"), [
        ("a", g[1000:2500]), ("b", revcomp(g[5000:5600])),
        ("s", np.concatenate([g[8000:8300], g[18000:18400]]))])
    rng = np.random.default_rng(1)
    r1, r2 = [], []
    for s in rng.integers(0, 29_000, 200):
        frag = g[s:s + int(rng.integers(120, 190))]
        r1.append(frag[:100].copy())
        r2.append(revcomp(frag[-100:]))
    for m, rs in ((1, r1), (2, r2)):
        write_fastq(str(tmp_path / f"r{m}.fq"),
                    ((f"p{i}", r, None) for i, r in enumerate(rs)))
    write_fasta(str(tmp_path / "guides.fa"),
                [(f"g{i}", g[i * 997:i * 997 + 23]) for i in range(20)])
    write_fasta(str(tmp_path / "small.fa"), [("s1", g[:4_000]),
                                             ("s2", g[9_000:11_000])])
    runs = {
        "u.csv": ["uhamming", "-i", str(tmp_path / "small.fa"), "-K", "50",
                  "-o", str(tmp_path / "u{d}.hmg.npz"), "-O"],
        "b.psl": ["blitz", "-i", str(tmp_path / "q.fa"), "-I",
                  str(tmp_path / "g.npz"), "-o"],
        "m.fq": ["mergeoverlaps", "-i", str(tmp_path / "r1.fq"), "-u",
                 str(tmp_path / "r2.fq"), "-o"],
        "f.csv": ["findapproxmatches", "-i", str(tmp_path / "guides.fa"),
                  "-I", str(tmp_path / "g.fa"), "-o"],
    }
    for out, argv in runs.items():
        for d in ("cpu", "cuda"):
            assert main([a.format(d=d) for a in argv]
                        + [str(tmp_path / f"{d}_{out}"), "--device", d]) == 0
        assert (tmp_path / f"cpu_{out}").read_bytes() == \
            (tmp_path / f"cuda_{out}").read_bytes()


@pytest.mark.cuda
def test_vector_screen_on_the_card_equals_cpu(cuda_device, tmp_path):
    """Contaminants.match_vectors on two full blocks of 8,192 reads and a
    partial one (the last block of `filter -c` pads to 128 rows), both
    mates, against its CPU run; the card launches #1-#3 on every block."""
    import readprep_reads as rp
    from biokanga_tpu_torch.seq.contaminants import Contaminants
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.sim.simreads import random_genome

    g = random_genome([("chr", 300_000)], seed=81)[0][1]
    _, r1, r2, ln = rp.library(g, 2 * 8_192 + 100, seed=82)
    write_fasta(str(tmp_path / "c.fa"), rp.contaminant_entries(82))
    dbs = {dev: Contaminants.load(str(tmp_path / "c.fa"), dev)
           for dev in ("cpu", cuda_device)}
    for s, e in ((0, 8_192), (8_192, 16_384), (16_384, 16_484)):
        for mate, reads in enumerate((r1, r2)):
            want = dbs["cpu"].match_vectors(reads[s:e], ln[s:e],
                                            is_pe2=bool(mate))
            before = (sort.sort_rows.launches, sort.sort2_rows.launches,
                      ep.hamming_extend_packed.launches)
            got = dbs[cuda_device].match_vectors(reads[s:e], ln[s:e],
                                                 is_pe2=bool(mate))
            after = (sort.sort_rows.launches, sort.sort2_rows.launches,
                     ep.hamming_extend_packed.launches)
            assert np.array_equal(got, want)
            assert all(a > b for a, b in zip(after, before))
    assert dbs["cpu"].report_rows() == dbs[cuda_device].report_rows()
    assert dbs["cpu"].vectors[0].hit_tot > 100


@pytest.mark.cuda
def test_filter_and_ngsqc_on_the_card_equal_cpu(cuda_device, tmp_path):
    """`filter -c --near-dedupe` (PE) and `ngsqc -c` on 8,292 planted
    pairs (a full block and a partial one) with --device cuda against
    --device cpu, byte for byte."""
    import readprep_reads as rp
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.fasta import write_fasta, write_fastq
    from biokanga_tpu_torch.sim.simreads import random_genome

    g = random_genome([("chr", 300_000)], seed=83)[0][1]
    names, r1, r2, _ = rp.library(g, 8_292, seed=84)
    for m, r in ((1, r1), (2, r2)):
        write_fastq(str(tmp_path / f"r{m}.fq"),
                    ((n, c, None) for n, c in zip(names, r)))
    write_fasta(str(tmp_path / "c.fa"), rp.contaminant_entries(84))
    for d in ("cpu", "cuda"):
        assert main(["filter", "-i", str(tmp_path / "r1.fq"), "-u",
                     str(tmp_path / "r2.fq"), "-o",
                     str(tmp_path / f"{d}_1.fq"), "-U",
                     str(tmp_path / f"{d}_2.fq"), "-c", str(tmp_path / "c.fa"),
                     "--near-dedupe", "--device", d]) == 0
        assert main(["ngsqc", "-i", str(tmp_path / "r1.fq"), "-o",
                     str(tmp_path / f"{d}.html"), "-c",
                     str(tmp_path / "c.fa"), "--device", d]) == 0
    for out in ("_1.fq", "_2.fq", ".html"):
        assert (tmp_path / f"cpu{out}").read_bytes() == \
            (tmp_path / f"cuda{out}").read_bytes()
    shares = rp.planted_shares(names,
                               rp.fastq_name_lengths(tmp_path / "cuda_1.fq"))
    assert shares["vector_rejected"] >= rp.MIN_VECTOR_REJECTED
    assert shares["adapter_trimmed"] >= rp.MIN_ADAPTER_TRIMMED


@pytest.mark.cuda
def test_conformation_gather_on_the_card_equals_cpu(cuda_device, tmp_path):
    """conformation_profile on the card equals its CPU run exactly (N
    runs, short sequences, an undefined value) and launches its gather;
    `predconfnucs` and `genstructprofile` (several gathers a run) with
    --device cuda against --device cpu, byte for byte."""
    import chromatin_inputs as ci
    from biokanga_tpu_torch.chromatin import conformation as conf
    from biokanga_tpu_torch.cli import main
    from biokanga_tpu_torch.seq.fasta import write_fasta
    from biokanga_tpu_torch.tools import chromatin_tools

    ci.write_octamer_table(tmp_path / "oct.csv", seed=5)
    table = conf.load_octamer_params(str(tmp_path / "oct.csv"))
    rng = np.random.default_rng(6)
    for n in (0, 1, 2, 8, 147, 300_000):
        codes = rng.integers(0, 5, n).astype(np.int8)
        codes[: n // 3] = np.minimum(codes[: n // 3], 3)
        before = conf.gather_column.launches
        got = conf.conformation_profile(codes, table, "roll", -2.5,
                                        device=cuda_device)
        assert conf.gather_column.launches == before + 1
        want = conf.conformation_profile(codes, table, "roll", -2.5,
                                         device=torch.device("cpu"))
        assert got.dtype == np.float32 and np.array_equal(got, want)
    genome = ci.yeast_genome(seed=7)[:3]
    write_fasta(str(tmp_path / "g.fa"), genome)
    write_fasta(str(tmp_path / "cores.fa"), ci.cores(genome, 4_000, seed=8))
    runs = {"nucs.bg": ["predconfnucs", "-i", str(tmp_path / "g.fa"), "-I",
                        str(tmp_path / "oct.csv"), "-o"],
            "prof.csv": ["genstructprofile", "-i", str(tmp_path / "cores.fa"),
                         "-p", str(tmp_path / "oct.csv"), "--param", "twist",
                         "-o"]}
    for out, argv in runs.items():
        for d in ("cpu", "cuda"):
            before = conf.gather_column.launches
            assert main(argv + [str(tmp_path / f"{d}_{out}"), "--device",
                                d]) == 0
            launched = conf.gather_column.launches - before
            # one gather a chromosome; a batch of cores closes once it
            # holds PROFILE_BATCH_STEPS steps, 146 a core
            per_batch = -(-chromatin_tools.PROFILE_BATCH_STEPS // 146)
            if d == "cuda":
                assert launched == (3 if out == "nucs.bg"
                                    else -(-4_000 // per_batch))
        assert (tmp_path / f"cpu_{out}").read_bytes() == \
            (tmp_path / f"cuda_{out}").read_bytes()


# ---- the seed stage's kernels (ops/seed_rows.py, csrc/seed_rows.cu) ----

def _seed_index(device):
    """A 210 kb genome with a 150 bp block in 80 copies (its cores pass
    H 16 and 48), a 3 kb poly-A run (the widest LUT bucket, where the
    binary search takes its most steps) and a run of Ns; the host index
    and the index on `device`."""
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("chrA", 150_000), ("chrB", 60_000)], seed=41)
    block = seqs[0][1][5_000:5_150].copy()
    for i in range(80):
        seqs[1][1][2_000 + 400 * i: 2_150 + 400 * i] = block
    seqs[0][1][100_000:103_000] = 0
    seqs[0][1][120_000:120_050] = 4
    host = build_index(seqs, lut_bases=8)
    return host, to_device(host, device)


def _seed_reads(host, B, L, seed):
    """B reads of L bases: from anywhere, the repeat, the poly-A run and
    the Ns, every other one reverse complemented, 2% substitutions,
    ragged lengths; then the edge rows: all N, length 0, poly-A (every
    core over H, in the widest bucket), the repeat exactly (every core
    over H)."""
    rng = np.random.default_rng(seed)
    g = host.codes
    n = len(g)
    starts = rng.integers(0, n - L, B)
    starts[1::7] = 150_000 + 2_000 + 400 * rng.integers(0, 80, len(
        starts[1::7])) + rng.integers(0, max(1, 150 - L), len(starts[1::7]))
    starts[2::11] = rng.integers(99_000, 103_000, len(starts[2::11]))
    starts[3::13] = rng.integers(119_900, 120_050, len(starts[3::13]))
    starts = np.clip(starts, 0, n - L)
    r = np.stack([g[s:s + L] for s in starts]).astype(np.int8)
    r[1::2] = np.where(r[1::2] >= 4, r[1::2], 3 - r[1::2])[:, ::-1]
    sub = rng.random(r.shape) < 0.02
    r[sub] = (r[sub] + 1) % 4
    lengths = np.full(B, L, np.int32)
    lengths[::5] = rng.integers(1, L + 1, len(lengths[::5]))
    r[np.arange(L)[None, :] >= lengths[:, None]] = 4
    r[0], lengths[0] = 4, L
    r[1], lengths[1] = 4, 0
    r[2], lengths[2] = 0, L
    at = 150_000 + 2_000
    r[3], lengths[3] = g[at:at + L] if L <= 150 else 0, L
    return r, lengths


# (L, core_len, H, cap): fast and classic passes, the ladder's rescue
# widths, cores of two key words, a long read
SEED_SHAPES = [(100, 14, 16, 32), (100, 8, 48, 192), (100, 10, 48, 96),
               (150, 12, 16, 10**6), (100, 20, 256, 1024),
               (100, 12, 1024, 1024), (37, 6, 48, 10**6),
               (1000, 12, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(SEED_SHAPES)))
def test_seed_kernels_match_plain(cuda_device, shape):
    """seed_rows and dedup_pack on the card equal their plain versions on
    the same card tensors bit for bit, both strands, occ_skip on and
    off, with an ownership limit and without; each call launches its
    kernel once."""
    from biokanga_tpu_torch.ops import seed_rows as sr

    L, k, H, cap = SEED_SHAPES[shape]
    host, didx = _seed_index(cuda_device)
    B = 64 if L > 500 else 4_133
    r, lengths = _seed_reads(host, B, L, seed=shape)
    rt = torch.from_numpy(r).to(cuda_device)
    lt = torch.from_numpy(lengths).to(cuda_device)
    offs = torch.tensor(list(range(0, L - k + 1, max(k, 11))),
                        dtype=torch.int32, device=cuda_device)
    seen = {"over": 0, "filled": 0}
    for rc in (False, True):
        for occ_skip, owned in ((True, None), (False, 180_000)):
            args = (didx, rt, lt, rc, offs, k, H, owned, occ_skip)
            n0 = sr.seed_rows.launches
            flat, overflow = sr.seed_rows(*args)
            assert sr.seed_rows.launches == n0 + 1
            want = sr.seed_rows_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(flat, want[0]), (rc, occ_skip)
            assert torch.equal(overflow, want[1]), (rc, occ_skip)
            srt = sort.sort_rows(flat)
            n0 = sr.dedup_pack.launches
            got = sr.dedup_pack(srt, overflow, rt, lt, rc, cap, occ_skip)
            assert sr.dedup_pack.launches == n0 + 1
            plain = sr.dedup_pack_plain(srt, overflow, rt, lt, rc, cap,
                                        occ_skip)
            torch.cuda.synchronize()
            for i, (g, p) in enumerate(zip(got, plain)):
                assert torch.equal(g, p), (rc, occ_skip, i)
            seen["over"] += int(overflow.sum())
            seen["filled"] += int((flat != I32_MAX).sum())
    assert seen["filled"] > B and (H > 256 or seen["over"] > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,SH,S,cap", [(4_133, 384, 8, 192),
                                        (4_133, 128, 8, 32),
                                        (777, 480, 10, 96),
                                        (64, 369 * 1_024, 369, 8_192),
                                        (100, 50, 5, 10**6), (33, 1, 1, 0)])
def test_dedup_pack_kernel_on_sorted_rows(cuda_device, B, SH, S, cap):
    """dedup_pack on sorted rows of repeated values, sentinels and
    full rows equals its plain version bit for bit."""
    from biokanga_tpu_torch.ops import seed_rows as sr

    rng = np.random.default_rng(SH + cap)
    x = rng.integers(-3, 40, (B, SH)).astype(np.int32)
    x[rng.random((B, SH)) < rng.random((B, 1))] = I32_MAX
    x[: B // 7] = rng.integers(0, 2**31 - 1, (B // 7, SH))   # no sentinel
    srt = torch.sort(torch.from_numpy(x).to(cuda_device), dim=1).values
    overflow = torch.from_numpy(rng.random((B, S)) < 0.1).to(cuda_device)
    L = 150
    r = torch.from_numpy(rng.integers(0, 5, (B, L)).astype(np.int8)).to(
        cuda_device)
    ln = torch.from_numpy(rng.integers(0, L + 1, B).astype(np.int32)).to(
        cuda_device)
    for rc in (False, True):
        for occ_skip in (True, False):
            got = sr.dedup_pack(srt, overflow, r, ln, rc, cap, occ_skip)
            want = sr.dedup_pack_plain(srt, overflow, r, ln, rc, cap,
                                       occ_skip)
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w), (rc, occ_skip, i)


# ---- the align engine's CUDA graphs (align/pipeline.py _CoreGraphs) ----

GRAPH_KERNELS = ("seed_rows", "sort_rows", "dedup_pack", "sort2_rows",
                 "hamming_extend_packed")


def _repeat_genome():
    """A 300 kb genome with a 150 bp block in 100 copies: its cores pass
    the classic pass's 48 positions, so its reads go through the fast
    pass, the classic rerun and the ladder's first step."""
    from biokanga_tpu_torch.sim.simreads import random_genome

    seqs = random_genome([("chrA", 200_000), ("chrB", 100_000)], seed=29)
    block = seqs[0][1][5_000:5_150].copy()
    for i in range(100):
        seqs[1][1][10_000 + 400 * i: 10_150 + 400 * i] = block
    return seqs


def _graph_pairs(seqs, k, n_pairs=512, L=100):
    """Batch k of pairs: 12 pairs with one mate in the repeat block and 12
    with a mate that has a substitution in every seed core, every batch,
    so the rerun pads to one row count and the ladder runs each time."""
    from biokanga_tpu_torch.sim.simreads import simulate_reads

    _, reads, _ = simulate_reads(seqs, n_pairs, read_len=L, sub_rate=0.01,
                                 seed=300 + k, pe=True, insert_min=200,
                                 insert_max=500)
    r1, r2 = reads[0::2].copy(), reads[1::2].copy()
    g = seqs[1][1]
    for i in range(12):
        s = 10_000 + 400 * (7 * i + k) + 20
        r1[i] = g[s:s + L]
        r1[i][50] = (r1[i][50] + 1) % 4
        j = 40 + i
        r2[j][4:93:11] = (r2[j][4:93:11] + 1) % 4
    ln = np.full(n_pairs, L, np.int32)
    return r1, ln, r2, ln


def _wrap_kernels(monkeypatch, calls):
    """Count calls through the pipeline module's kernel names, wrapped as
    the benchmark wraps them (`*args, **kwargs` passed on)."""
    from biokanga_tpu_torch.align import pipeline

    for name in GRAPH_KERNELS:
        fn = getattr(pipeline, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(pipeline, name, wrapped)


def _assert_same(got, want, where):
    assert got.keys() == want.keys(), where
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same(got[k], v, f"{where}.{k}")
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, (where, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{where}.{k}")
        else:
            assert got[k] == v, (where, k)


@pytest.mark.cuda
def test_graph_launches_in_flight_equal_eager(cuda_device, monkeypatch):
    """Launch k + 1 before fetching k, as the CLI loop does: the key's
    first launch runs eagerly, the second captures and replays, the rest
    replay, under a profiler too; every result equals align_core run
    eagerly on the same card, and each launch calls each kernel as
    often on both paths."""
    from torch.profiler import ProfilerActivity, profile

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.utils import trace

    seqs = _repeat_genome()
    didx = to_device(build_index(seqs, lut_bases=8), cuda_device)
    ap = AlignParams()
    eng = pipeline.AlignEngine(didx, ap)
    fp = ap.derive_fast(100, didx.total_len, didx.lut_bases)
    batches = []
    for k in range(5):
        r1, ln, r2, _ = _graph_pairs(seqs, k)
        batches.append((np.concatenate([r1, r2]), np.concatenate([ln, ln])))
    calls = {}
    _wrap_kernels(monkeypatch, calls)
    want, eager_calls = [], []
    for reads, lengths in batches:
        out = pipeline.align_core(
            didx, torch.from_numpy(reads).to(cuda_device),
            torch.from_numpy(lengths).to(cuda_device), ap=ap, dp=fp.dp,
            H=fp.H, cand_cap=fp.cand_cap, strand=ap.strand)
        want.append({k: v.cpu().numpy() for k, v in out.items()})
        eager_calls.append(dict(calls))
        calls.clear()
    trace.reset_counts()
    got, replayed, graph_calls = [], [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pending = None
        for reads, lengths in batches:
            before = trace.counts().get("engine.graph_launches", 0)
            cur = eng.launch(reads, lengths, H=fp.H, cand_cap=fp.cand_cap,
                             dp=fp.dp)
            replayed.append(trace.counts()["engine.graph_launches"] - before)
            graph_calls.append(dict(calls))
            calls.clear()
            if pending is not None:
                got.append(pipeline._to_host(*pending))
            pending = cur
        got.append(pipeline._to_host(*pending))
    assert replayed == [0, 1, 1, 1, 1]
    assert trace.counts()["engine.launches"] == 5
    assert len(eng._cores) == 1
    assert graph_calls == eager_calls
    assert eager_calls[0] == {"seed_rows": 2, "sort_rows": 2,
                              "dedup_pack": 2, "sort2_rows": 1,
                              "hamming_extend_packed": 2}
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.pop("derived") == fp.dp
        _assert_same(g, w, f"batch {k}")
    assert sum(int(w["unique"].sum()) for w in want) > 4_000
    assert sum(int(w["n_over"].sum()) for w in want) > 0
    trace.reset_counts()


@pytest.mark.cuda
def test_graph_keys_interleaved_equal_eager(cuda_device, monkeypatch):
    """Paired-end batches in the CLI's loop: the primary pass on the
    current stream, the padded classic rerun and the ladder's 2,048-row
    dispatches on the engine's own stream, three keys interleaved in every
    batch, the rerun enqueued ahead of the next pass where the card is
    done (forced in one run by waiting for the card before each launch);
    every field of every batch equals the engine's with no graph and one
    batch at a time."""
    from torch.profiler import ProfilerActivity, profile

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.align.pe import PEAligner, PEParams
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device
    from biokanga_tpu_torch.utils import trace

    seqs = _repeat_genome()
    didx = to_device(build_index(seqs, lut_bases=8), cuda_device)
    batches = [_graph_pairs(seqs, k) for k in range(5)]
    calls = {}
    _wrap_kernels(monkeypatch, calls)
    max_keys = pipeline.MAX_GRAPH_KEYS

    def run(keys, in_flight, wait_first=False):
        monkeypatch.setattr(pipeline, "MAX_GRAPH_KEYS", keys)
        pea = PEAligner(pipeline.AlignEngine(didx, AlignParams()),
                        PEParams(pair_min_len=100, pair_max_len=600))
        out, pending = [], None
        trace.reset_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            for b in batches:
                if not in_flight:
                    out.append(pea.finish_pairs(pea.launch_pairs(*b)))
                    continue
                if wait_first:
                    torch.cuda.synchronize()
                cur = pea.launch_pairs(*b)
                if pending is not None:
                    out.append(pea.finish_pairs(pending))
                pending = cur
            if pending is not None:
                out.append(pea.finish_pairs(pending))
        n = dict(calls)
        calls.clear()
        return out, n, pea.engine, trace.counts()

    want, eager_calls, _, c = run(0, False)
    assert c.get("engine.early_reruns", 0) == 0
    for wait_first in (False, True):
        got, graph_calls, eng, c = run(max_keys, True, wait_first)
        assert graph_calls == eager_calls
        rows = sorted(key[1] for key in eng._cores)
        # the primary pass (1,024 rows), the rerun padded to 64 and the
        # ladder's fixed 2,048-row dispatch
        assert rows == [64, 1024, 2048], rows
        assert len({key[0] for key in eng._cores}) == 2    # two streams
        if wait_first:
            # every batch's rerun but the last went ahead of the next pass
            assert c["engine.early_reruns"] == len(batches) - 1
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"batch {k}")
    assert sum(int(w["proper"].sum()) for w in want) > 2_000


@pytest.mark.cuda
def test_resident_chunks_share_graphs_and_equal_the_cpu(cuda_device,
                                                        monkeypatch):
    """Three chunks of the repeat genome resident on the card, built there
    (`build_resident_chunks`) and uploaded from a host ChunkedIndex, one
    engine a chunk sharing one graph set: batches with one in flight, the
    keys eager, captured and replayed, equal the CPU's resident path field
    for field, and a key's graphs serve every chunk."""
    from torch.profiler import ProfilerActivity, profile

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.align.pe import PEParams
    from biokanga_tpu_torch.align.pipeline import pad_rows
    from biokanga_tpu_torch.index import chunked as tch
    from biokanga_tpu_torch.index.device_build import build_resident_chunks
    from biokanga_tpu_torch.parallel.chunked import (ChunkedAligner,
                                                     ChunkedPEAligner)
    from biokanga_tpu_torch.utils import trace

    seqs = _repeat_genome()
    cat = np.concatenate([s for _, s in seqs])
    names = [n for n, _ in seqs]
    ci = tch.build_chunked_index(seqs, num_chunks=3, overlap=1024,
                                 lut_bases=8)
    batches = []
    for k in range(5):
        r1, l1, r2, l2 = _graph_pairs(seqs, k)
        batches.append(pad_rows(r1, l1) + pad_rows(r2, l2))
    pe = PEParams(pair_min_len=100, pair_max_len=600)
    ran = {}                  # a _CoreGraphs -> the indexes it ran for
    real_run = pipeline._CoreGraphs.run

    def recording(core, didx=None):
        ran.setdefault(id(core), set()).add(id(didx))
        return real_run(core, didx)

    monkeypatch.setattr(pipeline._CoreGraphs, "run", recording)

    def run(index, device):
        pea = ChunkedPEAligner(ChunkedAligner(index, device=device), pe)
        assert pea.ca.resident is not None
        out, pending = [], None
        for b in batches:
            cur = pea.launch_pairs(*b)
            if pending is not None:
                out.append(pea.finish_pairs(pending))
            pending = cur
        out.append(pea.finish_pairs(pending))
        return out, pea

    for source in ("device_built", "uploaded"):
        index = (build_resident_chunks(cat, ci.entry_starts, names,
                                       lut_bases=8,
                                       max_chunk=-(-len(cat) // 3),
                                       overlap=1024, device=cuda_device)
                 if source == "device_built" else ci)
        cpu_index = (build_resident_chunks(cat, ci.entry_starts, names,
                                           lut_bases=8,
                                           max_chunk=-(-len(cat) // 3),
                                           overlap=1024, device="cpu")
                     if source == "device_built" else ci)
        want, _ = run(cpu_index, "cpu")
        ran.clear()
        trace.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            got, pea = run(index, cuda_device)
        c = trace.counts()
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{source} batch {k}")
        engines = pea.ca.engines
        assert all(e.didx.key_hi.dtype == torch.int32 for e in engines)
        cores = engines[0]._cores
        assert all(e._cores is cores for e in engines) and cores
        # the primary and classic keys ran for every chunk's index
        served = sorted(len(v) for v in ran.values())
        assert served[-2:] == [3, 3] and served[0] >= 1
        assert c["engine.graph_launches"] > 0
        assert "chunked.uploads" not in c
        assert c["chunked.index_bytes"] == 5 * pea.ca.resident.nbytes()
        pea.ca.close()
    assert sum(int(w["proper"].sum()) for w in want) > 2_000


@pytest.mark.cuda
def test_two_resident_chunks_replay_one_core_each_key(cuda_device,
                                                      monkeypatch):
    """A two-chunk index resident on the card, blocks with one in flight:
    each launch key's one `_CoreGraphs` replays for both chunks, its two
    segments captured once, and every block equals the same aligner's
    with every launch eager."""
    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.index import chunked as tch
    from biokanga_tpu_torch.parallel.chunked import ChunkedAligner

    seqs = _repeat_genome()
    ci = tch.build_chunked_index(seqs, num_chunks=2, overlap=1024,
                                 lut_bases=8)
    blocks = []
    for k in range(5):
        r1, ln, r2, _ = _graph_pairs(seqs, k)
        blocks.append(pipeline.pad_rows(np.concatenate([r1, r2]),
                                        np.concatenate([ln, ln])))
    ran, captures = {}, []
    real_run, real_capture = pipeline._CoreGraphs.run, pipeline._cuda_capture

    def recording(core, didx=None):
        ran.setdefault(id(core), []).append(id(didx))
        return real_run(core, didx)

    def counting(device):
        capture = real_capture(device)

        def each(fn):
            captures.append(fn)
            return capture(fn)

        return each

    monkeypatch.setattr(pipeline._CoreGraphs, "run", recording)
    monkeypatch.setattr(pipeline, "_cuda_capture", counting)
    max_keys = pipeline.MAX_GRAPH_KEYS

    def run(keys):
        monkeypatch.setattr(pipeline, "MAX_GRAPH_KEYS", keys)
        ca = ChunkedAligner(ci, device=cuda_device)
        assert ca.resident is not None and len(ca.engines) == 2
        out, pending = [], None
        for b in blocks:
            cur = ca.launch_primary(*b)
            if pending is not None:
                out.append(ca.finish_primary(pending))
            pending = cur
        out.append(ca.finish_primary(pending))
        return out, ca

    want, _ = run(0)
    assert not ran and not captures
    got, ca = run(max_keys)
    for k, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"block {k}")
    cores = ca.engines[0]._cores
    assert ca.engines[1]._cores is cores and cores
    chunks = {id(e.didx) for e in ca.engines}
    # the fast and the classic keys: one core each, both chunks through it
    assert len(ran) >= 2
    assert sum(set(v) == chunks for v in ran.values()) >= 2
    assert len(captures) == 2 * len(cores)
    ca.close()


@pytest.mark.cuda
def test_repointed_engine_frees_its_graphs_outside_captures(cuda_device,
                                                            monkeypatch):
    """One engine pointed from index to index, as the cycling chunked path
    points it: the collector never runs inside a capture (a graph it frees
    there invalidates the capture), the dropped index's graphs are freed
    as the engine is re-pointed, and every result equals an engine's with
    no graph."""
    import gc
    import weakref

    from biokanga_tpu_torch.align import pipeline
    from biokanga_tpu_torch.align.params import AlignParams
    from biokanga_tpu_torch.index.build import build_index
    from biokanga_tpu_torch.index.device import to_device

    seqs = _repeat_genome()
    didx = to_device(build_index(seqs, lut_bases=8), cuda_device)
    ap = AlignParams()
    blocks = []
    for k in range(3):
        r1, ln, r2, _ = _graph_pairs(seqs, k)
        blocks.append((np.concatenate([r1, r2]), np.concatenate([ln, ln])))
    monkeypatch.setattr(pipeline, "MAX_GRAPH_KEYS", 0)
    eager = pipeline.AlignEngine(didx, ap)
    want = [eager.align_with_rescue(*b) for b in blocks]
    monkeypatch.undo()
    collecting = []
    accept = pipeline._accept

    def spy(*a, **k):
        collecting.append(gc.isenabled())
        return accept(*a, **k)

    monkeypatch.setattr(pipeline, "_accept", spy)
    eng = pipeline.AlignEngine(didx, ap)
    for turn in range(3):
        got = [eng.align_with_rescue(*b) for b in blocks]
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"turn {turn} block {k}")
        old = [weakref.ref(core) for core in eng._cores.values()]
        assert old
        eng.didx = didx
        assert not eng._cores and all(r() is None for r in old)
    # eager launches call _accept with the collector on, captures with it
    # off
    assert True in collecting and False in collecting
    assert gc.isenabled()
