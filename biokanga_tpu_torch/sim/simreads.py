"""Copy of biokanga_tpu/sim/simreads.py: the NGS read simulator with
ground truth in read descriptors.

Capability match for `biokanga simreads` (biokanga/SimReads.cpp): SE/PE
read generation with controlled substitution rates, emitting the reference
descriptor format so alignment correctness is measurable by parsing
aligner output against descriptors:

  @lcl|usimreads|<readnum>|<chrom>|<start>|<end>|<len>|<strand>|<hamming>|<subs>|<indel>

(format: biokanga/SimReads.cpp:3054-3056; start/end are 1-based inclusive.)
Host-side numpy; this is the test-pyramid foundation (SURVEY.md §4.1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.encode import revcomp


@dataclass
class SimReadTruth:
    readnum: int
    chrom: str
    start: int   # 1-based inclusive
    end: int     # 1-based inclusive
    length: int
    strand: str  # '+' or '-'
    subs: int
    indels: int = 0
    hamming: int = 0   # min-Hamming of the source window (from -H .hmg)

    def descriptor(self) -> str:
        return (
            f"lcl|usimreads|{self.readnum:08d}|{self.chrom}|{self.start}"
            f"|{self.end}|{self.length}|{self.strand}|{self.hamming}"
            f"|{self.subs}|{self.indels}"
        )

    @staticmethod
    def parse(name: str) -> "SimReadTruth":
        f = name.split("|")
        if f[0] != "lcl" or f[1] != "usimreads":
            raise ValueError(f"not a simreads name: {name}")
        return SimReadTruth(
            readnum=int(f[2]),
            chrom=f[3],
            start=int(f[4]),
            end=int(f[5]),
            length=int(f[6]),
            strand=f[7],
            hamming=int(f[8]),
            subs=int(f[9]),
            indels=int(f[10]),
        )


# --- induced sequencer-error profiles (SimReads.cpp SimSeqErrors) ------
# static profile: proportions of reads with 0..7 subs, remainder 8
# (StaticErrProfile table, biokanga/SimReads.cpp)
STATIC_ERR_PROFILE = [0.367879, 0.367879, 0.183944, 0.061313, 0.015328,
                      0.003066, 0.000511, 0.000073]
# Illumina cumulative spatial distribution: moderate 5' increase, most
# subs at the 3' end (IlluminaSpatialDist, biokanga/SimReads.cpp)
ILLUMINA_SPATIAL = np.array([40, 55, 64, 72, 80, 88, 96, 104, 112, 121,
                             131, 142, 156, 174, 197, 228, 270, 325, 400,
                             500])


def _num_subs_profile(n: int, L: int, mode: str, rate: float, rng):
    """Per-read induced-substitution counts for each -g error mode."""
    if mode == "none":
        return np.zeros(n, np.int64)
    if mode == "fixed":       # eSEPfixerrs: fixed count per read
        return np.full(n, max(0, int(rate)), np.int64)
    if mode == "static":      # eSEPstatic: the internal profile table
        probs = list(STATIC_ERR_PROFILE)
    elif mode == "dyn":       # eSEPdyn: derived from per-base rate
        probs, acc = [], 0.0
        cur = (1.0 - rate) ** L
        for _ in range(8):
            probs.append(cur)
            acc += cur
            cur = (1.0 - acc) / 2
    else:
        raise ValueError(f"unknown error mode {mode}")
    probs.append(max(0.0, 1.0 - sum(probs)))  # remainder -> 8 subs
    p = np.asarray(probs) / sum(probs)
    return rng.choice(len(p), size=n, p=p).astype(np.int64)


def induce_seq_errors(reads: np.ndarray, lengths, mode: str, rate: float,
                      uniform: bool, rng) -> np.ndarray:
    """In-place induced substitutions (eSEPfixerrs/static/dyn modes with
    uniform or Illumina-spatial placement).  Returns actual per-read
    substitution counts."""
    n, L = reads.shape
    lengths = np.broadcast_to(np.asarray(lengths), (n,))
    want = _num_subs_profile(n, L, mode, rate, rng)
    want = np.minimum(want, lengths)
    subbed = np.zeros((n, L), bool)
    smax = int(want.max()) if n else 0
    seg_w = np.diff(np.concatenate([[0], ILLUMINA_SPATIAL])) / 500.0
    K = len(ILLUMINA_SPATIAL)
    # extra rounds retry position collisions (the reference loops until
    # the exact count lands, SimSeqErrors while(RandSubs < NumSubs2Induce))
    for k in range(smax + 12):
        live = subbed.sum(axis=1) < want
        if uniform:
            pos = rng.integers(0, lengths)
        else:
            seg = rng.choice(K, size=n, p=seg_w)
            lo = (seg * lengths) // K
            hi = np.where(seg == K - 1, lengths - 1,
                          lo + np.maximum(lengths // K, 1) - 1)
            pos = lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
            pos = np.minimum(pos, lengths - 1)
        hit = live & ~subbed[np.arange(n), pos] & (reads[np.arange(n), pos] < 4)
        delta = rng.integers(1, 4, size=n)
        rows = np.nonzero(hit)[0]
        reads[rows, pos[rows]] = (reads[rows, pos[rows]] + delta[rows]) % 4
        subbed[rows, pos[rows]] = True
    return subbed.sum(axis=1)


def plant_snps(
    seqs: list[tuple[str, np.ndarray]],
    snp_rate_per_mbp: int,
    seed: int = 1,
    bed_path: str | None = None,
):
    """Plant simulated SNPs into a COPY of the genome at `snp_rate_per_mbp`
    (1 + len*rate/1e6 per entry, cf. SimReads.cpp:2437 simulated-SNP loop)
    and optionally write the truth BED (track 'SimSNPs').

    Returns (mutated_seqs, snps) with snps = [(chrom, ofs, ref, alt)].
    """
    rng = np.random.default_rng(seed)
    out_seqs, snps = [], []
    for name, s in seqs:
        s2 = s.copy()
        n_snps = 1 + int(len(s) * snp_rate_per_mbp / 1e6)
        done = 0
        while done < n_snps:
            ofs = int(rng.integers(0, len(s2)))
            prev = int(s2[ofs])
            if prev > 3:
                continue
            alt = int(rng.integers(0, 4))
            if alt == prev:
                continue
            s2[ofs] = alt
            snps.append((name, ofs, prev, alt))
            done += 1
        out_seqs.append((name, s2))
    if bed_path:
        b2a = "ACGTN"
        with open(bed_path, "w") as f:
            f.write('track type=bed name="SimSNPs" '
                    'description="Simulated SNPS"\n')
            for i, (chrom, ofs, ref, alt) in enumerate(snps):
                f.write(f"{chrom}\t{ofs}\t{ofs + 1}\tSNP_{i}_"
                        f"{b2a[ref]}to{b2a[alt]}\t0\t+\n")
    return out_seqs, snps


def simulate_reads(
    seqs: list[tuple[str, np.ndarray]],
    num_reads: int,
    read_len: int = 100,
    sub_rate: float = 0.0,
    max_subs_per_read: int | None = None,
    strand: str = "both",
    seed: int = 1,
    pe: bool = False,
    insert_min: int = 200,
    insert_max: int = 500,
    hammings: np.ndarray | None = None,  # per-absolute-locus min-Hamming
    indel_rate: float = 0.0,     # -X: per-read InDel probability (0..1)
    indel_size: int = 3,         # -x: max InDel size (1..9)
    error_mode: str = "none",    # -g: none|fixed|static|dyn (etSEMode)
    error_rate: float = 0.01,    # -z: dyn per-base rate / fixed count
    error_uniform: bool = True,  # -Z: uniform vs Illumina-spatial placement
    prop_random: float = 0.0,    # -R: proportion of completely random reads
):
    """Generate reads. Returns (names, codes (N,L) int8, truths list).

    For PE, returns 2N rows: rows 2i / 2i+1 are the 5' and 3' ends, the 3'
    end reverse-complemented (standard FR orientation).
    """
    rng = np.random.default_rng(seed)
    lens = np.array([len(s) for _, s in seqs], dtype=np.int64)
    usable = lens - (insert_max if pe else read_len)
    if (usable < 0).all():
        raise ValueError("all sequences shorter than read/insert length")
    weights = np.maximum(usable + 1, 0).astype(np.float64)
    weights /= weights.sum()

    # post-processed modes (InDels / error profiles / random reads,
    # SimReads.cpp SimInDels + SimSeqErrors order): generate base reads
    # WITHOUT substitutions first, then indel -> induce errors -> random
    post = indel_rate > 0 or error_mode != "none" or prop_random > 0
    if max_subs_per_read is None:
        base_sub = 0.0 if post else sub_rate
        if pe:
            names, reads, truths = _simulate_pe_fast(
                seqs, num_reads, read_len, base_sub, strand, rng, weights,
                insert_min, insert_max,
            )
        else:
            names, reads, truths = _simulate_se_fast(
                seqs, num_reads, read_len, base_sub, strand, rng, weights,
                hammings=hammings,
            )
        if post:
            rng2 = np.random.default_rng(seed + 101)
            if indel_rate > 0:
                _apply_indels(seqs, reads, truths, indel_rate, indel_size,
                              rng2)
            if error_mode != "none":
                nsubs = induce_seq_errors(
                    reads, read_len, error_mode, error_rate, error_uniform,
                    rng2,
                )
            elif sub_rate > 0:
                mask = (rng2.random(reads.shape) < sub_rate) & (reads < 4)
                delta = rng2.integers(1, 4, size=reads.shape)
                reads[:] = np.where(mask, (reads + delta) % 4, reads)
                nsubs = mask.sum(axis=1)
            else:
                nsubs = np.zeros(len(reads), np.int64)
            if prop_random > 0:
                rand_rows = np.nonzero(
                    rng2.random(len(reads)) < prop_random
                )[0]
                reads[rand_rows] = rng2.integers(
                    0, 4, size=(len(rand_rows), read_len), dtype=np.int8
                )
                for i in rand_rows:
                    truths[i].chrom = "random"
                    truths[i].start = 1
                    truths[i].end = read_len
            for i, t in enumerate(truths):
                t.subs = int(nsubs[i])
            names = [t.descriptor() for t in truths]
        return names, reads, truths

    names: list[str] = []
    rows: list[np.ndarray] = []
    truths: list[SimReadTruth] = []

    def mutate(codes: np.ndarray) -> tuple[np.ndarray, int]:
        if sub_rate <= 0:
            return codes, 0
        nsub = rng.binomial(len(codes), sub_rate)
        if max_subs_per_read is not None:
            nsub = min(nsub, max_subs_per_read)
        if nsub == 0:
            return codes, 0
        out = codes.copy()
        pos = rng.choice(len(codes), size=nsub, replace=False)
        offset = rng.integers(1, 4, size=nsub)
        out[pos] = (out[pos] + offset) % 4
        return out, int(nsub)

    n_frag = num_reads
    for i in range(n_frag):
        ei = rng.choice(len(seqs), p=weights)
        name_e, s = seqs[ei]
        if pe:
            insert = int(rng.integers(insert_min, insert_max + 1))
            insert = min(insert, len(s))
            start0 = int(rng.integers(0, len(s) - insert + 1))
            frag = s[start0 : start0 + insert]
            minus = strand == "both" and rng.random() < 0.5 or strand == "-"
            if minus:
                frag = revcomp(frag)
            r1 = frag[:read_len].copy()
            r2 = revcomp(frag[-read_len:])
            for mate, r in ((1, r1), (2, r2)):
                rm, nsub = mutate(r)
                # genomic footprint of this mate
                if mate == 1:
                    g0 = start0 if not minus else start0 + insert - read_len
                    gstrand = "-" if minus else "+"
                else:
                    g0 = start0 + insert - read_len if not minus else start0
                    gstrand = "+" if minus else "-"
                t = SimReadTruth(
                    readnum=2 * i + mate - 1,
                    chrom=name_e,
                    start=g0 + 1,
                    end=g0 + read_len,
                    length=read_len,
                    strand=gstrand,
                    subs=nsub,
                )
                names.append(t.descriptor())
                rows.append(rm)
                truths.append(t)
        else:
            start0 = int(rng.integers(0, len(s) - read_len + 1))
            r = s[start0 : start0 + read_len].copy()
            if strand == "both":
                minus = bool(rng.random() < 0.5)
            else:
                minus = strand == "-"
            if minus:
                r = revcomp(r)
            rm, nsub = mutate(r)
            t = SimReadTruth(
                readnum=i,
                chrom=name_e,
                start=start0 + 1,
                end=start0 + read_len,
                length=read_len,
                strand="-" if minus else "+",
                subs=nsub,
            )
            names.append(t.descriptor())
            rows.append(rm)
            truths.append(t)

    codes = np.stack(rows).astype(np.int8)
    return names, codes, truths


def _simulate_se_fast(seqs, n, L, sub_rate, strand, rng, weights,
                      hammings=None):
    """Vectorised SE simulation (no per-read python loop) — required for
    multi-hundred-thousand-read benchmark sets."""
    E = len(seqs)
    ei = rng.choice(E, size=n, p=weights)
    lens = np.array([len(s) for _, s in seqs], np.int64)
    starts0 = (rng.random(n) * np.maximum(lens[ei] - L + 1, 1)).astype(
        np.int64
    )
    # windows from the concatenation
    offs = np.zeros(E + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    cat = np.concatenate([s for _, s in seqs])
    idx = (offs[ei] + starts0)[:, None] + np.arange(L)[None, :]
    reads = cat[idx].astype(np.int8)

    if strand == "both":
        minus = rng.random(n) < 0.5
    else:
        minus = np.full(n, strand == "-")
    if minus.any():
        rc = np.where(reads[minus] >= 4, reads[minus], 3 - reads[minus])
        reads[minus] = rc[:, ::-1]

    nsub = np.zeros(n, np.int64)
    if sub_rate > 0:
        mask = rng.random((n, L)) < sub_rate
        delta = rng.integers(1, 4, size=(n, L))
        reads = np.where(
            mask & (reads < 4), (reads + delta) % 4, reads
        ).astype(np.int8)
        nsub = mask.sum(axis=1)

    abs_start = offs[ei] + starts0
    if hammings is not None:
        hvals = np.asarray(hammings)[np.clip(abs_start, 0,
                                             len(hammings) - 1)]
        hvals = np.where(hvals >= 255, 0, hvals)
    else:
        hvals = np.zeros(n, np.int64)
    names, truths = [], []
    for i in range(n):
        t = SimReadTruth(
            readnum=i, chrom=seqs[ei[i]][0], start=int(starts0[i]) + 1,
            end=int(starts0[i]) + L, length=L,
            strand="-" if minus[i] else "+", subs=int(nsub[i]),
            hamming=int(hvals[i]),
        )
        names.append(t.descriptor())
        truths.append(t)
    return names, reads, truths


def _apply_indels(seqs, reads, truths, indel_rate, indel_size, rng):
    """Per-read simulated InDels (SimReads.cpp SimInDels): with probability
    indel_rate, insert 1..indel_size random bases (read keeps length L,
    genomic span shrinks; truth indels = +size) or delete 1..indel_size
    genomic bases (span grows; truth indels = -size).  Reads are rebuilt
    from the genome in read orientation, so this runs BEFORE induced
    substitutions, matching the reference's order."""
    sd = dict(seqs)
    n, L = reads.shape
    sel = np.nonzero(rng.random(n) < indel_rate)[0]
    for i in sel:
        t = truths[i]
        s = sd[t.chrom]
        g = int(rng.integers(1, indel_size + 1))
        p = int(rng.integers(0, L - g + 1))
        minus = t.strand == "-"
        if rng.integers(0, 2) == 1:
            # insertion of g random bases at read position p
            w = s[t.start - 1 : t.end]
            if minus:
                w = revcomp(w)
            ins = rng.integers(0, 4, size=g).astype(np.int8)
            reads[i] = np.concatenate([w[:p], ins, w[p:]])[:L]
            if minus:
                t.start += g
            else:
                t.end -= g
            t.indels = g
        else:
            # deletion: read skips g genomic bases after read position p
            if minus:
                if t.start - 1 - g < 0:
                    continue
                w = revcomp(s[t.start - 1 - g : t.end])
            else:
                if t.end + g > len(s):
                    continue
                w = s[t.start - 1 : t.end + g]
            reads[i] = np.concatenate([w[:p], w[p + g :]])
            if minus:
                t.start -= g
            else:
                t.end += g
            t.indels = -g


def _simulate_pe_fast(seqs, n_pairs, L, sub_rate, strand, rng, weights,
                      insert_min, insert_max):
    """Vectorised PE simulation (no per-pair python loop).  Returns
    (names, codes (2N, L) int8 interleaved mate1/mate2, truths)."""
    E = len(seqs)
    ei = rng.choice(E, size=n_pairs, p=weights)
    lens = np.array([len(s) for _, s in seqs], np.int64)
    insert = rng.integers(insert_min, insert_max + 1, size=n_pairs)
    insert = np.minimum(insert, lens[ei])
    starts0 = (rng.random(n_pairs) * (lens[ei] - insert + 1)).astype(np.int64)
    offs = np.zeros(E + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    cat = np.concatenate([s for _, s in seqs])
    # window A = fragment 5' L bases; window B = fragment 3' L bases
    a0 = offs[ei] + starts0
    b0 = a0 + insert - L
    win_a = cat[a0[:, None] + np.arange(L)[None, :]].astype(np.int8)
    win_b = cat[b0[:, None] + np.arange(L)[None, :]].astype(np.int8)

    if strand == "both":
        minus = rng.random(n_pairs) < 0.5
    else:
        minus = np.full(n_pairs, strand == "-")

    def rc(rows):
        return np.where(rows >= 4, rows, 3 - rows)[:, ::-1].astype(np.int8)

    # plus fragment: r1 = A (+), r2 = revcomp(B) (-)
    # minus fragment: r1 = revcomp(B) (-), r2 = A (+)
    r1 = np.where(minus[:, None], rc(win_b), win_a)
    r2 = np.where(minus[:, None], win_a, rc(win_b))
    g0_1 = np.where(minus, starts0 + insert - L, starts0)
    g0_2 = np.where(minus, starts0, starts0 + insert - L)
    st_1 = np.where(minus, "-", "+")
    st_2 = np.where(minus, "+", "-")

    reads = np.empty((2 * n_pairs, L), np.int8)
    reads[0::2] = r1
    reads[1::2] = r2
    nsub = np.zeros(2 * n_pairs, np.int64)
    if sub_rate > 0:
        mask = rng.random((2 * n_pairs, L)) < sub_rate
        delta = rng.integers(1, 4, size=(2 * n_pairs, L))
        reads = np.where(mask & (reads < 4), (reads + delta) % 4,
                         reads).astype(np.int8)
        nsub = mask.sum(axis=1)

    names, truths = [], []
    for i in range(n_pairs):
        for mate, (g0, st) in enumerate(((g0_1[i], st_1[i]),
                                         (g0_2[i], st_2[i]))):
            t = SimReadTruth(
                readnum=2 * i + mate, chrom=seqs[ei[i]][0],
                start=int(g0) + 1, end=int(g0) + L, length=L,
                strand=str(st), subs=int(nsub[2 * i + mate]),
            )
            names.append(t.descriptor())
            truths.append(t)
    return names, reads, truths


def random_genome(
    entries: list[tuple[str, int]], seed: int = 7, gc: float = 0.5
) -> list[tuple[str, np.ndarray]]:
    """Pseudorandom genome entries (cf. kangax synthetic-genome benchmark
    mode, biokanga/kangax.cpp:26-29)."""
    rng = np.random.default_rng(seed)
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return [
        (name, rng.choice(4, size=n, p=p).astype(np.int8)) for name, n in entries
    ]
