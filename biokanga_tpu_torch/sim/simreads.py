"""Copy of biokanga_tpu/sim/simreads.py: random genomes, SE and PE reads.

Reads carry their origin in the reference descriptor format, so an
alignment is checked by parsing its read name:

  lcl|usimreads|<readnum>|<chrom>|<start>|<end>|<len>|<strand>|<hamming>|<subs>|<indel>

(format: biokanga/SimReads.cpp:3054-3056; start/end are 1-based
inclusive.)  Only the vectorised single-end and paired-end paths without
indels or error profiles are copied; for those arguments the reads, names
and truths equal the JAX package's for the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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


def simulate_reads(
    seqs: list[tuple[str, np.ndarray]],
    num_reads: int,
    read_len: int = 100,
    sub_rate: float = 0.0,
    strand: str = "both",
    seed: int = 1,
    pe: bool = False,
    insert_min: int = 200,
    insert_max: int = 500,
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
    if pe:
        return _simulate_pe_fast(seqs, num_reads, read_len, sub_rate, strand,
                                 rng, weights, insert_min, insert_max)
    return _simulate_se_fast(seqs, num_reads, read_len, sub_rate, strand,
                             rng, weights)


def _simulate_se_fast(seqs, n, L, sub_rate, strand, rng, weights):
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

    names, truths = [], []
    for i in range(n):
        t = SimReadTruth(
            readnum=i, chrom=seqs[ei[i]][0], start=int(starts0[i]) + 1,
            end=int(starts0[i]) + L, length=L,
            strand="-" if minus[i] else "+", subs=int(nsub[i]),
        )
        names.append(t.descriptor())
        truths.append(t)
    return names, reads, truths


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
