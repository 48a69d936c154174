"""A TruSeq-style paired-end library for the read-preparation tools
(`filter`, `ngsqc`) with planted artefacts, and the shares that tell how
well a filter run removed them (numpy and the port's numpy-only base
codes, no jax: chip_smoke.py imports it too).

Pairs of 2 x READ_LEN bases from a genome, inserts 200-500, 1%
substitutions over every base, and among them:

- ADAPTER_SHARE of pairs whose insert is shorter than a read: each mate
  reads 20-60 bases into its 3' adapter (TruSeq read 1 and read 2
  adapters, each with its index);
- VECTOR_SHARE of pairs drawn wholly from a seeded cloning vector
  (VECTOR_LEN bases), from either strand;
- DUP_SHARE exact copies of an earlier genome pair, and NEAR_DUP_SHARE
  copies with one or two further substitutions.

The contaminant FASTA follows the naming convention of
Contaminants.load: each adapter as a 3' flank entry of its mate (`@3`
read 1, `@4` read 2) and the vector as a `&1256` entry (both mates,
both strands).
"""
import numpy as np

from biokanga_tpu_torch.seq.encode import ascii_to_codes, revcomp

READ_LEN = 100
INSERT = (200, 500)
SUB_RATE = 0.01
ADAPTER_SHARE, VECTOR_SHARE = 0.03, 0.01
DUP_SHARE, NEAR_DUP_SHARE = 0.05, 0.01
READ_THROUGH = (20, 60)
VECTOR_LEN = 6_000
# TruSeq adapters as read 1 and read 2 read into them: the adapter, an
# index, then the flow-cell end
ADAPTER_R1 = (b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC" b"ATCACG"
              b"ATCTCGTATGCCGTCTTCTGCTTG")
ADAPTER_R2 = (b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT" b"AGGCTATA"
              b"GTGTAGATCTCGGTGGTCGCCGTATCATT")
# the filter's bars for these shares: what the JAX package's `filter`
# reaches on this library (tests/test_torch_readprep.py holds it there)
MIN_VECTOR_REJECTED = 0.99
MIN_ADAPTER_TRIMMED = 0.95


def contaminant_entries(seed: int):
    """[(name, codes)] of the contaminant FASTA: the two adapters and the
    seeded vector."""
    vec = np.random.default_rng(seed).integers(0, 4, VECTOR_LEN)
    return [("TruSeq_R1@3", ascii_to_codes(ADAPTER_R1)),
            ("TruSeq_R2@4", ascii_to_codes(ADAPTER_R2)),
            ("cloning_vector&1256", vec.astype(np.int8))]


def library(genome: np.ndarray, n_pairs: int, seed: int):
    """(names, r1, r2, lengths) for n_pairs pairs; r1 and r2 are (n, L)
    int8, every read READ_LEN long.  A name carries its kind after the
    last '_': n (genome pair), a<t> (adapter read-through of t bases),
    v (vector), d (exact duplicate), e (near duplicate)."""
    rng = np.random.default_rng(seed)
    L = READ_LEN
    vec = contaminant_entries(seed)[2][1]
    ad1 = ascii_to_codes(ADAPTER_R1)
    ad2 = ascii_to_codes(ADAPTER_R2)
    edges = np.cumsum([ADAPTER_SHARE, VECTOR_SHARE, DUP_SHARE,
                       NEAR_DUP_SHARE])
    # 0 adapter, 1 vector, 2 duplicate, 3 near duplicate, 4 genome pair
    kind = np.searchsorted(edges, rng.random(n_pairs), side="right")
    kind[0] = 4                                   # a pair to copy
    r1 = np.empty((n_pairs, L), np.int8)
    r2 = np.empty((n_pairs, L), np.int8)
    tags = np.array(["a", "v", "d", "e", "n"], object)[kind]

    # genome and vector pairs: A = the fragment's first L bases, B = the
    # reverse complement of its last L; a flipped fragment swaps them
    for k, src in ((4, genome), (1, vec)):
        rows = np.nonzero(kind == k)[0]
        ins = rng.integers(INSERT[0], INSERT[1] + 1, len(rows))
        s = (rng.random(len(rows)) * (len(src) - ins)).astype(np.int64)
        col = np.arange(L)
        a = src[s[:, None] + col]
        b = src[(s + ins - L)[:, None] + col][:, ::-1]
        b = np.where(b >= 4, b, 3 - b)
        flip = rng.random(len(rows)) < 0.5
        r1[rows] = np.where(flip[:, None], b, a)
        r2[rows] = np.where(flip[:, None], a, b)
    # adapter pairs: an insert of L - t bases, then t adapter bases
    for i in np.nonzero(kind == 0)[0]:
        t = int(rng.integers(READ_THROUGH[0], READ_THROUGH[1] + 1))
        s = int(rng.integers(0, len(genome) - (L - t)))
        frag = genome[s:s + L - t]
        if rng.random() < 0.5:
            frag = revcomp(frag)
        r1[i] = np.concatenate([frag, ad1[:t]])
        r2[i] = np.concatenate([revcomp(frag), ad2[:t]])
        tags[i] = f"a{t}"
    # sequencing substitutions, then the copies of earlier genome pairs
    made = (kind <= 1) | (kind == 4)
    for m in (r1, r2):
        hit = (rng.random((n_pairs, L)) < SUB_RATE) & made[:, None]
        m[hit] = (m[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    src_rows = np.nonzero(kind == 4)[0]
    dups = np.nonzero((kind == 2) | (kind == 3))[0]
    before = np.searchsorted(src_rows, dups)
    j = src_rows[(rng.random(len(dups)) * before).astype(np.int64)]
    r1[dups], r2[dups] = r1[j], r2[j]
    for i in np.nonzero(kind == 3)[0]:
        for _ in range(int(rng.integers(1, 3))):
            m = (r1, r2)[int(rng.integers(0, 2))]
            p = int(rng.integers(0, L))
            m[i, p] = (m[i, p] + int(rng.integers(1, 4))) % 4
    names = [f"rp{i:07d}_{t}" for i, t in enumerate(tags)]
    return names, r1, r2, np.full(n_pairs, L, np.int32)


def planted_shares(names, out1_records, min_len: int = 50) -> dict:
    """The shares a filter run reached on `library`'s pairs, from the
    (name, length) records of its read-1 output: vector pairs rejected;
    adapter reads trimmed to their insert (or, where the insert is
    shorter than min_len, rejected); and the counts of each kind."""
    out = dict(out1_records)
    n_vec = n_ad = vec_gone = ad_ok = 0
    counts = {}
    for nm in names:
        tag = nm.rsplit("_", 1)[1]
        counts[tag[0]] = counts.get(tag[0], 0) + 1
        if tag == "v":
            n_vec += 1
            vec_gone += nm not in out
        elif tag[0] == "a":
            n_ad += 1
            ins = READ_LEN - int(tag[1:])
            ad_ok += (nm not in out) if ins < min_len else (
                out.get(nm) == ins)
    return {"vector_rejected": vec_gone / max(n_vec, 1),
            "adapter_trimmed": ad_ok / max(n_ad, 1),
            "n_vector": n_vec, "n_adapter": n_ad, "kinds": counts}


def fastq_name_lengths(path) -> list[tuple[str, int]]:
    """(name, sequence length) of every record of a FASTQ."""
    out = []
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        out.append((lines[i][1:].decode(), len(lines[i + 1])))
    return out
