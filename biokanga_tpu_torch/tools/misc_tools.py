"""Copy of biokanga_tpu/tools/misc_tools.py (host numpy).

Misc standalone-tool parity batch (SURVEY §2.6 core-family tail).

Parity roles:
- quickcount/ (1,502 LoC): N-mer frequency distributions over fasta —
  all-seqs, per-seq, and length-normalised modes (instances/Mbp).
- gensampler/ (717 LoC): sample subsequences from a multifasta,
  optionally restricted to / excluding BED regions.
- ufilter/ (1,657 LoC, IncExclChroms.cpp): include/exclude-chromosome
  row filter over loci files (CSV/BED/SAM).
- loci2dist/ (1,394 LoC): loci length distributions from CSV/BED.
- kangahrdx/ (3,906 LoC, CHomozyReduce): homozygotic-region read
  reduction — collapse reads sampled from identical (homozygous)
  regions down to representative copies.
- KangaRADSeq/ (2,312 LoC): RAD-seq read processing — per-barcode
  demultiplex with restriction-site validation and trimming.
"""
from __future__ import annotations

import csv
import re

import numpy as np

from ..seq.annotations import read_bed
from ..seq.encode import ascii_to_codes
from ..seq.fasta import read_seqs, write_fasta


def _nmer_counts(codes: np.ndarray, k: int) -> np.ndarray:
    if len(codes) < k:
        return np.zeros(4 ** k, np.int64)
    v = np.zeros(len(codes) - k + 1, np.int64)
    good = np.ones(len(v), bool)
    for j in range(k):
        cj = codes[j: len(codes) - k + 1 + j]
        good &= cj < 4
        v = v * 4 + np.clip(cj, 0, 3)
    return np.bincount(v[good], minlength=4 ** k)


def _kmer_str(m: int, k: int) -> str:
    return "".join("ACGT"[(m >> (2 * (k - 1 - j))) & 3] for j in range(k))


def quickcount(inpath: str, outpath: str, kmerlen: int = 4,
               mode: str = "all") -> int:
    """N-mer distribution CSV. mode: all | perseq | norm (per Mbp)."""
    k = kmerlen
    recs = [(r.name, r.codes) for r in read_seqs(inpath)]
    n = 0
    with open(outpath, "w") as out:
        if mode == "perseq":
            out.write('"Seq","KMer","Count"\n')
            for name, codes in recs:
                counts = _nmer_counts(codes, k)
                for m in np.nonzero(counts)[0]:
                    out.write(f'"{name}","{_kmer_str(int(m), k)}",'
                              f"{int(counts[m])}\n")
                    n += 1
        else:
            total = np.zeros(4 ** k, np.int64)
            tot_bases = 0
            for _, codes in recs:
                total += _nmer_counts(codes, k)
                tot_bases += len(codes)
            scale = 1_000_000.0 / max(tot_bases, 1)
            hdr = ('"KMer","PerMbp"' if mode == "norm"
                   else '"KMer","Count"')
            out.write(hdr + "\n")
            for m in range(4 ** k):
                val = (f"{total[m] * scale:.3f}" if mode == "norm"
                       else str(int(total[m])))
                out.write(f'"{_kmer_str(m, k)}",{val}\n')
                n += 1
    return n


def gensampler(inpath: str, outpath: str, n_samples: int, sample_len: int,
               bed_path: str | None = None, exclude: bool = False,
               seed: int = 1) -> int:
    """Sample fixed-length subsequences; optionally keep samples inside
    (or, with exclude=True, outside) BED regions."""
    rng = np.random.default_rng(seed)
    recs = [(r.name, r.codes) for r in read_seqs(inpath)
            if len(r.codes) >= sample_len]
    if not recs:
        raise ValueError("no sequences long enough to sample")
    regions: dict[str, list[tuple[int, int]]] = {}
    if bed_path:
        for ft in read_bed(bed_path):
            regions.setdefault(ft.chrom, []).append((ft.start, ft.end))

    def allowed(name, s, e):
        if not bed_path:
            return True
        inside = any(s >= a and e <= b for a, b in regions.get(name, ()))
        return (not inside) if exclude else inside

    lens = np.array([len(c) for _, c in recs], float)
    probs = lens / lens.sum()
    out_recs = []
    attempts = 0
    while len(out_recs) < n_samples and attempts < n_samples * 50:
        attempts += 1
        i = int(rng.choice(len(recs), p=probs))
        name, codes = recs[i]
        s = int(rng.integers(0, len(codes) - sample_len + 1))
        if allowed(name, s, s + sample_len):
            out_recs.append(
                (f"{name}_{s}_{s + sample_len}", codes[s: s + sample_len]))
    write_fasta(outpath, out_recs)
    return len(out_recs)


def ufilter(inpath: str, outpath: str, include: str | None = None,
            exclude: str | None = None) -> int:
    """Include/exclude-chromosome row filter over CSV/BED/SAM loci files
    (chrom = first CSV column / first BED column / SAM RNAME)."""
    inc = re.compile(include) if include else None
    exc = re.compile(exclude) if exclude else None
    n = 0
    is_csv = inpath.endswith(".csv")
    with open(inpath) as f, open(outpath, "w") as out:
        first = True
        for line in f:
            if line.startswith("@") or line.startswith("#"):
                out.write(line)
                continue
            if is_csv and first:
                out.write(line)
                first = False
                continue
            fl = line.rstrip("\n").split("," if is_csv else "\t")
            chrom = (fl[0].strip('"') if is_csv
                     else (fl[2] if len(fl) > 10 else fl[0]))  # SAM RNAME
            if inc and not inc.search(chrom):
                continue
            if exc and exc.search(chrom):
                continue
            out.write(line)
            n += 1
    return n


def loci2dist(inpath: str, outpath: str, bin_size: int = 10) -> int:
    """Loci length distribution (histogram CSV) from CSV or BED."""
    lengths = []
    if inpath.endswith(".csv"):
        with open(inpath) as f:
            rd = csv.reader(f)
            header = [c.strip('"').lower() for c in next(rd)]
            is_ = header.index("start") if "start" in header else 1
            ie = header.index("end") if "end" in header else 2
            for r in rd:
                if r:
                    lengths.append(int(float(r[ie].strip('"')))
                                   - int(float(r[is_].strip('"'))))
    else:
        for ft in read_bed(inpath):
            lengths.append(ft.end - ft.start)
    if not lengths:
        hist = np.zeros(1, np.int64)
    else:
        a = np.asarray(lengths) // bin_size
        hist = np.bincount(a)
    n = 0
    with open(outpath, "w") as out:
        out.write('"LenFrom","LenTo","Count"\n')
        for b, c in enumerate(hist):
            if c:
                out.write(f"{b * bin_size},{(b + 1) * bin_size - 1},"
                          f"{int(c)}\n")
                n += 1
    return n


def homozy_reduce(reads: list[tuple[str, np.ndarray]],
                  max_copies: int = 2,
                  seed_len: int = 32) -> tuple[list, dict]:
    """kangahrdx role: reduce reads over-sampled from homozygotic regions.

    Reads are grouped by their first `seed_len` bases (both as-is and
    reverse-complemented to a canonical key); groups beyond `max_copies`
    members are truncated to `max_copies` representatives — the
    CHomozyReduce outcome (HomozyReduce.cpp) without the contig pass.
    """
    from ..seq.encode import revcomp

    groups: dict[bytes, int] = {}
    kept = []
    st = {"reads_in": 0, "reads_out": 0, "groups": 0}
    for name, codes in reads:
        st["reads_in"] += 1
        p = codes[:seed_len].tobytes()
        q = revcomp(codes[-seed_len:] if len(codes) >= seed_len
                    else codes).tobytes()
        key = min(p, q)
        c = groups.get(key, 0)
        if c == 0:
            st["groups"] += 1
        if c < max_copies:
            groups[key] = c + 1
            kept.append((name, codes))
            st["reads_out"] += 1
    return kept, st


RADSEQ_SITES = {
    # enzyme: remnant sequence expected at the 5' end after ligation
    "sbfI": "TGCAGG",
    "pstI": "TGCAG",
    "ecoRI": "AATTC",
    "mseI": "TAA",
}


def radseq_demux(reads: list[tuple[str, np.ndarray]],
                 barcodes: dict[str, str],
                 enzyme: str = "sbfI",
                 max_bc_mm: int = 1,
                 trim_barcode: bool = True):
    """KangaRADSeq role: demultiplex RAD reads by inline 5' barcode and
    validate the restriction-site remnant immediately after it.

    Returns ({sample: [(name, codes)]}, stats) — unassigned reads land
    under the '_unassigned' key.
    """
    site = np.asarray(ascii_to_codes(RADSEQ_SITES[enzyme].encode()), np.int8)
    bcs = {s: np.asarray(ascii_to_codes(b.upper().encode()), np.int8)
           for s, b in barcodes.items()}
    out: dict[str, list] = {s: [] for s in barcodes}
    out["_unassigned"] = []
    st = {"reads_in": 0, "assigned": 0, "bad_site": 0, "no_barcode": 0}
    for name, codes in reads:
        st["reads_in"] += 1
        best, best_mm = None, max_bc_mm + 1
        for sample, bc in bcs.items():
            if len(codes) < len(bc) + len(site):
                continue
            mm = int((codes[: len(bc)] != bc).sum())
            if mm < best_mm:
                best, best_mm = sample, mm
        if best is None:
            st["no_barcode"] += 1
            out["_unassigned"].append((name, codes))
            continue
        bl = len(bcs[best])
        if (codes[bl: bl + len(site)] != site).any():
            st["bad_site"] += 1
            out["_unassigned"].append((name, codes))
            continue
        st["assigned"] += 1
        out[best].append((name, codes[bl:] if trim_barcode else codes))
    return out, st
