"""Port of biokanga_tpu/tools/markers.py: the marker discovery family.

- kmarkers  : alignment-free cultivar-unique K-mer markers (capability
  match for `biokanga kmarkers`/`prekmarkers` — CMarkerKMers/CLocKMers,
  biokanga/MarkerKMers.cpp:261 LocKMers prefix-K-mer walk over a
  multi-cultivar suffix array with per-cultivar counts)
- snpmarkers: inter-cultivar SNP markers from per-cultivar SNP CSVs
  (capability match for `biokanga snpmarkers` — CMarkers,
  biokanga/Markers.cpp AddSpecies/LoadSNPFile)
- markerseqs: flanking sequence extraction around marker loci
  (capability match for `biokanga markerseqs` — CMarkerSeq)

Host numpy over the index arrays, as in the JAX package: each distinct
K-mer is a run of the sorted suffix array, and per-cultivar counts are
segmented sums over the entry -> cultivar map.
"""
from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

from ..index.build import GenomeIndex
from ..seq.encode import codes_to_ascii


@dataclass
class KmerMarker:
    kmer: str
    cultivar: str
    count: int
    example_locus: int  # absolute genome offset of one occurrence


def kmer_markers(
    idx: GenomeIndex,
    entry_to_cultivar: list[str],
    K: int = 50,
    min_count: int = 1,
    max_other_count: int = 0,
    max_markers: int = 1_000_000,
) -> list[KmerMarker]:
    """K-mers (K <= 32 exact via index keys) occurring >= min_count times
    in exactly one cultivar and <= max_other_count times in every other.

    entry_to_cultivar maps each index entry to its cultivar name.
    """
    K_eff = min(K, 32)
    cultivars = sorted(set(entry_to_cultivar))
    cult_id = np.array(
        [cultivars.index(c) for c in entry_to_cultivar], dtype=np.int32
    )
    n = idx.total_len

    # truncated keys per SA slot
    if K_eff >= 16:
        hi = idx.key_hi
        lo_bits = 2 * (32 - K_eff)
        lo = (idx.key_lo >> np.uint32(lo_bits)) if K_eff < 32 else idx.key_lo
    else:
        hi = idx.key_hi >> np.uint32(2 * (16 - K_eff))
        lo = np.zeros_like(idx.key_lo)

    # drop suffixes shorter than K or crossing entry boundaries
    pos = idx.pos_sorted.astype(np.int64)
    ent = np.searchsorted(idx.entry_starts, pos, side="right") - 1
    fits = pos + K_eff <= idx.entry_starts[ent + 1]

    boundary = np.ones(n, dtype=bool)
    boundary[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    seg = np.cumsum(boundary) - 1
    n_seg = int(seg[-1]) + 1

    cult_of_pos = cult_id[ent]
    counts = np.zeros((n_seg, len(cultivars)), dtype=np.int64)
    np.add.at(counts, (seg[fits], cult_of_pos[fits]), 1)

    total = counts.sum(axis=1)
    best_c = counts.argmax(axis=1)
    best_cnt = counts[np.arange(n_seg), best_c]
    other = total - best_cnt
    is_marker = (best_cnt >= min_count) & (other <= max_other_count) & (
        total > 0
    )
    # exclude K-mers containing N: N packs as A in keys; verify via genome
    seg_first = np.zeros(n_seg, dtype=np.int64)
    seg_first[seg[::-1]] = np.arange(n - 1, -1, -1)

    out: list[KmerMarker] = []
    marker_segs = np.nonzero(is_marker)[0]
    for s in marker_segs[:max_markers]:
        # representative = first FITTING slot in the segment
        slot = int(seg_first[s])
        while slot < n and seg[slot] == s and not fits[slot]:
            slot += 1
        if slot >= n or seg[slot] != s:
            continue
        p = int(pos[slot])
        kseq = idx.codes[p : p + K_eff]
        if (kseq >= 4).any():
            continue
        out.append(
            KmerMarker(
                kmer=codes_to_ascii(kseq).decode(),
                cultivar=cultivars[int(best_c[s])],
                count=int(best_cnt[s]),
                example_locus=p,
            )
        )
    return out


def write_kmer_markers(path: str, markers: list[KmerMarker],
                       fasta: bool = False) -> None:
    with open(path, "w") as f:
        if fasta:
            for i, m in enumerate(markers, 1):
                f.write(f">KMarker{i} {m.cultivar}|{m.count}\n{m.kmer}\n")
        else:
            f.write('"MarkerID","KMer","Cultivar","Count"\n')
            for i, m in enumerate(markers, 1):
                f.write(f'{i},"{m.kmer}","{m.cultivar}",{m.count}\n')


# ------------------------------------------------------------ snpmarkers --

@dataclass
class SNPMarkerRow:
    chrom: str
    loci: int
    ref_base: str
    alleles: dict  # cultivar -> (base, coverage, nonref)


def load_snp_csv(path: str):
    """Parse our (reference-layout) SNP CSV — align/snp.py writer."""
    rows = []
    with open(path) as f:
        rd = csv.reader(f)
        header = next(rd)
        col = {name: i for i, name in enumerate(header)}
        for r in rd:
            cnts = {
                "A": int(r[col["MMBaseA"]]),
                "C": int(r[col["MMBaseC"]]),
                "G": int(r[col["MMBaseG"]]),
                "T": int(r[col["MMBaseT"]]),
            }
            alt = max(cnts, key=cnts.get)
            rows.append(
                dict(
                    chrom=r[col["Chrom"]].strip('"'),
                    loci=int(r[col["StartLoci"]]),
                    ref=r[col["RefBase"]].strip('"'),
                    alt=alt,
                    bases=int(r[col["Bases"]]),
                    nonref=int(r[col["Mismatches"]]),
                )
            )
    return rows


def snp_markers(
    cultivar_csvs: dict,          # cultivar -> SNP CSV path
    min_cov: int = 5,
    min_cultivars_with_snp: int = 1,
) -> list[SNPMarkerRow]:
    """Inter-cultivar SNP markers: loci where at least one cultivar shows
    a SNP; allele table across cultivars (reference CMarkers semantics:
    species added per SNP file, Markers.cpp:110)."""
    by_locus: dict[tuple, SNPMarkerRow] = {}
    for cult, path in cultivar_csvs.items():
        for r in load_snp_csv(path):
            key = (r["chrom"], r["loci"])
            row = by_locus.get(key)
            if row is None:
                row = SNPMarkerRow(r["chrom"], r["loci"], r["ref"], {})
                by_locus[key] = row
            row.alleles[cult] = (r["alt"], r["bases"], r["nonref"])
    out = []
    for row in by_locus.values():
        good = [
            c for c, (alt, cov, nr) in row.alleles.items() if cov >= min_cov
        ]
        if len(good) >= min_cultivars_with_snp:
            out.append(row)
    out.sort(key=lambda r: (r.chrom, r.loci))
    return out


def write_snp_markers(path: str, markers: list[SNPMarkerRow],
                      cultivars: list[str]) -> None:
    with open(path, "w") as f:
        cols = ['"Chrom"', '"Loci"', '"RefBase"']
        for c in cultivars:
            cols += [f'"{c}:Base"', f'"{c}:Cov"', f'"{c}:NonRef"']
        f.write(",".join(cols) + "\n")
        for m in markers:
            row = [f'"{m.chrom}"', str(m.loci), f'"{m.ref_base}"']
            for c in cultivars:
                alt, cov, nr = m.alleles.get(c, ("-", 0, 0))
                row += [f'"{alt}"', str(cov), str(nr)]
            f.write(",".join(row) + "\n")


# ------------------------------------------------------------ markerseqs --

def marker_seqs(
    idx: GenomeIndex,
    markers: list[SNPMarkerRow],
    flank5: int = 100,
    flank3: int = 100,
) -> list[tuple[str, np.ndarray]]:
    """Extract flanking sequence around each marker SNP (CMarkerSeq role).
    Skips markers whose flanks leave the chromosome (the reference does
    the same containment check, Aligner.cpp:7020-7024)."""
    name_to_e = {n: i for i, n in enumerate(idx.entry_names)}
    out = []
    for i, m in enumerate(markers, 1):
        e = name_to_e.get(m.chrom)
        if e is None:
            continue
        a = int(idx.entry_starts[e])
        b = int(idx.entry_starts[e + 1])
        lo = a + m.loci - flank5
        hi = a + m.loci + flank3 + 1
        if lo < a or hi > b:
            continue
        seq = idx.codes[lo:hi]
        out.append((f"Marker{i}|{m.chrom}|{m.loci}|{flank5}", seq))
    return out
