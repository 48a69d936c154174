"""Copy of biokanga_tpu/tools/conservation.py (host numpy).

Comparative-genomics / conservation tool family over .algn
multialignment containers.

Parity surface (SURVEY.md §2.6 "Comparative-genomics / conservation"):
- genhyperconserved / genultras: ultra- and hyper-conserved element
  discovery with the reference's random-walk identity model
  (genhyperconserved.cpp:26,2106-2112 cRandWalk100Score=10000,
  MismatchScore=(10000-1)/(100-MinIdentity), MatchScore=10000/MinIdentity;
  core walk ProcessSubSeq :2300-2470; row format OutputHypercore :2599+)
- genhyperdropouts: set ops between two hyper-element CSVs
  (genhyperdropouts.cpp:196 modes Dropouts/Intersect/RefUnique/Combined)
- genalignstats / genalignconf: per-species identity and per-block
  confidence distributions from .algn
- genalignref2relloci / genalignloci2core: project reference loci
  through the alignment onto relative species (genalignref2relloci.cpp:
  190-194 '#' species placeholder) / per-locus match profiles
  (genalignloci2core.cpp:438-455)
- Loci2Phylip: loci sub-alignments as PHYLIP (Loci2Phylip.cpp:360-365,
  mode 0 concatenated / 1 per-locus files with '#' RefID placeholder)
- genrollups: roll up hyper-element CSVs into totals / per-length-range
  summaries (genrollups.cpp:154-156)
- genelementseq / genloci2gene / genseqcandidates / genElementProfiles /
  processcsvfiles: element sequence extraction, loci->gene region
  classification, candidate filtering, element identity profiles, CSV
  set utilities

Alignment columns are processed as stacked int8 code matrices (rows =
species, cols = alignment columns); column agreement is one vectorised
reduction per block — the per-column species loop in the reference
becomes `(rows == ref).all(axis=0)`.
"""
from __future__ import annotations

import glob as _glob
import numpy as np

from .converters3 import load_biomultialign

RANDWALK_100 = 10000  # cRandWalk100Score (genhyperconserved.cpp:26)
GAP = 5               # '-' code in the .algn container alphabet
NCODE = 4

_LUT = np.full(256, NCODE, dtype=np.int8)
for _i, _c in enumerate("ACGTN-"):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i


def _split_src(src: str) -> tuple[str, str]:
    """MAF 'species.chrom' -> (species, chrom)."""
    if "." in src:
        sp, chrom = src.split(".", 1)
        return sp, chrom
    return src, src


def _block_matrix(rows):
    """Block rows -> (species list, chrom-of-row, starts, code matrix)."""
    species, chroms, starts = [], [], []
    mats = []
    for src, start, _size, _strand, _ssize, text in rows:
        sp, chrom = _split_src(src)
        species.append(sp)
        chroms.append(chrom)
        starts.append(start)
        mats.append(_LUT[np.frombuffer(text.encode(), dtype=np.uint8)])
    return species, chroms, np.asarray(starts), np.vstack(mats)


def _iter_blocks(algn_path: str):
    _, blocks = load_biomultialign(algn_path)
    for rows in blocks:
        if rows:
            yield _block_matrix(rows)


# ------------------------------------------------------- hypercore walk ---

def _hypercore_walk(col_mismatch: np.ndarray, ref_indel: np.ndarray,
                    min_ident: int, min_ultra_len: int, min_hyper_len: int,
                    max_mismatches: int):
    """The ProcessSubSeq random walk (genhyperconserved.cpp:2300-2470).

    col_mismatch[i]: column i is a hyperconserved mismatch; ref_indel[i]:
    the ref base is an InDel (doesn't extend the ref-coordinate length).
    Yields (start_col, end_col, ref_len) accepted elements.
    """
    if min_ident >= 100:
        mm_score, match_score = 0, 0
    else:
        mm_score = (RANDWALK_100 - 1) // (100 - min_ident)
        match_score = RANDWALK_100 // min_ident
    n = col_mismatch.size
    out = []
    seq_idx = 0
    while seq_idx < n:
        score = RANDWALK_100
        cur_ultra = max_ultra = 0
        ref_len = 0
        tot_mm = 0
        nxt = -1
        i = seq_idx
        while i < n:
            if col_mismatch[i]:
                cur_ultra = 0
                if mm_score:
                    score -= mm_score
                    if score <= 0:
                        break
                if nxt == -1:
                    nxt = i + 1
                tot_mm += 1
                if tot_mm > max_mismatches:
                    break
            else:
                cur_ultra += 1
                max_ultra = max(max_ultra, cur_ultra)
                if min_ultra_len and cur_ultra >= min_ultra_len:
                    score = RANDWALK_100
                else:
                    score = min(RANDWALK_100, score + match_score)
            if not ref_indel[i]:
                ref_len += 1
            i += 1
        if i >= n:
            nxt = -1
        if (max_ultra >= min_ultra_len and ref_len >= min_hyper_len):
            out.append((seq_idx, i, ref_len))
            seq_idx = i + 1
        elif nxt == -1:
            break
        else:
            seq_idx = nxt
    return out


def gen_hyperconserved(algn_path: str, outpath: str,
                       cores_path: str | None = None,
                       ref_species: str | None = None,
                       species: list[str] | None = None,
                       min_ident: int = 90, min_ultra_len: int = 50,
                       min_hyper_len: int = 0, max_mismatches: int = 100,
                       indels_as_mismatches: bool = False,
                       slough_ref_indels: bool = False) -> int:
    """Ultra/hyper-conserved element discovery.

    min_hyper_len == 0 => ultra mode (min_ident forced to 100), mirroring
    the reference default where MinHyperLen defaults to MinUltraLen and
    100% identity "is an ultra" (genhyperconserved.cpp:2111).
    Emits element rows (cores_path) in the OutputHypercore CSV shape:
    id,"ultracore|hypercore","refspecies","chrom",start,end,len,
    "specieslist",featbits — and a LenRange distribution summary
    (outpath).
    """
    hyper = min_hyper_len > 0
    if not hyper:
        min_ident = 100
        min_hyper_len = min_ultra_len
        max_mismatches = 0  # an ultra ends at its first mismatch
    elements = []
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        if species:
            keep = [i for i, s in enumerate(sp_list) if s in species]
            if len(keep) < len(species):
                continue  # block lacks a core species
            sp_list = [sp_list[i] for i in keep]
            chroms = [chroms[i] for i in keep]
            starts = starts[keep]
            mat = mat[keep]
        if mat.shape[0] < 2:
            continue
        ridx = 0
        if ref_species and ref_species in sp_list:
            ridx = sp_list.index(ref_species)
        ref = mat[ridx]
        others = np.delete(mat, ridx, axis=0)
        bad = (others != ref[None, :]) | (others >= NCODE)
        col_mm = bad.any(axis=0) | (ref >= NCODE)
        ref_indel = ref == GAP
        if slough_ref_indels:
            keep_cols = ~ref_indel
            col_mm = col_mm[keep_cols]
            ref_indel = np.zeros(col_mm.size, dtype=bool)
            col_off = np.flatnonzero(keep_cols)
        else:
            col_off = np.arange(ref.size)
        # ref-coordinate offset of each column
        ref_pos = starts[ridx] + np.cumsum(~(ref == GAP)) - 1
        for s_col, e_col, ref_len in _hypercore_walk(
                col_mm, ref_indel, min_ident, min_ultra_len,
                min_hyper_len, max_mismatches):
            cs = int(ref_pos[col_off[s_col]])
            elements.append((sp_list[ridx], chroms[ridx], cs,
                             cs + ref_len - 1, ref_len))
    kind = "hypercore" if hyper else "ultracore"
    splist = ",".join(species) if species else "all"
    if cores_path:
        with open(cores_path, "w") as f:
            for i, (rsp, chrom, s, e, ln) in enumerate(elements, 1):
                f.write(f'{i},"{kind}","{rsp}","{chrom}",{s},{e},{ln},'
                        f'"{splist}",0\n')
    # LenRange distribution summary
    bins = [(0, 24), (25, 49), (50, 74), (75, 99), (100, 149), (150, 199),
            (200, 299), (300, 499), (500, 999), (1000, 1 << 30)]
    hist = [0] * len(bins)
    for *_ignore, ln in elements:
        for bi, (lo, hi) in enumerate(bins):
            if lo <= ln <= hi:
                hist[bi] += 1
                break
    with open(outpath, "w") as f:
        f.write('"LenRange","Mismatches","TotInstances"\n')
        for (lo, hi), cnt in zip(bins, hist):
            rng = f"{lo}-{hi}" if hi < (1 << 30) else f"{lo}+"
            f.write(f'"{rng}",{max_mismatches if hyper else 0},{cnt}\n')
    return len(elements)


def gen_ultras(algn_path: str, outpath: str, cores_path: str | None = None,
               ref_species: str | None = None,
               species: list[str] | None = None,
               min_ultra_len: int = 50) -> int:
    """genultras: 100%-identity elements (ultra mode of the walk)."""
    return gen_hyperconserved(algn_path, outpath, cores_path, ref_species,
                              species, min_ident=100,
                              min_ultra_len=min_ultra_len)


# ------------------------------------------------- stats and confidence ---

def gen_align_stats(algn_path: str, outpath: str) -> int:
    """Per relative-species alignment stats vs the block reference (row
    0): aligned columns, matches, mismatches, indels, identity%
    (genalignstats.cpp role)."""
    agg: dict[str, np.ndarray] = {}
    for sp_list, _chroms, _starts, mat in _iter_blocks(algn_path):
        ref = mat[0]
        for i in range(1, mat.shape[0]):
            row = mat[i]
            both = (ref < NCODE) & (row < NCODE)
            m = agg.setdefault(sp_list[i], np.zeros(4, dtype=np.int64))
            m[0] += int(both.sum())
            m[1] += int(((ref == row) & both).sum())
            m[2] += int(((ref != row) & both).sum())
            m[3] += int(((ref == GAP) ^ (row == GAP)).sum())
    with open(outpath, "w") as f:
        f.write('"Species","Aligned","Matches","Mismatches","InDels",'
                '"Identity"\n')
        for sp in sorted(agg):
            a, m, mm, ind = agg[sp].tolist()
            ident = m / a if a else 0.0
            f.write(f'"{sp}",{a},{m},{mm},{ind},{ident:.6f}\n')
    return len(agg)


def gen_align_conf(algn_path: str, outpath: str, mode: int = 0) -> int:
    """Per-block alignment confidence (genalignconf.cpp modes 0-2):
    block score, columns, fraction of all-species-identical columns."""
    rows = []
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        if mat.shape[0] < 2:
            continue
        ref = mat[0]
        ident_cols = ((mat == ref[None, :]) | (mat >= NCODE)).all(axis=0)
        valid = (mat < NCODE).all(axis=0)
        conf = (ident_cols & valid).sum() / max(int(valid.sum()), 1)
        rows.append((chroms[0], int(starts[0]), mat.shape[1],
                     mat.shape[0], float(conf)))
    with open(outpath, "w") as f:
        if mode == 2:  # summary
            mean = np.mean([r[4] for r in rows]) if rows else 0.0
            f.write('"NumBlocks","MeanConfidence"\n')
            f.write(f"{len(rows)},{mean:.6f}\n")
        else:
            f.write('"Chrom","Start","Cols","Species","Confidence"\n')
            for r in rows:
                f.write(f'"{r[0]}",{r[1]},{r[2]},{r[3]},{r[4]:.6f}\n')
    return len(rows)


# ------------------------------------------------------- loci projection ---

def _read_loci_csv(path: str):
    """Loci rows (chrom, start, end) from hypercore CSV / generic CSV /
    BED. Hypercore rows put chrom at field 3 (quoted), start 4, end 5."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("track", "#")):
                continue
            sep = "\t" if "\t" in line else ","
            fl = [p.strip().strip('"') for p in line.split(sep)]
            try:
                out.append((fl[0], int(fl[1]), int(fl[2])))
                continue
            except (ValueError, IndexError):
                pass
            try:
                out.append((fl[3], int(fl[4]), int(fl[5])))
            except (ValueError, IndexError):
                continue
    return out


def _ref_projection(starts, mat, ridx):
    """Per-column ref coordinate (or -1 on ref InDel columns)."""
    ref = mat[ridx]
    pos = starts[ridx] + np.cumsum(ref != GAP) - 1
    return np.where(ref != GAP, pos, -1)


def gen_align_ref2relloci(loci_path: str, algn_path: str, outpath: str,
                          ref_species: str | None = None) -> int:
    """Project reference-species loci through the alignment onto every
    relative species (genalignref2relloci.cpp): CSV rows
    "refchrom",refstart,refend,"species","relchrom",relstart,relend.
    A '#' in outpath is replaced by the species name, producing one
    file per species like the reference's placeholder contract."""
    loci = _read_loci_csv(loci_path)
    per_species: dict[str, list] = {}
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        ridx = (sp_list.index(ref_species)
                if ref_species and ref_species in sp_list else 0)
        refpos = _ref_projection(starts, mat, ridx)
        lo = int(refpos[refpos >= 0].min()) if (refpos >= 0).any() else 0
        hi = int(refpos.max())
        for chrom, s, e in loci:
            if chrom != chroms[ridx] or e < lo or s > hi:
                continue
            cols = np.flatnonzero((refpos >= s) & (refpos <= e))
            if cols.size == 0:
                continue
            for i in range(mat.shape[0]):
                if i == ridx:
                    continue
                rp = _ref_projection(starts, mat, i)
                rel = rp[cols]
                rel = rel[rel >= 0]
                if rel.size == 0:
                    continue
                per_species.setdefault(sp_list[i], []).append(
                    (chrom, s, e, chroms[i], int(rel.min()),
                     int(rel.max())))
    n = 0
    if "#" in outpath:
        for sp, rows in per_species.items():
            with open(outpath.replace("#", sp), "w") as f:
                for chrom, s, e, rc, rs, re_ in rows:
                    f.write(f'"{chrom}",{s},{e},"{sp}","{rc}",{rs},{re_}\n')
                    n += 1
    else:
        with open(outpath, "w") as f:
            for sp in sorted(per_species):
                for chrom, s, e, rc, rs, re_ in per_species[sp]:
                    f.write(f'"{chrom}",{s},{e},"{sp}","{rc}",{rs},{re_}\n')
                    n += 1
    return n


def gen_align_loci2core(loci_path: str, algn_path: str, outpath: str,
                        dist_segs: int = 10) -> int:
    """Per-locus per-species match profile (genalignloci2core.cpp):
    matches/mismatches/indels/unaligned counts over each locus, plus a
    dist_segs-segment match distribution."""
    loci = _read_loci_csv(loci_path)
    results = {i: {} for i in range(len(loci))}
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        refpos = _ref_projection(starts, mat, 0)
        ref = mat[0]
        for li, (chrom, s, e) in enumerate(loci):
            if chrom != chroms[0]:
                continue
            cols = np.flatnonzero((refpos >= s) & (refpos <= e))
            if cols.size == 0:
                continue
            for i in range(1, mat.shape[0]):
                row = mat[i][cols]
                rc = ref[cols]
                m = results[li].setdefault(
                    sp_list[i], np.zeros(4 + dist_segs, dtype=np.int64))
                match = (row == rc) & (rc < NCODE)
                m[0] += int(match.sum())
                m[1] += int(((row != rc) & (row < NCODE)
                             & (rc < NCODE)).sum())
                m[2] += int(((row == GAP) | (rc == GAP)).sum())
                m[3] += int((row == NCODE).sum())
                seg = np.minimum((np.arange(cols.size) * dist_segs)
                                 // max(cols.size, 1), dist_segs - 1)
                m[4:] += np.bincount(seg[match], minlength=dist_segs)
    n = 0
    with open(outpath, "w") as f:
        f.write('"LocusID","Chrom","Start","End","Species","Matches",'
                '"Mismatches","InDels","Unaligned",' +
                ",".join(f'"Seg{i + 1}"' for i in range(dist_segs)) + "\n")
        for li, (chrom, s, e) in enumerate(loci):
            for sp, m in sorted(results[li].items()):
                f.write(f'{li + 1},"{chrom}",{s},{e},"{sp}",' +
                        ",".join(str(int(v)) for v in m) + "\n")
                n += 1
    return n


def loci2phylip(loci_path: str, algn_path: str, outpath: str,
                mode: int = 0) -> int:
    """Loci sub-alignments -> PHYLIP (Loci2Phylip.cpp): mode 0 writes
    one concatenated sequential-PHYLIP block per locus into a single
    file; mode 1 writes one file per locus (outpath '#' replaced by the
    locus id)."""
    alpha = "ACGTN-"
    loci = _read_loci_csv(loci_path)
    per_locus: dict[int, dict[str, str]] = {}
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        refpos = _ref_projection(starts, mat, 0)
        for li, (chrom, s, e) in enumerate(loci):
            if chrom != chroms[0]:
                continue
            cols = np.flatnonzero((refpos >= s) & (refpos <= e))
            if cols.size == 0:
                continue
            d = per_locus.setdefault(li, {})
            for i in range(mat.shape[0]):
                seq = "".join(alpha[c] for c in mat[i][cols])
                d[sp_list[i]] = d.get(sp_list[i], "") + seq
    n = 0

    def _write(f, d):
        width = len(next(iter(d.values())))
        f.write(f" {len(d)} {width}\n")
        for sp, seq in d.items():
            f.write(f"{sp[:10]:<10}{seq}\n")

    if mode == 1:
        for li, d in per_locus.items():
            with open(outpath.replace("#", str(li + 1)), "w") as f:
                _write(f, d)
                n += 1
    else:
        with open(outpath, "w") as f:
            for li in sorted(per_locus):
                _write(f, per_locus[li])
                n += 1
    return n


# ------------------------------------------------------------- set ops ---

def gen_hyperdropouts(ref_path: str, rel_path: str, outpath: str,
                      mode: int = 0) -> int:
    """Set operations between two hyper-element CSVs
    (genhyperdropouts.cpp modes): 0 Dropouts (ref elements with no
    overlapping rel element), 1 Intersect, 2 RefUnique (== dropouts but
    keyed on exact span), 3 Combined (union)."""
    ref = _read_loci_csv(ref_path)
    rel = _read_loci_csv(rel_path)
    by_chrom: dict[str, list] = {}
    for chrom, s, e in rel:
        by_chrom.setdefault(chrom, []).append((s, e))
    for v in by_chrom.values():
        v.sort()

    def overlaps(chrom, s, e):
        for rs, re_ in by_chrom.get(chrom, []):
            if rs > e:
                break
            if re_ >= s:
                return True
        return False

    if mode == 0 or mode == 2:
        out = [r for r in ref if not overlaps(*r)]
        kind = "dropout"
    elif mode == 1:
        out = [r for r in ref if overlaps(*r)]
        kind = "intersect"
    else:
        out = sorted(set(ref) | set(rel))
        kind = "combined"
    with open(outpath, "w") as f:
        for i, (chrom, s, e) in enumerate(out, 1):
            f.write(f'{i},"{kind}","{chrom}",{s},{e},{e - s + 1}\n')
    return len(out)


def gen_rollups(inpaths: str | list[str], outpath: str,
                mode: int = 0) -> int:
    """Roll up hyper-element CSVs (genrollups.cpp modes 0/2): per input
    file totals of element counts and covered bases, plus per-length
    -range breakdowns."""
    paths = (sorted(_glob.glob(inpaths)) if isinstance(inpaths, str)
             else list(inpaths))
    bins = [(0, 49), (50, 99), (100, 199), (200, 499), (500, 1 << 30)]
    n = 0
    with open(outpath, "w") as f:
        f.write('"File","NumElements","TotalBases",' +
                ",".join(f'"Len{lo}-{hi}"' if hi < (1 << 30)
                         else f'"Len{lo}+"' for lo, hi in bins) + "\n")
        for path in paths:
            loci = _read_loci_csv(path)
            hist = [0] * len(bins)
            tot_bases = 0
            for _c, s, e in loci:
                ln = e - s + 1
                tot_bases += ln
                for bi, (lo, hi) in enumerate(bins):
                    if lo <= ln <= hi:
                        hist[bi] += 1
                        break
            f.write(f'"{path}",{len(loci)},{tot_bases},' +
                    ",".join(map(str, hist)) + "\n")
            n += 1
    return n


# ------------------------------------------------------ element helpers ---

def gen_element_seq(loci_path: str, genome_path: str, out_fasta: str,
                    flank: int = 0) -> int:
    """Extract element sequences +/- flank from a genome fasta
    (genelementseq.cpp role)."""
    from ..seq.encode import codes_to_ascii
    from ..seq.fasta import read_seqs

    genome = {r.name: r.codes for r in read_seqs(genome_path)}
    n = 0
    with open(out_fasta, "w") as f:
        for chrom, s, e in _read_loci_csv(loci_path):
            codes = genome.get(chrom)
            if codes is None:
                continue
            lo = max(0, s - flank)
            hi = min(codes.size, e + 1 + flank)
            n += 1
            f.write(f">el{n} {chrom}:{lo}-{hi}\n")
            f.write(codes_to_ascii(codes[lo:hi]).decode() + "\n")
    return n


_REGION_NAMES = ["IG", "US", "UTR5", "CDS", "Intron", "UTR3", "DS"]


def classify_region(chrom: str, start: int, end: int, features,
                    updnstream: int = 2000) -> str:
    """Classify a locus against BED features into the reference's 7
    functional regions (teFuncRegion; Centroid.h / genloci2gene role)."""
    best = "IG"
    order = {r: i for i, r in enumerate(_REGION_NAMES)}
    for ft in features:
        if ft.chrom != chrom:
            continue
        if start <= ft.end and end >= ft.start:
            exons = (list(zip(ft.exon_starts, ft.exon_sizes))
                     if getattr(ft, "exon_sizes", None) else None)
            if exons:
                in_exon = any(
                    start <= ft.start + es + sz - 1 and end >= ft.start + es
                    for es, sz in exons)
                reg = "CDS" if in_exon else "Intron"
            else:
                reg = "CDS"
        elif (ft.strand == "+" and ft.start - updnstream <= end < ft.start) \
                or (ft.strand == "-" and ft.end < start <= ft.end
                    + updnstream):
            reg = "US"
        elif (ft.strand == "+" and ft.end < start <= ft.end + updnstream) \
                or (ft.strand == "-" and ft.start - updnstream <= end
                    < ft.start):
            reg = "DS"
        else:
            continue
        if order[reg] > order[best]:
            best = reg
    return best


def gen_loci2gene(loci_path: str, bed_path: str, outpath: str,
                  updnstream: int = 2000) -> int:
    """Associate loci with their nearest feature + functional region
    (genloci2gene.cpp role): CSV rows locus, nearest gene, distance,
    region class."""
    from ..seq.annotations import read_bed

    feats = read_bed(bed_path)
    n = 0
    with open(outpath, "w") as f:
        f.write('"Chrom","Start","End","Gene","Distance","Region"\n')
        for chrom, s, e in _read_loci_csv(loci_path):
            best, bestd = "", None
            for ft in feats:
                if ft.chrom != chrom:
                    continue
                d = max(ft.start - e, s - ft.end, 0)
                if bestd is None or d < bestd:
                    best, bestd = ft.name, d
            reg = classify_region(chrom, s, e, feats, updnstream)
            f.write(f'"{chrom}",{s},{e},"{best}",'
                    f"{bestd if bestd is not None else -1},\"{reg}\"\n")
            n += 1
    return n


def gen_seq_candidates(fasta_path: str, outpath: str, min_len: int = 50,
                       max_len: int = 1 << 30, max_n_pct: float = 5.0,
                       min_gc: float = 0.0, max_gc: float = 100.0) -> int:
    """Filter candidate element sequences by length / N% / GC%
    (genseqcandidates.cpp role)."""
    from ..seq.encode import codes_to_ascii
    from ..seq.fasta import read_seqs

    n = 0
    with open(outpath, "w") as f:
        for rec in read_seqs(fasta_path):
            ln = rec.codes.size
            if not (min_len <= ln <= max_len):
                continue
            npct = 100.0 * (rec.codes >= NCODE).sum() / ln
            if npct > max_n_pct:
                continue
            gc = 100.0 * np.isin(rec.codes, (1, 2)).sum() / ln
            if not (min_gc <= gc <= max_gc):
                continue
            n += 1
            f.write(f">{rec.name}\n{codes_to_ascii(rec.codes).decode()}\n")
    return n


def gen_element_profiles(loci_path: str, algn_path: str, outpath: str,
                         segs: int = 10) -> int:
    """Per-element cross-species identity profile in `segs` equal
    segments (genElementProfiles.cpp role)."""
    loci = _read_loci_csv(loci_path)
    prof = {i: np.zeros((2, segs), dtype=np.int64) for i in range(len(loci))}
    for sp_list, chroms, starts, mat in _iter_blocks(algn_path):
        if mat.shape[0] < 2:
            continue
        refpos = _ref_projection(starts, mat, 0)
        ref = mat[0]
        ident = ((mat == ref[None, :]) | (mat >= NCODE)).all(axis=0) \
            & (ref < NCODE)
        for li, (chrom, s, e) in enumerate(loci):
            if chrom != chroms[0]:
                continue
            cols = np.flatnonzero((refpos >= s) & (refpos <= e))
            if cols.size == 0:
                continue
            seg = np.minimum((np.arange(cols.size) * segs)
                             // max(cols.size, 1), segs - 1)
            prof[li][0] += np.bincount(seg, minlength=segs)
            prof[li][1] += np.bincount(seg[ident[cols]], minlength=segs)
    n = 0
    with open(outpath, "w") as f:
        f.write('"LocusID","Chrom","Start","End",' +
                ",".join(f'"Seg{i + 1}Ident"' for i in range(segs)) + "\n")
        for li, (chrom, s, e) in enumerate(loci):
            tot, idn = prof[li]
            vals = np.where(tot > 0, idn / np.maximum(tot, 1), 0.0)
            f.write(f'{li + 1},"{chrom}",{s},{e},' +
                    ",".join(f"{v:.4f}" for v in vals) + "\n")
            n += 1
    return n


def process_csv_files(inpaths: str | list[str], outpath: str,
                      op: str = "merge") -> int:
    """Generic loci-CSV set utility (processcsvfiles.cpp role):
    op merge (concatenate + sort + dedupe) or common (loci present in
    every input)."""
    paths = (sorted(_glob.glob(inpaths)) if isinstance(inpaths, str)
             else list(inpaths))
    sets = [set(_read_loci_csv(p)) for p in paths]
    if not sets:
        rows = []
    elif op == "common":
        rows = sorted(set.intersection(*sets))
    else:
        rows = sorted(set.union(*sets))
    with open(outpath, "w") as f:
        for i, (chrom, s, e) in enumerate(rows, 1):
            f.write(f'{i},"{chrom}",{s},{e},{e - s + 1}\n')
    return len(rows)


def gen_norm_wiggle(loci_path: str, outpath: str, mode: int = 0,
                    span: int = 1) -> int:
    """Normalised wiggle from aligned loci (genNormWiggle.cpp modes:
    0 read starts, 1 coverage), scaled to reads-per-million
    (variableStep wig output)."""
    from .chromatin_tools import _read_loci

    loci = _read_loci(loci_path)
    total = max(len(loci), 1)
    scale = 1e6 / total
    per_chrom: dict[str, np.ndarray] = {}
    maxend: dict[str, int] = {}
    for chrom, s, e, _st in loci:
        maxend[chrom] = max(maxend.get(chrom, 0), e + 1)
    for chrom, sz in maxend.items():
        per_chrom[chrom] = np.zeros(sz, dtype=np.float64)
    for chrom, s, e, _st in loci:
        if mode == 0:
            per_chrom[chrom][s] += scale
        else:
            per_chrom[chrom][s:e + 1] += scale
    n = 0
    with open(outpath, "w") as f:
        f.write('track type=wiggle_0 name="normwiggle"\n')
        for chrom in sorted(per_chrom):
            f.write(f"variableStep chrom={chrom} span={span}\n")
            v = per_chrom[chrom]
            nz = np.flatnonzero(v)
            for i in nz[::span].tolist():
                f.write(f"{i + 1}\t{v[i]:.4f}\n")
                n += 1
    return n
