"""Copy of biokanga_tpu/tools/expression.py (host numpy).

Expression / annotation-mapping family.

- maploci  : map aligned loci onto BED features with counts
  (capability match for `biokanga maploci` — CMapLoci2Feat,
  biokanga/MapLoci2Feat.cpp)
- gendeseq : per-feature count tables for DESeq/EdgeR
  (capability match for `biokanga gendeseq` — biokanga/genDESeq.cpp)
- rnade    : RNA-seq differential expression with the reference's
  characterisation thresholds (biokanga/kangade.cpp:70-80 —
  Pearson >= 0.8/0.5/0.3 bins; fold-change >= 1.75/1.5/1.25 bins),
  library-size normalisation and fold-change classification
- locateroi: coverage-based regions of interest
  (capability match for `biokanga locateroi` — CLocateROI)
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..seq.annotations import Feature, FeatureIndex, read_bed

# kangade.cpp:70-80 characterisation thresholds
C_HI_PEARSON = 0.8
C_MOD_PEARSON = 0.5
C_LO_PEARSON = 0.3
C_NO_FOLD = 1.25
C_LO_FOLD = 1.50
C_MOD_FOLD = 1.75


def read_sam_loci(path: str):
    """(chrom, start, end, strand) per aligned record."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fl = line.rstrip("\n").split("\t")
            flag = int(fl[1])
            if flag & 4:
                continue
            span = sum(
                int(m.group(1))
                for m in re.finditer(r"(\d+)([MDN=X])", fl[5])
            ) or len(fl[9])
            out.append(
                (fl[2], int(fl[3]) - 1, int(fl[3]) - 1 + span,
                 "-" if flag & 16 else "+")
            )
    return out


def map_loci_to_features(
    loci, features: list[Feature], match_strand: bool = False,
):
    """Count alignments per feature (+ unmapped count). An alignment is
    attributed to every overlapping feature (isoform handling: the
    reference's default splits across isoforms; we count per feature)."""
    fidx = FeatureIndex(features)
    counts = np.zeros(len(features), dtype=np.int64)
    n_unmatched = 0
    for chrom, s, e, strand in loci:
        hits = fidx.overlapping(chrom, s, e)
        if match_strand:
            hits = [h for h in hits if features[h].strand == strand]
        if not hits:
            n_unmatched += 1
            continue
        for h in hits:
            counts[h] += 1
    return counts, n_unmatched


def write_maploci_csv(path, features, counts, n_unmatched):
    with open(path, "w") as f:
        f.write('"FeatID","Feature","Chrom","Start","End","Strand","Cnts"\n')
        for i, (ft, c) in enumerate(zip(features, counts), 1):
            f.write(
                f'{i},"{ft.name}","{ft.chrom}",{ft.start},{ft.end},'
                f'"{ft.strand}",{int(c)}\n'
            )
        f.write(f'0,"_unmatched","*",0,0,"*",{n_unmatched}\n')


def gen_deseq_table(
    bed_features: list[Feature],
    control_sams: list[str],
    experiment_sams: list[str],
    out_path: str,
):
    """Per-feature count table, control columns then experiment columns
    (genDESeq.cpp role; reference caps 75 samples/side, ChangeLog:8)."""
    assert len(control_sams) <= 75 and len(experiment_sams) <= 75
    cols = []
    for path in list(control_sams) + list(experiment_sams):
        cnts, _ = map_loci_to_features(read_sam_loci(path), bed_features)
        cols.append(cnts)
    with open(out_path, "w") as f:
        hdr = ['"Feature"']
        hdr += [f'"Ctrl{i+1}"' for i in range(len(control_sams))]
        hdr += [f'"Expr{i+1}"' for i in range(len(experiment_sams))]
        f.write(",".join(hdr) + "\n")
        for i, ft in enumerate(bed_features):
            row = [f'"{ft.name}"'] + [str(int(c[i])) for c in cols]
            f.write(",".join(row) + "\n")
    return np.stack(cols, axis=1)


@dataclass
class DEResult:
    feature: str
    ctrl_cnts: float      # library-normalised
    expr_cnts: float
    fold_change: float    # experiment / control (signed convention: >1 up)
    pearson: float        # binned profile correlation
    classification: str   # none | low | moderate | high
    # Poisson-noise bootstrap confidence intervals + p-value (the
    # reference's cMaxConfidenceIterations machinery, kangade.cpp:65,
    # 342-355: up to 10000 iterations inducing random Poisson noise on
    # bin counts; medians + 95 percentiles for fold/Pearson; PValue =
    # two-sided fraction of resampled folds crossing 1)
    fold_median: float = 0.0
    fold_low95: float = 0.0
    fold_hi95: float = 0.0
    pearson_median: float = 0.0
    pearson_low95: float = 0.0
    pearson_hi95: float = 0.0
    pvalue: float = 1.0


REGIONS = ("feature", "exons", "introns", "cds", "utr", "utr5", "utr3")


def region_intervals(ft, region: str):
    """Genomic intervals of the requested functional region (kangade -r
    modes 0..6: complete transcript / Exons / Introns / CDSs / UTRs /
    5'UTRs / 3'UTRs — kangade.cpp region arg).  CDS/UTR use BED12
    thickStart/thickEnd when present."""
    if region == "feature":
        return [(ft.start, ft.end)]
    ex = ft.exons()
    if region == "exons":
        return ex
    if region == "introns":
        return [(ex[i][1], ex[i + 1][0]) for i in range(len(ex) - 1)
                if ex[i + 1][0] > ex[i][1]]
    ts = ft.attrs.get("thick_start", ft.start)
    te = ft.attrs.get("thick_end", ft.end)
    if region == "cds":
        return [(max(s, ts), min(e, te)) for s, e in ex
                if min(e, te) > max(s, ts)]
    five = [(s, min(e, ts)) for s, e in ex if min(e, ts) > s]
    three = [(max(s, te), e) for s, e in ex if e > max(s, te)]
    if ft.strand == "-":
        five, three = three, five
    if region == "utr":
        return five + three
    if region == "utr5":
        return five
    if region == "utr3":
        return three
    raise ValueError(f"unknown region {region}")


def _bootstrap_de(c_bins, e_bins, scale, iters, seed=7):
    """Vectorised Poisson-noise bootstrap over (F, B) bin-count matrices.

    Returns per-feature (fold med/lo95/hi95, pearson med/lo95/hi95,
    pvalue) — kangade's confidence-interval pass (kangade.cpp:1844+)
    with the per-feature per-iteration loop replaced by one
    (ITER, F, B) Poisson draw and batched statistics."""
    rng = np.random.default_rng(seed)
    F, B = c_bins.shape
    out = np.zeros((F, 7))
    CH = max(1, 4_000_000 // max(B * iters, 1))
    for s in range(0, F, CH):
        cb = c_bins[s : s + CH]
        eb = e_bins[s : s + CH]
        k = len(cb)
        rc = rng.poisson(cb[None], size=(iters, k, B)).astype(np.float64)
        re_ = rng.poisson(eb[None], size=(iters, k, B)).astype(np.float64)
        cc = rc.sum(axis=2)
        ee = re_.sum(axis=2) * scale
        fold = (ee + 1.0) / (cc + 1.0)
        # pearson per (iter, feature)
        ac = rc - rc.mean(axis=2, keepdims=True)
        ae = re_ - re_.mean(axis=2, keepdims=True)
        num = (ac * ae).sum(axis=2)
        den = np.sqrt((ac * ac).sum(axis=2) * (ae * ae).sum(axis=2))
        pear = np.where(den > 0, num / np.maximum(den, 1e-12), 0.0)
        q = lambda a, p: np.percentile(a, p, axis=0)
        out[s : s + CH, 0] = q(fold, 50)
        out[s : s + CH, 1] = q(fold, 2.5)
        out[s : s + CH, 2] = q(fold, 97.5)
        out[s : s + CH, 3] = q(pear, 50)
        out[s : s + CH, 4] = q(pear, 2.5)
        out[s : s + CH, 5] = q(pear, 97.5)
        up = (fold > 1.0).mean(axis=0)
        out[s : s + CH, 6] = np.clip(2.0 * np.minimum(up, 1.0 - up),
                                     1.0 / iters, 1.0)
    return out


def rnade(
    bed_features: list[Feature],
    control_sam: str,
    experiment_sam: str,
    num_bins: int = 10,
    min_feat_cnts: int = 10,
    confidence_iters: int = 1000,
    region: str = "feature",
) -> list[DEResult]:
    """Differential expression: per-feature normalised counts, binned
    start-loci profiles for Pearson correlation, fold-change
    classification with the reference's thresholds.  `region` restricts
    counting to a functional region (kangade -r; see region_intervals)."""
    ctrl = read_sam_loci(control_sam)
    expr = read_sam_loci(experiment_sam)
    fidx = FeatureIndex(bed_features)
    # per-feature region interval lists + cumulative region-space offsets
    regions = [region_intervals(ft, region) for ft in bed_features]
    reg_cum = []
    for iv in regions:
        c = [0]
        for s, e in iv:
            c.append(c[-1] + (e - s))
        reg_cum.append(c)

    def bin_profiles(loci):
        counts = np.zeros(len(bed_features), dtype=np.float64)
        bins = np.zeros((len(bed_features), num_bins), dtype=np.float64)
        for chrom, s, e, strand in loci:
            for h in fidx.overlapping(chrom, s, e):
                iv = regions[h]
                if not iv:
                    continue
                # read start must fall inside a region interval; bin by
                # its offset in concatenated region space
                pos = None
                for j, (a, b_) in enumerate(iv):
                    if a <= s < b_:
                        pos = reg_cum[h][j] + (s - a)
                        break
                if pos is None:
                    continue
                counts[h] += 1
                rel = pos / max(reg_cum[h][-1], 1)
                b = min(int(rel * num_bins), num_bins - 1)
                if b >= 0:
                    bins[h, b] += 1
        return counts, bins

    c_cnt, c_bins = bin_profiles(ctrl)
    e_cnt, e_bins = bin_profiles(expr)
    # library normalisation (ePPNormLibCnts role)
    lib_c, lib_e = max(c_cnt.sum(), 1), max(e_cnt.sum(), 1)
    scale = lib_c / lib_e

    keep = (c_cnt + e_cnt * scale) >= min_feat_cnts
    rows = np.nonzero(keep)[0]
    boot = None
    if confidence_iters > 0 and len(rows):
        boot = _bootstrap_de(c_bins[rows], e_bins[rows], scale,
                             confidence_iters)
    out = []
    for j, i in enumerate(rows):
        ft = bed_features[i]
        cc = float(c_cnt[i])
        ee = float(e_cnt[i]) * scale
        fold = (ee + 1.0) / (cc + 1.0)
        fold_mag = fold if fold >= 1 else 1.0 / fold
        a, b = c_bins[i], e_bins[i]
        if a.std() > 0 and b.std() > 0:
            pearson = float(np.corrcoef(a, b)[0, 1])
        else:
            pearson = 0.0
        # reference characterisation: BOTH correlation and fold bins
        if fold_mag < C_NO_FOLD or pearson < C_LO_PEARSON:
            cls = "none"
        elif fold_mag < C_LO_FOLD or pearson < C_MOD_PEARSON:
            cls = "low"
        elif fold_mag < C_MOD_FOLD or pearson < C_HI_PEARSON:
            cls = "moderate"
        else:
            cls = "high"
        r = DEResult(ft.name, cc, ee, fold, pearson, cls)
        if boot is not None:
            (r.fold_median, r.fold_low95, r.fold_hi95, r.pearson_median,
             r.pearson_low95, r.pearson_hi95, r.pvalue) = (
                float(x) for x in boot[j]
            )
        out.append(r)
    return out


def write_rnade_csv(path, results):
    with open(path, "w") as f:
        f.write('"Feature","CtrlCnts","ExprCnts","FoldChange","Pearson",'
                '"Class","FoldMedian","FoldLow95","FoldHi95",'
                '"PearsonMedian","PearsonLow95","PearsonHi95","PValue"\n')
        for r in results:
            f.write(
                f'"{r.feature}",{r.ctrl_cnts:.1f},{r.expr_cnts:.1f},'
                f'{r.fold_change:.4f},{r.pearson:.4f},"{r.classification}",'
                f'{r.fold_median:.4f},{r.fold_low95:.4f},{r.fold_hi95:.4f},'
                f'{r.pearson_median:.4f},{r.pearson_low95:.4f},'
                f'{r.pearson_hi95:.4f},{r.pvalue:.5f}\n'
            )


@dataclass
class ROI:
    chrom: str
    start: int
    end: int
    mean_cov: float


def locate_roi(
    sam_path: str,
    chrom_lengths: dict,
    min_cov: int = 2,
    min_len: int = 100,
) -> list[ROI]:
    """Coverage-based regions of interest (CLocateROI role): maximal runs
    with coverage >= min_cov and length >= min_len."""
    cov = {c: np.zeros(l, dtype=np.int32) for c, l in chrom_lengths.items()}
    for chrom, s, e, strand in read_sam_loci(sam_path):
        if chrom in cov:
            cov[chrom][s : e] += 1
    out = []
    for chrom, arr in cov.items():
        above = arr >= min_cov
        d = np.diff(np.concatenate([[0], above.view(np.int8), [0]]))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        for s, e in zip(starts, ends):
            if e - s >= min_len:
                out.append(ROI(chrom, int(s), int(e),
                               float(arr[s:e].mean())))
    return out


def write_roi_csv(path, rois):
    with open(path, "w") as f:
        f.write('"ROI_ID","Chrom","Start","End","Len","MeanCov"\n')
        for i, r in enumerate(rois, 1):
            f.write(
                f'{i},"{r.chrom}",{r.start},{r.end},{r.end - r.start},'
                f"{r.mean_cov:.2f}\n"
            )
