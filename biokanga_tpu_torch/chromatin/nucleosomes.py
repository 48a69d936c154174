"""Copy of biokanga_tpu/chromatin/nucleosomes.py (host numpy).

Nucleosome / MNase models.

Reference semantics:
- MNase site preferences: 4^8 per-octamer cut preferences (0..1) loaded
  from a CSV whose field 1 is the octamer and field 4 the preference
  (prednucleosomes.cpp InitMNaseSitePrefs :1009-1066 — the CSV is the
  output of DNAseqSitePotential: "octamer",genome_cnt,site_cnt,ratio).
- MNase sequence score: probability of >=1 cut in a window under
  independent per-octamer cut events:
  score = 1 - prod(1 - pref[oct_i])   (prednucleosomes.cpp
  MNaseSeqScore :1093-1160).
- Dyad calling: per-locus scores smoothed with a moving-average lowpass
  (-a avgwindow, default 10) and baseline-normalised over a larger
  window (-A basewindow, default 250), then local maxima become dyads;
  nucleosomes are dyad +/- 73 bp (147 bp core), formats bedGraph / BED /
  CSV (prednucleosomes.cpp / predconfnucs.cpp format modes 0-7).

The window score uses a log-space prefix sum so every window is O(1) —
`1 - exp(cumsum(log1p(-p)))` — instead of the reference's per-window
rescan; the moving averages are prefix sums too.  All of it is host
numpy, as in the JAX module; `call_dyads` keeps its stable argsort and
greedy loop, which fix the tie order.
"""
from __future__ import annotations

import numpy as np

from .conformation import oligo_indices, octamer_to_idx

NUC_CORE = 147          # canonical nucleosome core length
DYAD_FLANK = NUC_CORE // 2


def load_mnase_prefs(path: str) -> np.ndarray:
    """MNase site-preference CSV -> (65536,) float64 preferences.

    Field 1 = octamer, field 4 = preference (InitMNaseSitePrefs reads
    GetText(1) / GetDouble(4), prednucleosomes.cpp:1058-1063).
    """
    prefs = np.zeros(4 ** 8, dtype=np.float64)
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = [p.strip().strip('"') for p in line.strip().split(",")]
            if len(parts) < 4 or not parts[0]:
                continue
            try:
                idx = octamer_to_idx(parts[0])
                val = float(parts[3])
            except ValueError:
                if lineno == 1:
                    continue  # header
                raise
            prefs[idx] = val
    return prefs


def site_cut_probs(codes: np.ndarray, prefs: np.ndarray) -> np.ndarray:
    """Per-position octamer cut preference along a sequence (0 where the
    octamer window holds an N). Length = len(codes)-7."""
    idx = oligo_indices(codes, 8)
    return np.where(idx >= 0, prefs[np.maximum(idx, 0)], 0.0)


def mnase_window_scores(codes: np.ndarray, prefs: np.ndarray,
                        winlen: int) -> np.ndarray:
    """P(>=1 MNase cut) for every `winlen` window start.

    Equivalent to MNaseSeqScore over each window, computed once for the
    whole sequence via a log-space prefix sum (O(1) per window instead
    of the reference's O(winlen) rescan per start).
    """
    p = site_cut_probs(codes, prefs)
    n_oct_per_win = winlen - 7
    if p.size < n_oct_per_win or n_oct_per_win <= 0:
        return np.zeros(0, dtype=np.float64)
    log1m = np.log1p(-np.clip(p, 0.0, 1.0 - 1e-12))
    csum = np.concatenate([[0.0], np.cumsum(log1m)])
    spans = csum[n_oct_per_win:] - csum[:-n_oct_per_win]
    return 1.0 - np.exp(spans)


def moving_average(x: np.ndarray, w: int) -> np.ndarray:
    """Centered moving-average lowpass (reference -a avgwindow)."""
    if w <= 1 or x.size == 0:
        return np.asarray(x, dtype=np.float64)
    csum = np.concatenate([[0.0], np.cumsum(np.asarray(x, np.float64))])
    half = w // 2
    n = x.size
    lo = np.clip(np.arange(n) - half, 0, n)
    hi = np.clip(np.arange(n) + (w - half), 0, n)
    return (csum[hi] - csum[lo]) / np.maximum(hi - lo, 1)


def baseline_normalise(x: np.ndarray, w: int) -> np.ndarray:
    """Subtract a local-baseline moving mean over window `w` (reference
    -A basewindow), clamping at zero."""
    if w <= 1 or x.size == 0:
        return np.asarray(x, dtype=np.float64)
    return np.maximum(np.asarray(x, np.float64) - moving_average(x, w), 0.0)


def call_dyads(score: np.ndarray, min_sep: int = NUC_CORE,
               min_score: float = 0.0) -> np.ndarray:
    """Greedy non-maximum suppression: repeatedly take the highest
    remaining score, suppress +/- min_sep. Returns sorted dyad loci."""
    score = np.asarray(score, dtype=np.float64)
    order = np.argsort(score, kind="stable")[::-1]
    taken = np.zeros(score.size, dtype=bool)
    blocked = np.zeros(score.size, dtype=bool)
    for i in order:
        if score[i] <= min_score:
            break
        if blocked[i]:
            continue
        taken[i] = True
        blocked[max(0, i - min_sep):i + min_sep + 1] = True
    return np.flatnonzero(taken)


# ---------------------------------------------------------------------------
# output writers shared by prednucleosomes / predconfnucs (format modes
# 0-7, prednucleosomes.cpp `format` argtable help)

def write_dyad_tracks(outpath: str, fmt: int, title: str,
                      per_chrom: list[tuple[str, np.ndarray, np.ndarray]],
                      score_hist: np.ndarray | None = None) -> int:
    """per_chrom: (chrom, dyad_loci, dyad_scores). Returns rows written."""
    n = 0
    with open(outpath, "w") as f:
        if fmt in (0, 3):        # UCSC bedGraph
            f.write(f'track type=bedGraph name="{title}"\n')
        elif fmt in (1, 4):      # UCSC BED
            f.write(f'track name="{title}"\n')
        elif fmt == 6:           # score distribution histogram
            f.write('"ScoreBin","Count"\n')
            if score_hist is not None:
                for b, c in enumerate(score_hist):
                    f.write(f"{b},{int(c)}\n")
                    n += 1
            return n
        for chrom, loci, scores in per_chrom:
            for locus, sc in zip(loci.tolist(), scores.tolist()):
                if fmt == 0:     # bedGraph dyads
                    f.write(f"{chrom}\t{locus}\t{locus + 1}\t{sc:.4f}\n")
                elif fmt == 1:   # BED dyads
                    f.write(f"{chrom}\t{locus}\t{locus + 1}\t"
                            f"dyad{n + 1}\t{min(1000, int(sc))}\t+\n")
                elif fmt == 2:   # CSV dyads
                    f.write(f'{n + 1},"dyad","{chrom}",{locus},{sc:.4f}\n')
                elif fmt == 3:   # bedGraph nucleosomes
                    f.write(f"{chrom}\t{max(0, locus - DYAD_FLANK)}\t"
                            f"{locus + DYAD_FLANK + 1}\t{sc:.4f}\n")
                elif fmt == 4:   # BED nucleosomes
                    f.write(f"{chrom}\t{max(0, locus - DYAD_FLANK)}\t"
                            f"{locus + DYAD_FLANK + 1}\tnuc{n + 1}\t"
                            f"{min(1000, int(sc))}\t+\n")
                elif fmt == 5:   # CSV nucleosomes
                    f.write(f'{n + 1},"nucleosome","{chrom}",'
                            f"{max(0, locus - DYAD_FLANK)},"
                            f"{locus + DYAD_FLANK + 1},{sc:.4f}\n")
                elif fmt == 7:   # CSV all dyad scores
                    f.write(f'"{chrom}",{locus},{sc:.6f}\n')
                n += 1
    return n
