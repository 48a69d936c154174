"""Copy of biokanga_tpu/align/postpass.py: the post-alignment passes.

Passes over the accepted-hit table, the CAligner post-pass family
(Aligner.cpp:594-672), re-expressed as vectorised array passes over the
batch result dict (no per-read Python loops):

- reduce_pcr_duplicates   (ReducePCRduplicates, Aligner.cpp:596)
- auto_trim_flanks        (AutoTrimFlanks, Aligner.cpp:1608)
- pcr5_primer_correct     (PCR5PrimerCorrect, Aligner.cpp:2000)
- remove_orphan_splice_juncts / remove_orphan_microindels
                          (Aligner.cpp:2287,2382)
- identify_constraint_violations + load_loci_constraints
                          (Aligner.cpp:2599,2529; tsConstraintLoci
                           Aligner.h:207-212)
- PriorityRegionFilter    (FiltByPriorityRegions, -Y)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.annotations import FeatureIndex, read_bed

SPLICE_MARKER = 1 << 30


def reduce_pcr_duplicates(res: dict, lengths: np.ndarray,
                          keep: int = 1) -> int:
    """Demote duplicate accepted hits at identical (locus, strand) beyond
    `keep` copies (vectorised: sort + run-position).  Returns number
    demoted; mutates res['unique']."""
    acc = np.nonzero(res["unique"])[0]
    if len(acc) == 0:
        return 0
    key = res["locus"][acc].astype(np.int64) * 2 + res["is_rc"][acc]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    run_start = np.concatenate([[True], sk[1:] != sk[:-1]])
    run_id = np.cumsum(run_start) - 1
    first_pos = np.zeros(run_id[-1] + 1, np.int64)
    first_pos[run_id[run_start]] = np.nonzero(run_start)[0]
    occ = np.arange(len(sk)) - first_pos[run_id]
    demote = acc[order[occ >= keep]]
    res["unique"][demote] = False
    return len(demote)


def _oriented_windows(reads, lengths, res, genome, rows):
    """(k, L) oriented read codes + genome window codes + live mask for
    the given accepted rows (uniform read width)."""
    L = reads.shape[1]
    loc = res["locus"][rows].astype(np.int64)
    win = genome[np.clip(loc[:, None] + np.arange(L), 0, len(genome) - 1)]
    r = reads[rows].copy()
    rc = res["is_rc"][rows]
    if rc.any():
        sub = r[rc]
        flip = np.where(sub >= 4, sub, 3 - sub)[:, ::-1]
        # shift the pad to the tail after reversal
        ln = lengths[rows][rc]
        out = np.full_like(sub, 4)
        for i, l_ in enumerate(ln):  # rc rows only; l_ uniform in practice
            out[i, :l_] = flip[i, L - l_:]
        r[rc] = out
    live = np.arange(L)[None, :] < lengths[rows][:, None]
    return r, win, live


def _run_len_from_left(mm: np.ndarray) -> np.ndarray:
    """(k, L) exact-match run length ending at each position."""
    k, L = mm.shape
    idx = np.arange(L)[None, :]
    last_mm = np.maximum.accumulate(np.where(mm, idx, -1), axis=1)
    return idx - last_mm


@dataclass
class TrimStats:
    demoted_plus: int = 0
    demoted_minus: int = 0
    trimmed: int = 0


def auto_trim_flanks(reads, lengths, res, genome,
                     min_flank_exacts: int, pe: bool = False) -> TrimStats:
    """AutoTrimFlanks (Aligner.cpp:1608): trim aligned read flanks until
    at least `min_flank_exacts` exactly-matching bases flank both ends;
    demote reads that cannot retain max(len/2, 15) bases (SE mode).

    Adds res['clip5'] / res['clip3'] (oriented/SEQ-space soft clips, the
    same fields the chimeric AdaptiveTrim pass uses) + res['match_len'],
    and adjusts res['locus'] and res['best_mm'] to the trimmed window.
    """
    B = len(lengths)
    for f in ("clip5", "clip3"):
        if f not in res:
            res[f] = np.zeros(B, np.int32)
    if "match_len" not in res:
        res["match_len"] = lengths.astype(np.int32).copy()
    stats = TrimStats()
    mfe = min_flank_exacts
    if mfe <= 0:
        return stats
    plain = res.get("cigar_op")
    acc = res["unique"].copy()
    if plain is not None:
        acc &= plain == 0  # can't trim spliced/microInDel/chimeric hits
    rows = np.nonzero(acc)[0]
    if len(rows) == 0:
        return stats

    r, win, live = _oriented_windows(reads, lengths, res, genome, rows)
    mm = (r != win) | ~live | (r >= 4)
    mm &= live  # pad is not scanned (loop bound is MatchLen)
    ln = lengths[rows].astype(np.int64)
    min_trim = np.maximum((ln + 1) // 2, 15)

    # 5' scan: first position p with an exact run of mfe ending at p,
    # within Idx <= len - min_trim and Idx < PEmincore
    rl = _run_len_from_left(mm)
    L = mm.shape[1]
    p_idx = np.arange(L)[None, :]
    lim5 = np.minimum(ln - min_trim,
                      (ln if not pe else ln // 3) - 1)[:, None]
    ok5 = (rl >= mfe) & (p_idx <= lim5)
    has5 = ok5.any(axis=1)
    p5 = np.argmax(ok5, axis=1)
    left = p5 - (mfe - 1)

    # 3' scan on the reversed window: bound Idx >= left+min_trim and
    # Idx > PEmincore3
    mm_r = mm[:, ::-1]
    # reversed position q corresponds to original index len-1-q for each
    # read length; roll each row so the read's last base is column 0
    roll = (L - ln).astype(np.int64)
    cols = (np.arange(L)[None, :] + roll[:, None]) % L
    mm_rr = np.take_along_axis(mm_r, cols, axis=1)
    rl3 = _run_len_from_left(mm_rr)
    # original index of reversed position q is ln-1-q; constraints:
    #   orig >= left + min_trim  ->  q <= ln-1-left-min_trim
    #   orig > PEmincore3 (= 2*ln/3 for PE, else 0)
    lim3 = (ln - 1 - left - min_trim)[:, None]
    if pe:
        lim3 = np.minimum(lim3, (ln - 1 - (2 * ln) // 3 - 1)[:, None])
    ok3 = (rl3 >= mfe) & (p_idx <= lim3)
    has3 = ok3.any(axis=1)
    q3 = np.argmax(ok3, axis=1)
    right = ln - 1 - (q3 - (mfe - 1))

    good = has5 & has3 & (right - left + 1 >= min_trim)
    if not pe:
        # SE: unable to trim -> slough the read (eNARTrim)
        bad = rows[~good]
        res["unique"][bad] = False
        rc_bad = res["is_rc"][bad]
        stats.demoted_plus = int((~rc_bad).sum())
        stats.demoted_minus = int(rc_bad.sum())
    g = rows[good]
    lg, rg = left[good], right[good]
    lng = ln[good]
    cs = np.concatenate(
        [np.zeros((len(rows), 1), np.int64), np.cumsum(mm, axis=1)], axis=1
    )[good]
    new_mm = cs[np.arange(len(g)), rg + 1] - cs[np.arange(len(g)), lg]
    trim5 = lg.astype(np.int32)
    trim3 = (lng - 1 - rg).astype(np.int32)
    res["clip5"][g] = trim5
    res["clip3"][g] = trim3
    res["match_len"][g] = (rg - lg + 1).astype(np.int32)
    # trims are in oriented (genome-forward) space: the window's new
    # leftmost is locus + trim5 on either strand
    res["locus"][g] = res["locus"][g] + trim5
    res["best_mm"][g] = np.minimum(new_mm, 255).astype(res["best_mm"].dtype)
    stats.trimmed = int((trim5 + trim3 > 0).sum())
    return stats


def pcr5_primer_correct(reads, lengths, res, genome,
                        max_sub_rate: int, klen: int) -> tuple[int, int]:
    """PCR5PrimerCorrect (Aligner.cpp:2000): treat 5' mismatches within
    the first `klen` bases as PCR random-primer artefacts; correct them
    (read base := target base) until the read meets max_sub_rate subs/100.
    Mutates `reads` (read-space) and res['best_mm'].  Returns
    (corrected_reads, corrected_bases)."""
    if klen < 1:
        return 0, 0
    max_mm = ((max_sub_rate * lengths.astype(np.int64)) + 50) // 100
    plain = res.get("cigar_op")
    acc = res["unique"] & (res["best_mm"].astype(np.int64) > max_mm)
    if plain is not None:
        acc &= plain == 0
    rows = np.nonzero(acc)[0]
    if len(rows) == 0:
        return 0, 0
    r, win, live = _oriented_windows(reads, lengths, res, genome, rows)
    mm = ((r != win) | (r >= 4)) & live
    k5 = mm[:, :klen]
    n5 = k5.sum(axis=1)
    best = res["best_mm"][rows].astype(np.int64)
    need = best - max_mm[rows]
    can = n5 >= need
    crows = rows[can]
    if len(crows) == 0:
        return 0, 0
    # correct the first `need` 5' mismatches of each correctable read
    order_cs = np.cumsum(k5[can], axis=1)
    fix = k5[can] & (order_cs <= need[can, None])
    n_bases = int(fix.sum())
    # map oriented 5' offsets back to stored read-space positions
    rc = res["is_rc"][crows]
    ln = lengths[crows]
    for i, row in enumerate(crows):  # small row count: only overfull reads
        pos = np.nonzero(fix[i])[0]
        tb = win[np.nonzero(can)[0][i], pos]
        if rc[i]:
            reads[row, ln[i] - 1 - pos] = np.where(tb >= 4, tb, 3 - tb)
        else:
            reads[row, pos] = tb
    res["best_mm"][crows] = (best[can] - fix.sum(axis=1)).astype(
        res["best_mm"].dtype
    )
    return len(crows), n_bases


def _orphan_filter(res: dict, rows: np.ndarray, key_a, key_b,
                   tol: int) -> int:
    """Shared splice/indel orphan logic: sort by (key_a, key_b); entries
    whose neighbours (either side) are within +-tol on BOTH keys are
    supported; others are demoted (treated as unaligned)."""
    if len(rows) < 2:
        res["unique"][rows] = False
        return len(rows)
    order = np.lexsort((key_b, key_a))
    a, b = key_a[order], key_b[order]
    near_next = (np.abs(np.diff(a)) <= tol) & (np.abs(np.diff(b)) <= tol)
    sup = np.zeros(len(rows), bool)
    sup[:-1] |= near_next
    sup[1:] |= near_next
    demote = rows[order[~sup]]
    res["unique"][demote] = False
    return len(demote)


def remove_orphan_splice_juncts(res: dict, lengths, tol: int = 3) -> int:
    """RemoveOrphanSpliceJuncts (Aligner.cpp:2287): junctions supported by
    fewer than 2 reads (donor/acceptor within +-tol) become unaligned."""
    if "cigar_op" not in res:
        return 0
    rows = np.nonzero(res["unique"] & (res["cigar_op"] == SPLICE_MARKER))[0]
    if len(rows) == 0:
        return 0
    donor = res["locus"][rows].astype(np.int64) + res["split"][rows]
    acceptor = donor + res["op_len"][rows]
    return _orphan_filter(res, rows, donor, acceptor, tol)


def remove_orphan_microindels(res: dict, lengths, tol: int = 3) -> int:
    """RemoveOrphanMicroInDels (Aligner.cpp:2382): microInDels unsupported
    by a second read at (+-tol) the same indel locus/size are demoted."""
    if "cigar_op" not in res:
        return 0
    is_ind = (res["cigar_op"] != 0) & (res["cigar_op"] != SPLICE_MARKER)
    rows = np.nonzero(res["unique"] & is_ind)[0]
    if len(rows) == 0:
        return 0
    at = res["locus"][rows].astype(np.int64) + res["split"][rows]
    size = res["cigar_op"][rows].astype(np.int64)
    return _orphan_filter(res, rows, at, size, tol)


# --------------------------- loci base constraints -----------------------

@dataclass
class ConstraintLoci:
    """tsConstraintLoci parity (Aligner.h:207-212)."""

    chrom: str
    start: int     # inclusive
    end: int       # inclusive
    allowed: str   # e.g. "AC", may include "R" = reference base


def load_loci_constraints(path: str) -> list[ConstraintLoci]:
    """CSV rows: chrom,start,end,bases (bases: ACGT chars and/or R)."""
    out = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        f = [x.strip().strip('"') for x in line.split(",")]
        out.append(ConstraintLoci(f[0], int(f[1]), int(f[2]), f[3].upper()))
    return out


def identify_constraint_violations(
    reads, lengths, res, genome, entry_names, entry_starts,
    constraints: list[ConstraintLoci],
) -> int:
    """IdentifyConstraintViolations (Aligner.cpp:2599): accepted reads
    covering a constrained locus whose aligned base is not in the allowed
    set are demoted to unaligned."""
    if not constraints:
        return 0
    starts = np.asarray(entry_starts)
    name_to_e = {n: i for i, n in enumerate(entry_names)}
    rows = np.nonzero(res["unique"])[0]
    if len(rows) == 0:
        return 0
    r, win, live = _oriented_windows(reads, lengths, res, genome, rows)
    loc = res["locus"][rows].astype(np.int64)
    ln = lengths[rows].astype(np.int64)
    bad = np.zeros(len(rows), bool)
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    for c in constraints:
        e = name_to_e.get(c.chrom)
        if e is None:
            continue
        g0 = int(starts[e]) + c.start
        g1 = int(starts[e]) + c.end
        # reads overlapping [g0, g1]
        ov = (loc <= g1) & (loc + ln - 1 >= g0)
        if not ov.any():
            continue
        allowed = np.zeros(5, bool)
        for ch in c.allowed:
            if ch == "R":
                pass  # handled per-locus below
            elif ch in code:
                allowed[code[ch]] = True
        for g in range(g0, g1 + 1):
            off = g - loc  # read-space offset (oriented window == genome)
            inside = ov & (off >= 0) & (off < ln)
            if not inside.any():
                continue
            rowsel = np.nonzero(inside)[0]
            base = r[rowsel, off[rowsel]]
            ok = allowed[np.clip(base, 0, 4)]
            if "R" in c.allowed:
                ok |= base == genome[g]
            bad[rowsel[~ok]] = True
    res["unique"][rows[bad]] = False
    return int(bad.sum())


class PriorityRegionFilter:
    """Drop accepted hits not overlapping priority regions (-Y)."""

    def __init__(self, bed_path: str, entry_names, entry_starts):
        feats = read_bed(bed_path)
        self.fidx = FeatureIndex(feats)
        self.entry_names = list(entry_names)
        self.starts = np.asarray(entry_starts)

    def apply(self, res: dict, lengths: np.ndarray) -> int:
        dropped = 0
        for i in np.nonzero(res["unique"])[0]:
            locus = int(res["locus"][i])
            e = int(np.searchsorted(self.starts, locus, "right")) - 1
            chrom = self.entry_names[e]
            s = locus - int(self.starts[e])
            if not self.fidx.overlapping(chrom, s, s + int(lengths[i])):
                res["unique"][i] = False
                dropped += 1
        return dropped
