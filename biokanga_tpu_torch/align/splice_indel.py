"""Micro-indel and splice-junction alignment scans, on the index's device.

Counterpart of biokanga_tpu/align/splice_indel.py, same results.
Capability match for CSfxArrayV3::LocateInDels / LocateSpliceJuncts
(libbiokanga/SfxArrayV2.cpp:7348,7022), run for reads the pure-Hamming
pass could not accept (the reference's AlignReads falls through the same
way, SfxArrayV2.cpp:7663-7760).  Reference rules reproduced
(SfxArrayV2.h:18-40):

- micro-indels: length 1..20 (cMaxMicroInDelLen), at most 2 total
  mismatches (cMaxMicroInDelMM), both segments >= 7 (cMinInDelSeqLen)
- splice junctions: segment separation 25..100000
  (cMinJunctAlignSep/cMaxJunctAlignSep), at most 2 mismatches
  (cMaxJunctAlignMM), both segments >= 10 (cMinJunctSegLen)
- scoring: base 500 (clamped 1000), match +3, mismatch -5, indel open
  -20 extend -1, splice separation -10/Kbp

Per candidate the mismatch indicators come from the packed genome's
window words (ops/extend_packed.gather_window_words) XORed with the
packed read; best split points are cumulative-sum minimisations: indels
minimise over (split, shift), splices minimise a min-plus product that
pairs candidate diagonals.  Everything is plain torch on the device of
the inputs.  Ties follow the JAX package exactly: the first minimum and
maximum along each axis, and, for a splice, the RIGHTMOST split among
equal mismatch counts (the argmin over the reversed split axis).
"""
from __future__ import annotations

import torch

from ..device import u32
from ..ops.extend_packed import BASES_PER_WORD, gather_window_words

C_MAX_MICRO_INDEL_LEN = 20
C_MAX_MICRO_INDEL_MM = 2
C_MIN_INDEL_SEG_LEN = 7
C_MIN_JUNCT_SEP = 25
C_MAX_JUNCT_SEP = 100_000
C_MAX_JUNCT_MM = 2
C_MIN_JUNCT_SEG_LEN = 10

C_BASE_SCORE = 500
C_MAX_SCORE = 1000
C_SCORE_MATCH = 3
C_SCORE_MISMATCH = 5
C_SPLICE_DONOR_ACCEPT = 50
C_SPLICE_LEN = 10           # per Kbp separation
C_SCORE_INDEL_OPN = 20
C_SCORE_INDEL_EXTN = 1

BIG = 1 << 20
# the splice scan's (rows, C, C, L + 1) int32 min-plus intermediate is
# formed a chunk of rows at a time, at most this many bytes
SPLICE_CHUNK_BYTES = 1 << 30


def _mismatch_indicators(pg, loci, rcodes, rnlane, L: int, shift: int):
    """(B, C, L) int32 mismatch indicators of read vs genome at
    locus + position + shift.  loci: (B, C) int32; rcodes / rnlane:
    (B, W) int32 bits of the packed read (pack_reads)."""
    W = rcodes.shape[-1]
    eff = loci.to(torch.int64) + shift
    x = gather_window_words(pg.rows, eff, W) ^ u32(rcodes)[:, None, :]
    x = x | u32(rnlane)[:, None, :]
    if pg.n_rows is not None:
        x = x | gather_window_words(pg.n_rows, eff, W)
    lanes = (x | (x >> 1)) & 0x55555555
    # per-position bits: lane t (MSB-first) at bit 2*(15-t)
    t = torch.arange(BASES_PER_WORD, device=loci.device)
    bits = (lanes[..., None] >> (2 * (15 - t))) & 1
    ind = bits.reshape(bits.shape[:-2] + (W * BASES_PER_WORD,))
    return ind[..., :L].to(torch.int32)


def _entry_valid(entry_starts, loci, valid, last, genome_len: int):
    """valid & (loci >= 0) & (last < genome_len) & first and last base in
    one entry (searchsorted right on the entry starts)."""
    starts = entry_starts.to(torch.int64)
    lo = loci.to(torch.int64)
    ent_a = torch.searchsorted(starts, lo.contiguous(), right=True)
    ent_b = torch.searchsorted(starts, last.contiguous(), right=True)
    return valid & (lo >= 0) & (last < genome_len) & (ent_a == ent_b)


def _prefix_counts(ind, live):
    """(B, C, L + 1) int32 inclusive prefix sums of the live indicators,
    with a leading zero column."""
    P = torch.cumsum(torch.where(live[:, None, :], ind, 0), dim=-1,
                     dtype=torch.int32)
    return torch.nn.functional.pad(P, (1, 0))


def indel_scan(pg, entry_starts, loci, valid, rcodes, rnlane, lengths,
               L: int, max_indel: int) -> dict:
    """Best micro-indel alignment per read over all candidates
    (biokanga_tpu/align/splice_indel.py:79).

    pg: PackedGenome; entry_starts (E+1,) int32; loci (B, C) int32;
    valid (B, C) bool; rcodes / rnlane (B, W) int32 bits; lengths (B,)
    int32; L the padded read width.  Returns per-read tensors: ok,
    score, mm, split, indel (signed: >0 = deletion from the read's
    perspective (genome gap), <0 = insertion) and cand (the candidate
    column).
    """
    B, C = loci.shape
    dev = loci.device
    ln = lengths.to(torch.int64)
    # window must fit within entry for the largest genome footprint
    endmost = loci.to(torch.int64) + ln[:, None] + max_indel - 1
    valid = _entry_valid(entry_starts, loci, valid, endmost, pg.length)

    live = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    P = _prefix_counts(_mismatch_indicators(pg, loci, rcodes, rnlane, L, 0),
                       live)

    best_mm = torch.full((B,), BIG, dtype=torch.int32, device=dev)
    best_score = torch.full((B,), -BIG, dtype=torch.int32, device=dev)
    best_split = torch.zeros(B, dtype=torch.int32, device=dev)
    best_indel = torch.zeros(B, dtype=torch.int32, device=dev)
    best_cand = torch.zeros(B, dtype=torch.int32, device=dev)

    s_idx = torch.arange(L + 1, device=dev)[None, None, :]
    slen = ln[:, None, None]
    rows = torch.arange(B, device=dev)
    for g in [s * k for k in range(1, max_indel + 1) for s in (1, -1)]:
        # g > 0: genome deletion of g; g < 0: read insertion of |g|;
        # suffix indicators: read[l] vs genome[locus + l + g]
        Cg = _prefix_counts(
            _mismatch_indicators(pg, loci, rcodes, rnlane, L, g), live)
        Tg = Cg[..., -1:]
        j = -g if g < 0 else 0
        # the suffix starts at read index s + j
        sfrom = torch.clamp(s_idx + j, max=L).expand(B, C, L + 1)
        mm_sg = P + (Tg - torch.gather(Cg, -1, sfrom))   # (B, C, L+1)
        okseg = ((s_idx >= C_MIN_INDEL_SEG_LEN)
                 & (slen - s_idx - j >= C_MIN_INDEL_SEG_LEN))
        mm_sg = torch.where(okseg & valid[..., None], mm_sg, BIG)
        mmc, sc_split = torch.min(mm_sg, dim=-1)            # (B, C)
        glen = abs(g)
        score = (C_BASE_SCORE
                 + (lengths[:, None] - (glen if g < 0 else 0) - mmc)
                 * C_SCORE_MATCH
                 - mmc * C_SCORE_MISMATCH
                 - C_SCORE_INDEL_OPN
                 - (glen - 1) * C_SCORE_INDEL_EXTN)
        score = torch.clamp(score, max=C_MAX_SCORE)
        score = torch.where(mmc <= C_MAX_MICRO_INDEL_MM, score, -BIG)
        bi = torch.argmax(score, dim=-1)                     # best candidate
        sc = score[rows, bi].to(torch.int32)
        better = sc > best_score
        best_mm = torch.where(better, mmc[rows, bi].to(torch.int32), best_mm)
        best_score = torch.where(better, sc, best_score)
        best_split = torch.where(better, sc_split[rows, bi].to(torch.int32),
                                 best_split)
        best_indel = torch.where(better, g, best_indel)
        best_cand = torch.where(better, bi.to(torch.int32), best_cand)

    return {"mm": best_mm, "score": best_score, "split": best_split,
            "indel": best_indel, "cand": best_cand,
            "ok": best_score > -BIG}


def _splice_rows(Cm, T, valid, okseg, loci, lengths, L: int, max_sep: int):
    """splice_scan's pairwise pass over one chunk of rows."""
    B, C = loci.shape
    keep = valid[..., None] & okseg[:, None, :]
    pref = torch.where(keep, Cm, BIG)
    sufc = torch.where(keep, -Cm, BIG)
    # D[b, c5, c3] = min_s pref[b, c5, s] + sufc[b, c3, s]; among equal
    # mismatch counts the RIGHTMOST split (maximal 5' exon), the
    # reference's junction canonicalisation (LocateSpliceJuncts,
    # SfxArrayV2.cpp:7022): the first minimum over the reversed split axis
    rev = (pref.flip(-1)[:, :, None, :] + sufc.flip(-1)[:, None, :, :])
    D, ridx = torch.min(rev, dim=-1)
    del rev
    Ssplit = L - ridx
    mm_pair = D + T[:, None, :]

    lo = loci.to(torch.int64)
    sep = lo[:, None, :] - lo[:, :, None]          # d3 - d5
    ok_pair = ((sep >= C_MIN_JUNCT_SEP) & (sep <= max_sep)
               & valid[:, :, None] & valid[:, None, :]
               & (mm_pair <= C_MAX_JUNCT_MM))
    score = (C_BASE_SCORE
             + (lengths.to(torch.int64)[:, None, None] - mm_pair)
             * C_SCORE_MATCH
             - mm_pair * C_SCORE_MISMATCH
             - torch.div(sep, 1000, rounding_mode="floor") * C_SPLICE_LEN)
    score = torch.clamp(score, max=C_MAX_SCORE)
    score = torch.where(ok_pair, score, -BIG).to(torch.int32)
    flat = score.reshape(B, C * C)
    bi = torch.argmax(flat, dim=-1)
    rows = torch.arange(B, device=loci.device)
    c5 = torch.div(bi, C, rounding_mode="floor")
    c3 = bi % C
    sc = flat[rows, bi]
    return {
        "ok": sc > -BIG,
        "score": sc,
        "locus5": loci[rows, c5],
        "locus3": loci[rows, c3],
        "split": Ssplit.reshape(B, C * C)[rows, bi].to(torch.int32),
        "mm": mm_pair.reshape(B, C * C)[rows, bi].to(torch.int32),
    }


def splice_scan(pg, entry_starts, loci, valid, rcodes, rnlane, lengths,
                L: int, max_sep: int) -> dict:
    """Best spliced (two-segment) alignment per read: pair candidate
    diagonals (d5, d3) with separation in [25, max_sep], minimise
    prefix(d5) + suffix(d3) mismatches over the split point
    (biokanga_tpu/align/splice_indel.py:169).

    Arguments as indel_scan's.  Returns per-read tensors: ok, score,
    locus5, locus3, split, mm.  The (B, C, C, L + 1) intermediate is
    formed SPLICE_CHUNK_BYTES at a time; rows are independent, so the
    chunking changes no result.
    """
    B, C = loci.shape
    dev = loci.device
    last = loci.to(torch.int64) + lengths.to(torch.int64)[:, None] - 1
    valid = _entry_valid(entry_starts, loci, valid, last, pg.length)

    live = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    Cm = _prefix_counts(_mismatch_indicators(pg, loci, rcodes, rnlane, L, 0),
                        live)
    T = Cm[..., -1]
    s_idx = torch.arange(L + 1, device=dev)
    okseg = ((s_idx[None, :] >= C_MIN_JUNCT_SEG_LEN)
             & (lengths[:, None] - s_idx[None, :] >= C_MIN_JUNCT_SEG_LEN))

    step = max(1, SPLICE_CHUNK_BYTES // (C * C * (L + 1) * 4))
    parts = [_splice_rows(Cm[a:a + step], T[a:a + step], valid[a:a + step],
                          okseg[a:a + step], loci[a:a + step],
                          lengths[a:a + step], L, max_sep)
             for a in range(0, B, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
