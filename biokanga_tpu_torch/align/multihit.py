"""Multi-hit assignment and chimeric (adaptive) trimming (host numpy).

Copied from biokanga_tpu/align/multihit.py:24-190 (that module imports
jax; `topk_best_loci` is not copied):
- `assign_multihits`: reads with 2..MaxMulti equally-best hits go to the
  candidate locus best supported by nearby uniquely aligned reads, the
  role of the reference's AssignMultiMatches (biokanga/Aligner.cpp:5109);
- `adaptive_trim`, `adaptive_trim_batch` and `chimeric_pass` (`align -C`):
  AdaptiveTrim chimeric acceptance (libbiokanga/SfxArrayV2.cpp:5482,
  consts SfxArrayV2.h:53-60): unaccepted reads are flank-trimmed at their
  best candidate locus to the longest window with at most 15 mismatches
  per 100bp of trimmed length, at least 25bp after trimming, and at
  least one exact run of 8; accepted chimerics report soft-clipped
  CIGARs.
"""
from __future__ import annotations

import numpy as np

from ..seq.encode import revcomp

# AdaptiveTrim constants (SfxArrayV2.h:53-60)
C_MIN_AT_SEQ_LEN = 25
C_MIN_AT_TRIMMED_LEN = 15
C_MAX_AT_MM_PER100 = 15
C_MIN_AT_EXACT_LEN = 8


def assign_multihits(
    unique_loci: np.ndarray,        # loci of uniquely-accepted reads
    unique_lens: np.ndarray,
    multi_cand_loci: np.ndarray,    # (M, K) candidate loci (-1 pad)
    genome_len: int,
    window: int = 500,
):
    """Assign each multi-hit read to the candidate with the most unique-
    read coverage support within +-window; ties/zero support stay
    unassigned. Returns (assigned_locus (M,), assigned mask)."""
    cov = np.zeros(genome_len + 1, np.int64)
    a = np.clip(np.asarray(unique_loci, np.int64), 0, genome_len)
    b = np.clip(a + np.asarray(unique_lens, np.int64), 0, genome_len)
    np.add.at(cov, a, 1)
    np.add.at(cov, b, -1)
    cov = np.cumsum(cov)[:genome_len]
    cs = np.concatenate([[0], np.cumsum(cov)])

    M, K = multi_cand_loci.shape
    loci = np.asarray(multi_cand_loci, np.int64)
    lo = np.clip(loci - window, 0, genome_len)
    hi = np.clip(loci + window, 0, genome_len)
    scores = np.where(loci >= 0, cs[hi] - cs[lo], -1)
    top = scores.max(axis=1)
    n_top = (scores == top[:, None]).sum(axis=1)
    ok = (top > 0) & (n_top == 1)
    pick = scores.argmax(axis=1)
    assigned = np.where(ok, loci[np.arange(M), pick], -1)
    return assigned, ok


def adaptive_trim(
    mism: np.ndarray,    # (L,) int mismatch indicators at the best locus
    L: int,
):
    """Find the best flank-trim window per the reference's AdaptiveTrim
    rules. Returns (start, end) of the accepted window or None.
    (Scalar wrapper over adaptive_trim_batch.)"""
    s, e, ok = adaptive_trim_batch(
        np.asarray(mism[:L], np.int64)[None, :], np.asarray([L])
    )
    return (int(s[0]), int(e[0])) if ok[0] else None


def adaptive_trim_batch(mism: np.ndarray, lens: np.ndarray):
    """Vectorised AdaptiveTrim over a (k, L) mismatch-indicator batch:
    per row, the LONGEST window with <= 15 mismatches/100bp of window
    length, >= 15 bases, and at least one exact run of 8 inside
    (SfxArrayV2.h:53-60 rules; earliest start wins at equal length).
    Returns (start (k,), end (k,), found (k,))."""
    k, L = mism.shape
    cs = np.concatenate([np.zeros((k, 1), np.int64),
                         np.cumsum(mism, axis=1)], axis=1)
    # run length of exact matches ending at p, then prefix count of
    # positions with run >= C_MIN_AT_EXACT_LEN
    idx = np.arange(L)[None, :]
    last_mm = np.maximum.accumulate(np.where(mism != 0, idx, -1), axis=1)
    rl = idx - last_mm
    m8 = np.concatenate([np.zeros((k, 1), np.int64),
                         np.cumsum(rl >= C_MIN_AT_EXACT_LEN, axis=1)],
                        axis=1)
    start = np.zeros(k, np.int64)
    end = np.zeros(k, np.int64)
    found = np.zeros(k, bool)
    for wl in range(L, C_MIN_AT_TRIMMED_LEN - 1, -1):
        live = ~found & (lens >= wl)
        if not live.any():
            if found.all():
                break
            continue
        allowed = (wl * C_MAX_AT_MM_PER100) // 100
        smax = lens - wl  # starts 0..smax inclusive
        s_idx = np.arange(L)[None, :]
        valid_s = s_idx <= smax[:, None]
        mmw = cs[:, wl : L + 1] - cs[:, : L - wl + 1]
        # exact run of 8 inside [s, s+wl): exists p in [s+7, s+wl-1]
        # with rl[p] >= 8  <=>  m8[s+wl] - m8[s+7] > 0
        run_ok = (m8[:, wl : wl + L - wl + 1]
                  - m8[:, np.minimum(C_MIN_AT_EXACT_LEN - 1 + np.arange(L - wl + 1), L)]) > 0
        ok = (mmw <= allowed) & run_ok & valid_s[:, : L - wl + 1]
        ok &= live[:, None]
        has = ok.any(axis=1)
        s0 = np.argmax(ok, axis=1)
        start[has] = s0[has]
        end[has] = s0[has] + wl
        found |= has
    return start, end, found


def chimeric_pass(
    genome: np.ndarray, reads: np.ndarray, lengths: np.ndarray, res: dict,
    min_chimeric_pct: int = 50,
):
    """Re-examine reads with no accepted hit: trim flanks at the best
    candidate locus; accept when the trimmed window meets AdaptiveTrim
    rules and covers >= min_chimeric_pct% of the read.

    `genome`: the index's host codes (GenomeIndex.codes), the array the
    JAX package fetches from its device index on every call.
    Mutates `res`, adding soft-clip fields: res['clip5'], res['clip3'].
    """
    B, L = reads.shape
    res.setdefault("clip5", np.zeros(B, np.int32))
    res.setdefault("clip3", np.zeros(B, np.int32))
    # candidates existed (best_mm < 255) but the full-length alignment was
    # not accepted — exactly the chimeric situation (junk flank pushes the
    # whole-read mismatch count over budget)
    n = len(genome)
    left = np.nonzero(
        ~res["unique"] & (res["best_mm"] < 255)
        & (res["locus"] >= 0) & (res["locus"] + L <= n)
    )[0]
    if len(left) == 0:
        return res
    # vectorised mismatch indicators at the best candidate locus
    loc = res["locus"][left].astype(np.int64)
    ln = lengths[left].astype(np.int64)
    win = genome[loc[:, None] + np.arange(L)]
    seq = reads[left].copy()
    rc = res["is_rc"][left]
    for j in np.nonzero(rc)[0]:  # rc rows only
        seq[j, : ln[j]] = revcomp(reads[left[j], : ln[j]])
    live = np.arange(L)[None, :] < ln[:, None]
    mism = (((win != seq) | (win >= 4) | (seq >= 4)) & live).astype(
        np.int64
    )
    mism |= ~live  # pad counts as mismatch so windows stay inside the read
    s, e, found = adaptive_trim_batch(mism, ln)
    wl = e - s
    acc = found & (wl * 100 >= min_chimeric_pct * ln) & (
        wl >= C_MIN_AT_SEQ_LEN
    )
    rows = left[acc]
    cs = np.concatenate([np.zeros((len(left), 1), np.int64),
                         np.cumsum(mism, axis=1)], axis=1)
    mmw = cs[np.arange(len(left)), e] - cs[np.arange(len(left)), s]
    res["unique"][rows] = True
    res["locus"][rows] = res["locus"][rows] + s[acc]
    res["best_mm"][rows] = np.minimum(mmw[acc], 255).astype(
        res["best_mm"].dtype
    )
    res["clip5"][rows] = s[acc].astype(np.int32)
    res["clip3"][rows] = (ln[acc] - e[acc]).astype(np.int32)
    return res
