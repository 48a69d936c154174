"""Paired-end pairing + orphan rescue.

Counterpart of biokanga_tpu/align/pe.py (capability match for
CAligner::ProcessPairedEnds, biokanga/Aligner.cpp:2876,3055, and
CSfxArrayV3::AlignPairedRead orphan rescue,
libbiokanga/SfxArrayV2.cpp:8247).  Defaults mirror the reference CLI:
insert size 100..1000 (cDfltPairMinLen/cDfltPairMaxLen, Aligner.h:71-72),
FR orientation unless pair_same_strand.

Design: both mates run through the SE engine as one fused 2N-row batch
(where their widths agree, else one after the other); pairing
classification is a vectorised numpy pass on the host; orphan rescue
re-extends the unanchored mate against every locus of the anchor's
insert window with the same packed Hamming extension kernel the engine
uses (ops/extend_packed.hamming_extend_packed), as one device call per
mate side and engine holding anchors: the one engine of a single index,
or each anchor chunk's engine of a chunked one.  `PEParams`,
`_insert_len` and `classify_pairs` are copied (numpy); the JAX package's
jitted `_rescue_fn` is `rescue_window` here, a plain function on tensors
on the engine's device: its jit cache and its arrays-as-arguments are
TPU workarounds and stay behind.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.device import DeviceIndex
from ..ops.extend_packed import hamming_extend_packed, pack_reads
from ..utils.trace import count, span
from .pipeline import AlignEngine

C_DFLT_PAIR_MIN_LEN = 100   # Aligner.h:71
C_DFLT_PAIR_MAX_LEN = 1000  # Aligner.h:72

# orphans per rescue call on a CPU engine: the extension's plain version
# materialises (rows, window, words) int64 temporaries; rows are
# independent, so chunking changes no result
CPU_RESCUE_ROWS = 256


@dataclass(frozen=True)
class PEParams:
    pair_min_len: int = C_DFLT_PAIR_MIN_LEN
    pair_max_len: int = C_DFLT_PAIR_MAX_LEN
    pair_same_strand: bool = False  # -E: accept mates on the same strand
    rescue: bool = True


def _insert_len(loc1, len1, rc1, loc2, len2):
    """Observed insert = span from leftmost start to rightmost end."""
    lo = np.minimum(loc1, loc2)
    hi = np.maximum(loc1 + len1, loc2 + len2)
    return hi - lo


def classify_pairs(
    res1: dict, res2: dict,
    len1: np.ndarray, len2: np.ndarray,
    entry_starts: np.ndarray,
    pe: PEParams,
):
    """Vectorised pair classification over per-mate SE results.

    Returns dict with:
      proper   (N,) bool — both unique, orientation + insert accepted
      orphan1  (N,) bool — mate1 unique anchor, mate2 unaccepted
      orphan2  (N,) bool — mate2 unique anchor, mate1 unaccepted
    """
    u1, u2 = res1["unique"], res2["unique"]
    loc1, loc2 = res1["locus"], res2["locus"]
    rc1, rc2 = res1["is_rc"], res2["is_rc"]

    ent1 = np.searchsorted(entry_starts, loc1, side="right") - 1
    ent2 = np.searchsorted(entry_starts, loc2, side="right") - 1
    same_chrom = ent1 == ent2

    if pe.pair_same_strand:
        orient_ok = rc1 == rc2
    else:
        # FR: mates on opposite strands, forward mate upstream
        fwd_first = (~rc1) & rc2 & (loc1 <= loc2)
        rev_first = rc1 & (~rc2) & (loc2 <= loc1)
        orient_ok = fwd_first | rev_first

    ins = _insert_len(loc1, len1, rc1, loc2, len2)
    ins_ok = (ins >= pe.pair_min_len) & (ins <= pe.pair_max_len)

    proper = u1 & u2 & same_chrom & orient_ok & ins_ok
    orphan1 = u1 & (~u2)
    orphan2 = u2 & (~u1)
    return {
        "proper": proper,
        "orphan1": orphan1,
        "orphan2": orphan2,
        "insert": ins,
    }


def rescue_window(didx: DeviceIndex, win_start: torch.Tensor,
                  reads: torch.Tensor, lengths: torch.Tensor,
                  max_tot_mm: torch.Tensor, Wlen: int) -> dict:
    """Extend each read against every locus of [win_start, win_start +
    Wlen) and accept it where exactly one locus has the least mismatch
    count and that count is within the read's budget.

    win_start, lengths, max_tot_mm: (B,) int32; reads: (B, L) int8, all on
    the index's device.  Loci below 0, past the genome's end or across an
    entry boundary count MM_INVALID (255), which is a value of the
    minimum: a window with no valid locus is never accepted.  Returns
    device tensors ok (B,) bool, locus (B,) int32, mm (B,) int32.
    """
    B = reads.shape[0]
    dev = reads.device
    col = torch.arange(Wlen, dtype=torch.int32, device=dev)
    loci = win_start[:, None] + col[None, :]
    valid = torch.ones((B, Wlen), dtype=torch.bool, device=dev)
    rcodes, rnlane = pack_reads(reads, lengths)
    mm = hamming_extend_packed(didx.packed, didx.entry_starts, loci, valid,
                               rcodes, rnlane, lengths).to(torch.int32)
    best = mm.min(dim=1).values
    is_best = mm == best[:, None]
    inst = is_best.sum(dim=1, dtype=torch.int32)
    # first column of the minimum, by comparison and not by argmin's tie rule
    bi = torch.where(is_best, col[None, :], Wlen).min(dim=1).values
    ok = (best <= max_tot_mm) & (inst == 1)
    return {"ok": ok, "locus": win_start + bi.to(torch.int32), "mm": best}


def _orient_mates(mate_reads: np.ndarray, ml: np.ndarray,
                  flip: np.ndarray) -> np.ndarray:
    """Copy of the rows with the first ml[i] bases of each row where
    flip[i] reverse-complemented; padding past the length stays."""
    L = mate_reads.shape[1]
    j = np.arange(L)[None, :]
    inside = j < ml[:, None]
    src = np.clip(ml[:, None].astype(np.int64) - 1 - j, 0, max(L - 1, 0))
    rev = np.take_along_axis(mate_reads, src, axis=1)
    rc = np.where(rev >= 4, rev, 3 - rev).astype(mate_reads.dtype)
    return np.where(flip[:, None] & inside, rc, mate_reads)


class PEAligner:
    """Runs both mates through an aligner and pairs the results.

    The aligner is an `AlignEngine` or a chunked one
    (parallel/chunked.ChunkedAligner); of it the pairing uses `stack`,
    `launch_primary`/`finish_primary` (the host `align_with_rescue`
    result, global loci), `params`, `entry_starts_host()` and
    `engines_of(loci)`, the engines whose indexes hold the anchors."""

    def __init__(self, aligner, pe: PEParams | None = None):
        self.engine = aligner
        self.pe = pe or PEParams()
        self.rescue_calls = 0       # rescue_window calls
        self.rescued = 0            # mates accepted by the rescue

    def rescue(self, engine: AlignEngine, anchor_loc, anchor_rc, anchor_len,
               mate_reads, mate_lengths):
        """Rescue unanchored mates within the anchor's insert window, on
        `engine`'s index (anchor loci local to it).

        The mate is searched on the strand opposite the anchor (FR), i.e.
        we extend either the mate as given or its revcomp; the caller
        passes the correctly-oriented sequence in mate_reads.
        Window: if anchor is forward, mate must start within
        [anchor, anchor + pair_max_len - mate_len]; if anchor is reverse,
        within [anchor_end - pair_max_len, anchor_end - mate_len].  The
        window's width is set by the shortest mate of this call.
        """
        pe = self.pe
        B = mate_reads.shape[0]
        Wlen = pe.pair_max_len - int(mate_lengths.min())
        Wlen = max(8, Wlen)
        fwd = ~anchor_rc
        win_start = np.where(
            fwd,
            anchor_loc,
            anchor_loc + anchor_len - pe.pair_max_len,
        ).astype(np.int32)
        ap = engine.params
        if ap.max_subs_per100 == 0:
            mtm = np.zeros(B, np.int32)
        else:
            mtm = np.clip(
                np.floor(mate_lengths * ap.max_subs_per100 / 100.0 + 0.5),
                1, 63,
            ).astype(np.int32)
        didx = engine.didx
        dev = didx.device
        step = CPU_RESCUE_ROWS if dev.type == "cpu" else B
        parts = []
        for s in range(0, B, step):
            args = [torch.from_numpy(np.ascontiguousarray(a[s:s + step], t))
                    .to(dev) for a, t in ((win_start, np.int32),
                                          (mate_reads, np.int8),
                                          (mate_lengths, np.int32),
                                          (mtm, np.int32))]
            parts.append(rescue_window(didx, *args, Wlen))
            self.rescue_calls += 1
        return {k: torch.cat([p[k] for p in parts]).cpu().numpy()
                for k in parts[0]}

    def launch_pairs(self, reads1, len1, reads2, len2):
        """Enqueue both mates' primary align, as one fused 2N-row batch
        where their shapes agree, else one after the other; pair with
        finish_pairs.  Lets a caller keep one PE batch in flight on the
        device while it classifies, rescues and writes the previous one
        on the host."""
        eng = self.engine
        with span("pe.launch"):
            if reads1.shape == reads2.shape:
                states = (eng.launch_primary(eng.stack([reads1, reads2]),
                                             eng.stack([len1, len2])),)
            else:
                states = (eng.launch_primary(reads1, len1),
                          eng.launch_primary(reads2, len2))
        return (states, reads1, len1, reads2, len2)

    def finish_pairs(self, pending):
        """Resolve a launch_pairs handle: two-level completion + overflow
        rescue + pairing + orphan rescue (host side)."""
        states, reads1, len1, reads2, len2 = pending
        with span("pe.finish"):
            res = [self.engine.finish_primary(s) for s in states]
        if len(res) == 1:
            # per-mate views of the fused result (the rescue writes
            # through them)
            N = len(reads1)
            res = [{k: (v[s] if hasattr(v, "__len__") else v)
                    for k, v in res[0].items()}
                   for s in (slice(None, N), slice(N, None))]
        return self._pair_and_rescue(*res, reads1, len1, reads2, len2)

    def align_pairs(self, reads1, len1, reads2, len2):
        """Full PE path. reads*: (N, L) int8. Returns a result dict with
        per-pair fields; loci for rescued mates filled in."""
        return self.finish_pairs(self.launch_pairs(reads1, len1, reads2,
                                                   len2))

    def _pair_and_rescue(self, res1, res2, reads1, len1, reads2, len2):
        starts = self.engine.entry_starts_host()
        with span("pe.classify"):
            cls = classify_pairs(res1, res2, len1, len2, starts, self.pe)
        if not self.pe.rescue:
            return {"res1": res1, "res2": res2, **cls}

        with span("pe.rescue"):
            for anch, a_len, mate_reads, mate_len, mres, orph in (
                    (res1, len1, reads2, len2, res2, cls["orphan1"]),
                    (res2, len2, reads1, len1, res1, cls["orphan2"])):
                orphans = np.nonzero(orph)[0]
                if len(orphans) == 0:
                    continue
                # one rescue call an engine holding anchors: the window
                # width comes from each call's shortest mate
                for at, engine, base in self.engine.engines_of(
                        anch["locus"][orphans]):
                    rows = orphans[at]
                    a_loc = (anch["locus"][rows] - base).astype(np.int32)
                    a_rc = anch["is_rc"][rows]
                    # FR: mate aligns on strand opposite the anchor;
                    # orient the mate sequence so a forward window scan
                    # matches it (anchor forward => mate hits reverse
                    # strand: scan rc)
                    ml = mate_len[rows]
                    m = _orient_mates(mate_reads[rows], ml, ~a_rc)
                    out = self.rescue(engine, a_loc, a_rc, a_len[rows], m,
                                      ml)
                    ok = out["ok"]
                    # write back: rescued mate becomes an accepted hit;
                    # inst, next_mm, any_hit and ml_* keep the SE pass's
                    # values, as in the JAX package
                    mres["unique"][rows[ok]] = True
                    mres["locus"][rows[ok]] = (
                        out["locus"][ok].astype(np.int64) + base)
                    mres["is_rc"][rows[ok]] = ~a_rc[ok]
                    mres["best_mm"][rows[ok]] = out["mm"][ok]
                    n = int(ok.sum())
                    self.rescued += n
                    count("pe.rescue_mates", len(rows))
                    count("pe.rescued_mates", n)
        # reclassify with rescued mates
        with span("pe.classify"):
            cls = classify_pairs(res1, res2, len1, len2, starts, self.pe)
        return {"res1": res1, "res2": res2, **cls}
