"""Copy of biokanga_tpu/align/longread.py: long reads, segment + stitch.

Capability match for the reference's 256 Kbp read envelope
(cMaxReadLen, libbiokanga/commdefs.h:158-161).  A read longer than a
segment is cut into SEG_LEN-base segments, which align through the
unmodified engine (the packed extension, kernel #3 on the card); under
the Hamming model (no indels) every segment of a true alignment lands on
one diagonal (locus - segment offset), so the read's locus is the
majority diagonal of its uniquely placed segments, verified by counting
every segment's mismatches at that one locus (`hamming_extend_packed`
with one candidate a segment).

Acceptance reproduces the reference budget: MaxTotMM = min(63,
subs_per_100bp-scaled) for any read length (cMaxTotAllowedSubs,
biokanga/Aligner.h:23, Aligner.cpp:9084-9090).  Strand is handled at the
long-read level (segments of the read, then of its reverse complement).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..ops.extend_packed import hamming_extend_packed, pack_reads
from .pipeline import AlignEngine, pad_rows

SEG_LEN = 1024
MIN_SEG = 64          # ignore ragged tails shorter than this
SEG_BATCH = 4096      # segments an engine batch
VERIFY_ROWS = 8192    # segments a verification call


def _segment(reads: np.ndarray, lengths: np.ndarray, seg: int):
    """(B, L) -> (B*S, seg) row-major segments + per-segment lengths."""
    B, L = reads.shape
    S = -(-L // seg)
    padL = S * seg
    m = np.full((B, padL), 4, reads.dtype)
    m[:, :L] = reads
    segs = m.reshape(B * S, seg)
    offs = np.tile(np.arange(S, dtype=np.int64) * seg, B)
    seg_len = np.clip(lengths.astype(np.int64)[:, None]
                      - np.arange(S, dtype=np.int64)[None, :] * seg,
                      0, seg).reshape(-1)
    return segs, seg_len.astype(np.int32), offs, S


class LongReadAligner:
    """Aligns reads of any length (up to the reference's 256 Kbp
    envelope) against an AlignEngine's index, on the index's device."""

    def __init__(self, engine: AlignEngine, seg: int = SEG_LEN):
        self.didx = engine.didx
        self.seg = seg
        self.params = engine.params
        self.engine = AlignEngine(engine.didx,
                                  replace(engine.params, strand="sense"))

    def _align_segments(self, segs, seg_lens):
        blocks = (pad_rows(segs[i: i + SEG_BATCH], seg_lens[i: i + SEG_BATCH])
                  for i in range(0, len(segs), SEG_BATCH))
        out = list(self.engine.align_stream(blocks))
        return {k: np.concatenate([o[k] for o in out])[: len(segs)]
                for k in ("unique", "best_mm", "locus", "any_hit")}

    def _verify_at(self, segs, seg_lens, loci):
        """Mismatch count of each segment at one fixed locus."""
        didx = self.didx
        dev = didx.device
        out = np.empty(len(segs), np.int64)
        for i in range(0, len(segs), VERIFY_ROWS):
            s = torch.from_numpy(np.ascontiguousarray(
                segs[i: i + VERIFY_ROWS], np.int8)).to(dev)
            sl = torch.from_numpy(np.ascontiguousarray(
                seg_lens[i: i + VERIFY_ROWS], np.int32)).to(dev)
            lo = torch.from_numpy(np.ascontiguousarray(
                loci[i: i + VERIFY_ROWS], np.int32)).to(dev)[:, None]
            rcodes, rnlane = pack_reads(s, sl)
            mm = hamming_extend_packed(
                didx.packed, didx.entry_starts, lo,
                torch.ones_like(lo, dtype=torch.bool), rcodes, rnlane, sl)
            out[i: i + VERIFY_ROWS] = mm[:, 0].cpu().numpy()
        return out

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        """Returns per-read dict: unique, locus, is_rc, best_mm."""
        B, L = reads.shape
        if self.params.max_subs_per100 == 0:
            budget = np.zeros(B, np.int64)
        else:
            budget = np.minimum(
                np.floor(lengths * self.params.max_subs_per100 / 100.0
                         + 0.5).astype(np.int64),
                63,
            )

        out = {
            "unique": np.zeros(B, bool),
            "locus": np.full(B, -1, np.int64),
            "is_rc": np.zeros(B, bool),
            "best_mm": np.full(B, 1 << 30, np.int64),
        }
        for is_rc in (False, True):
            if is_rc:
                # per-row reverse complement rolled left to the row start,
                # the tail past each read's length masked to N
                flipped = reads[:, ::-1]
                rc = np.where(flipped >= 4, flipped,
                              3 - flipped).astype(reads.dtype)
                col = ((np.arange(L, dtype=np.int64)[None, :]
                        + (L - lengths.astype(np.int64))[:, None]) % L)
                cur = rc[np.arange(B)[:, None], col]
                cur[np.arange(L)[None, :] >= lengths[:, None]] = 4
            else:
                cur = reads
            segs, seg_lens, offs, S = _segment(cur, lengths, self.seg)
            res = self._align_segments(segs, seg_lens)
            valid = (seg_lens >= MIN_SEG)
            diag = np.where(res["unique"] & valid,
                            res["locus"].astype(np.int64) - offs, -1)
            # per-read majority diagonal: sort each row, run-length the
            # equal runs, take the longest run
            sd = np.sort(diag.reshape(B, S), axis=1)   # -1s sort first
            new = np.ones((B, S), bool)
            new[:, 1:] = sd[:, 1:] != sd[:, :-1]
            pos = np.arange(S, dtype=np.int64)
            run_start = np.maximum.accumulate(
                np.where(new, pos[None, :], 0), axis=1)
            run_len = np.where(sd >= 0, pos[None, :] - run_start + 1, 0)
            best_pos = np.argmax(run_len, axis=1)      # end of longest run
            votes = run_len[np.arange(B), best_pos]
            d_star = sd[np.arange(B), best_pos]
            nv = valid.reshape(B, S).sum(axis=1)
            cand = (votes > 0) & (nv > 0) & (votes * 2 >= nv)
            if not cand.any():
                continue
            # one batched verification over every valid segment of every
            # candidate read at its majority diagonal
            valid_m = valid.reshape(B, S)
            bsel, ssel = np.nonzero(valid_m & cand[:, None])
            rows = bsel * S + ssel
            mm = self._verify_at(segs[rows], seg_lens[rows],
                                 d_star[bsel] + offs[rows])
            total = np.zeros(B, np.int64)
            np.add.at(total, bsel, mm)
            acc = cand & (total <= budget) & (total < out["best_mm"])
            out["unique"][acc] = True
            out["locus"][acc] = d_star[acc]
            out["is_rc"][acc] = is_rc
            out["best_mm"][acc] = total[acc]
        out["best_mm"][~out["unique"]] = -1
        return out
