"""The aligner pipeline: seed -> candidates -> Hamming extend -> accept.

Counterpart of biokanga_tpu/align/pipeline.py for the single-end path.
`align_core` runs the five device stages on one batch of reads:

  1. pack the seed cores of both strands (ops/lookup.pack_read_kmers)
  2. look up their suffix-array ranges (ops/lookup.seed_range_lookup)
  3. gather up to H loci per core and dedup diagonals with the row sort
     kernel (ops/sort.sort_rows)
  4. count packed Hamming mismatches with the extension kernel
     (ops/extend_packed.hamming_extend_packed), or, for an index without
     packed rows or reads past MAX_PACKED_READ_LEN bases, on the dense
     path (ops/extend.hamming_extend)
  5. accept hits through one two-key row sort (ops/sort.sort2_rows)

`AlignEngine` drives it from the host exactly as the JAX engine does:
a two-level fast pass, a classic rerun of unresolved reads, and the
two-step rescue ladder; chunk sweeps (parallel/chunked.py) take the fast
pass alone (`launch_fast`).  The TPU workarounds of the JAX version (row
gathers with static selects, the (C, B) layout, 2-bit upload packing,
the `uniform` flag and the streaming-extension switch) are left out;
each is replaced by the general form that gives the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import I32_MAX
from ..index.device import DeviceIndex
from ..ops.extend import hamming_extend
from ..ops.extend_packed import (
    MAX_PACKED_READ_LEN,
    MM_INVALID,
    hamming_extend_packed,
    pack_reads,
)
from ..ops.lookup import pack_read_kmers, seed_range_lookup
from ..ops.sort import sort2_rows, sort_rows
from ..utils.trace import count, span
from .params import AlignParams, DerivedParams

# candidate diagonals a strand gives the indel and splice scans: the
# lowest of its sorted seed diagonals (biokanga_tpu/align/pipeline.py:790,
# the splice_cand_cap default, which no caller changes)
SPLICE_CAND_CAP = 24


def _rc_reads(reads: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement keeping padding at the tail."""
    L = reads.shape[1]
    flipped = reads.flip(1)
    rc = torch.where(flipped >= 4, flipped, 3 - flipped).to(reads.dtype)
    # rc has (L - len) pad codes at the front; roll left per read
    col = (torch.arange(L, device=reads.device)[None, :]
           + (L - lengths.to(torch.int64))[:, None]) % L
    return torch.gather(rc, 1, col)


def _strand_candidates(didx: DeviceIndex, seq: torch.Tensor,
                       dp: DerivedParams, H: int, cand_cap: int, owned=None,
                       occ_skip: bool = False):
    """Candidate loci for one strand: (B, C) int32 loci + validity, with
    C = min(cand_cap, S*H), the per-read count of skipped cores and the
    cap-truncation flag.

    Pack cores -> LUT / binary-search range -> read up to H sorted
    positions per core -> diagonal dedup (row sort + neighbour mask) ->
    keep the first cand_cap columns (INT32_MAX sentinels sort last).

    `occ_skip`: a core whose range exceeds H gives no candidates and is
    counted in n_over (biokanga_tpu/align/pipeline.py:116-126 states the
    rule); without it the range is cut to its first H positions and the
    read is flagged truncated.  `owned`: alignments must start below it.
    """
    S = len(dp.offsets)
    B = seq.shape[0]
    dev = seq.device
    qlh, qll, qhh, qhl, has_n = pack_read_kmers(seq, dp.offsets, dp.core_len)
    start, end = seed_range_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases, qlh, qll, qhh,
        qhl, core_len=dp.core_len, max_steps=didx.max_bsearch_steps,
    )
    size = end - start
    # N-containing cores give junk ranges; they never count as over-occurring
    overflow = (size > H) & ~has_n
    if occ_skip:
        size = torch.where(overflow, 0, size)
    j = torch.arange(H, device=dev)
    slot = torch.clamp(start[..., None] + j, max=didx.pos_sorted.shape[0] - 1)
    pos = didx.pos_sorted[slot]                                # (B, S, H)
    in_range = j < torch.clamp(size, max=H)[..., None]
    offs = torch.as_tensor(dp.offsets, dtype=torch.int32, device=dev)
    diag = pos - offs[None, :, None]
    valid = in_range & ~has_n[..., None] & (diag >= 0)
    if owned is not None:
        valid = valid & (diag < owned)

    flat = torch.where(valid, diag, I32_MAX).reshape(B, S * H)
    # diagonal dedup: one locus found through several cores is one hit
    srt = sort_rows(flat)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                     srt[:, 1:] == srt[:, :-1]], dim=1)
    v = (srt != I32_MAX) & ~dup
    C = min(cand_cap, S * H)
    if C < S * H:
        trunc = v[:, C:].any(dim=1)
        srt, v = srt[:, :C], v[:, :C]
    else:
        trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    if occ_skip:
        # skipped cores weaken the pigeonhole bound (inexact_rows)
        n_over = overflow.sum(dim=1, dtype=torch.int32)
    else:
        n_over = torch.zeros(B, dtype=torch.int32, device=dev)
        trunc = trunc | overflow.any(dim=1)
    return srt, v, n_over, trunc


def mismatch_budget(lengths: torch.Tensor, ap: AlignParams) -> torch.Tensor:
    """Per-read mismatch budget from the actual read length, in float32 as
    the JAX package computes it (float64 rounds differently at x.5)."""
    if ap.max_subs_per100 == 0:
        return torch.zeros_like(lengths)
    rate = torch.tensor(ap.max_subs_per100 / 100.0, dtype=torch.float32,
                        device=lengths.device)
    return torch.clamp(torch.floor(lengths.to(torch.float32) * rate + 0.5).to(
        torch.int32), 1, 63)


def align_core(didx: DeviceIndex, reads: torch.Tensor, lengths: torch.Tensor,
               *, ap: AlignParams, dp: DerivedParams, H: int, cand_cap: int,
               strand: str, occ_skip: bool = True) -> dict:
    """One batch through the five device stages; returns device tensors
    keyed as the JAX align_core's result (RESULT_KEYS + ladder keys)."""
    dev = reads.device
    max_tot_mm = mismatch_budget(lengths, ap)
    strands = []                      # sense columns first (rc_col below)
    if strand in ("both", "sense"):
        strands.append(reads)
    if strand in ("both", "antisense"):
        strands.append(_rc_reads(reads, lengths))

    use_packed = (didx.packed is not None
                  and reads.shape[1] <= MAX_PACKED_READ_LEN)
    loci_parts, mm_parts = [], []
    n_over = trunc = None
    for seq in strands:
        loci, vmask, s_over, s_trunc = _strand_candidates(
            didx, seq, dp, H, cand_cap, didx.owned, occ_skip=occ_skip)
        if use_packed:
            count("extend.slots", vmask.numel())
            count("extend.valid_slots", vmask)
            rcodes, rnlane = pack_reads(seq, lengths)
            mm = hamming_extend_packed(didx.packed, didx.entry_starts, loci,
                                       vmask, rcodes, rnlane, lengths)
        else:
            mm = hamming_extend(didx.genome, didx.entry_starts, loci, vmask,
                                seq, lengths)
        loci_parts.append(loci)
        mm_parts.append(mm)
        # a hidden hit lives on one strand: the worst single strand counts
        n_over = s_over if n_over is None else torch.maximum(n_over, s_over)
        trunc = s_trunc if trunc is None else (trunc | s_trunc)

    loci_all = torch.cat(loci_parts, dim=1)
    mm_all = torch.cat(mm_parts, dim=1).to(torch.int32)
    C1 = loci_parts[0].shape[1]

    # one two-key sort by (mm*2 | rc, locus): column 0 is the best hit,
    # column 1 the next best, columns 0..K-1 the multi-hit loci; rc in the
    # key's low bit puts sense before antisense at equal mm
    K = max(1, ap.max_multi)
    Ctot = mm_all.shape[1]
    if strand == "both":
        rc_col = (torch.arange(Ctot, device=dev) >= C1).to(torch.int32)
    else:
        rc_col = torch.full((Ctot,), int(strand == "antisense"),
                            dtype=torch.int32, device=dev)
    key = mm_all * 2 + rc_col[None, :]
    s_key, s_loci = sort2_rows(key, loci_all)
    best = s_key[:, 0] >> 1
    is_rc_hit = (s_key[:, 0] & 1).to(torch.bool)
    locus = s_loci[:, 0]
    next_mm = s_key[:, 1] >> 1
    inst = (mm_all == best[:, None]).sum(dim=1, dtype=torch.int32)
    any_hit = best <= max_tot_mm
    unique = any_hit & ((next_mm - best) >= ap.min_edit_dist)
    # next_mm is canonical only up to the accept margin: saturate it
    next_sat = torch.minimum(next_mm, best + ap.min_edit_dist)
    # ml_* columns are valid hits only; the rest is (-1, 255, False)
    ml_mm_rows = s_key[:, :K] >> 1
    ml_ok = ml_mm_rows <= max_tot_mm[:, None]
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": torch.clamp(best, max=MM_INVALID).to(torch.uint8),
        "next_mm": torch.clamp(next_sat, max=MM_INVALID).to(torch.uint8),
        "inst": inst,
        "locus": locus,
        "is_rc": is_rc_hit,
        "overflow": (n_over > 0) | trunc,
        "n_over": n_over,
        "cap_trunc": trunc,
        "ml_loci": torch.where(ml_ok, s_loci[:, :K], -1),
        "ml_mm": torch.where(ml_ok, torch.clamp(ml_mm_rows, max=255),
                             255).to(torch.uint8),
        "ml_rc": ml_ok & ((s_key[:, :K] & 1) != 0),
    }


def _to_host(out: dict, dp: DerivedParams) -> dict:
    """A launch's device tensors as a host result dict."""
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["derived"] = dp
    return res


class AlignEngine:
    """Runs batch alignment of host reads against one DeviceIndex."""

    def __init__(self, didx: DeviceIndex, params: AlignParams | None = None):
        self.didx = didx
        self.params = params or AlignParams()

    def launch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
               cand_cap=None, dp=None, occ_skip: bool = True):
        """Upload one batch and enqueue its alignment; returns (dict of
        device tensors, dp).  Nothing waits for the device here."""
        B, L = reads.shape
        if dp is None:
            dp = self.params.derive(int(L), self.didx.total_len)
        if (self.didx.key_hi.shape[0] == 1
                and dp.core_len > self.didx.lut_bases):
            raise ValueError(
                f"LUT-only index cannot serve core_len {dp.core_len} > "
                f"lut_bases {self.didx.lut_bases}")
        H = int(H or self.params.cand_per_core)
        if cand_cap is None:
            cand_cap = self.params.max_cand_per_strand
        dev = self.didx.device
        with span("engine.upload"):
            r = torch.from_numpy(np.ascontiguousarray(reads, np.int8)).to(dev)
            ln = torch.from_numpy(np.ascontiguousarray(lengths,
                                                       np.int32)).to(dev)
        with span("engine.enqueue"):
            out = align_core(self.didx, r, ln, ap=self.params, dp=dp, H=H,
                             cand_cap=int(cand_cap),
                             strand=self.params.strand, occ_skip=occ_skip)
        return out, dp

    def align_batch(self, reads: np.ndarray, lengths: np.ndarray, H=None,
                    cand_cap=None, dp=None, occ_skip: bool = True) -> dict:
        """reads: (B, L) int8 host array.  Returns host-side result dict."""
        out, dp = self.launch(reads, lengths, H=H, cand_cap=cand_cap, dp=dp,
                              occ_skip=occ_skip)
        return _to_host(out, dp)

    def _fast_params(self, reads):
        """FastPassParams for this batch shape, or None (also for an index
        without packed rows, as in the JAX engine)."""
        if self.didx.packed is None:
            return None
        return self.params.derive_fast(
            int(reads.shape[1]), self.didx.total_len, self.didx.lut_bases)

    def launch_primary(self, reads: np.ndarray, lengths: np.ndarray):
        """Enqueue the primary pass (two-level fast pass when available,
        classic otherwise).  Pair with finish_primary."""
        count("engine.rows", len(reads))
        fp = self._fast_params(reads)
        if fp is None:
            out, dp = self.launch(reads, lengths)
        else:
            out, dp = self.launch(reads, lengths, H=fp.H,
                                  cand_cap=fp.cand_cap, dp=fp.dp)
        return (reads, lengths, out, dp, fp)

    def finish_primary(self, state) -> dict:
        """Fetch a launch_primary result and complete it to the full
        align_with_rescue semantics: rerun fast-pass-unresolved reads
        through the classic pass, then the rescue ladder."""
        reads, lengths, out, dp, fp = state
        with span("engine.fetch"):
            res = _to_host(out, dp)
        if fp is None:
            self.rescue_pass(reads, lengths, res)
            return res
        # skip-aware resolution: each skipped core weakens the bound by one
        bound = fp.resolved_bound(lengths, self.params.min_edit_dist)
        resolved = (
            res["best_mm"].astype(np.int32) + res["n_over"] <= bound
        ) & (~res["cap_trunc"])
        res["overflow"] = np.zeros_like(res["overflow"])
        res["n_over"] = np.zeros_like(res["n_over"])
        res["cap_trunc"] = np.zeros_like(res["cap_trunc"])
        rows = np.nonzero(~resolved)[0]
        count("engine.rerun_rows", len(rows))
        if len(rows):
            with span("engine.rerun"):
                sub_r, sub_l = pad_rows(reads[rows], lengths[rows])
                sub = self.align_batch(sub_r, sub_l)
                self.rescue_pass(sub_r, sub_l, sub)
                for k in RESULT_KEYS + _LADDER_KEYS:
                    res[k][rows] = sub[k][: len(rows)]
        return res

    def launch_fast(self, reads: np.ndarray, lengths: np.ndarray):
        """Enqueue only the fast pass (the classic pass where there is no
        fast pass): no unresolved rerun, no rescue.  For chunk sweeps that
        resolve reads on the merged result (two_level_chunk_sweep)."""
        _, _, out, dp, fp = self.launch_primary(reads, lengths)
        return (out, dp, fp)

    def finish_fast(self, state) -> dict:
        out, dp, _ = state
        return _to_host(out, dp)

    def align_stream(self, blocks):
        """align_with_rescue over an iterator of (reads, lengths), with the
        next block's primary pass enqueued before this block's result is
        fetched and completed; yields host result dicts."""
        pending = None
        for reads, lengths in blocks:
            state = self.launch_primary(reads, lengths)
            if pending is not None:
                yield self.finish_primary(pending)
            pending = state
        if pending is not None:
            yield self.finish_primary(pending)

    def align_with_rescue(self, reads: np.ndarray, lengths: np.ndarray):
        """Primary pass + classic rerun + rescue ladder (the JAX engine's
        align_with_rescue, field for field)."""
        return self.finish_primary(self.launch_primary(reads, lengths))

    def rescue_pass(self, reads: np.ndarray, lengths: np.ndarray,
                    res: dict) -> None:
        """Apply the progressive rescue ladder in place (rescue_ladder)."""
        def run(r, l, H, cap, skip):
            return self.align_batch(r, l, H=H, cand_cap=cap, occ_skip=skip)

        return rescue_ladder(run, reads, lengths, res, self.params)


class ExtendedAligner:
    """Adds micro-indel and splice-junction fall-through passes to an
    AlignEngine (the -a/-A aligner modes; CSfxArrayV3::AlignReads
    progressive fall-through, SfxArrayV2.cpp:7663-7760), following
    biokanga_tpu/align/pipeline.py:780-910.

    Reads with no hit from the Hamming pass are re-seeded on both
    strands; their candidate diagonals feed the indel and splice scans
    (align/splice_indel.py) on the index's device.  The per-row best
    stays on the device until it is chosen, then goes to the host.
    """

    def __init__(self, engine: AlignEngine, micro_indel_len: int = 0,
                 splice_junct_len: int = 0):
        self.engine = engine
        self.micro_indel_len = min(micro_indel_len, 20)
        self.splice_junct_len = min(splice_junct_len, 100_000)

    def align(self, reads: np.ndarray, lengths: np.ndarray):
        eng = self.engine
        res = eng.align_with_rescue(reads, lengths)
        res["cigar_op"] = np.zeros(len(reads), dtype=np.int32)  # 0 = pure M
        res["op_len"] = np.zeros(len(reads), dtype=np.int32)
        res["split"] = np.zeros(len(reads), dtype=np.int32)
        if not (self.micro_indel_len or self.splice_junct_len):
            return res

        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        best = self.scan_rows(sub_r, sub_l)
        if best is None:
            return res
        acc = np.nonzero(best["ok"] & (best["score"] > -(1 << 20)))[0]
        acc = acc[acc < len(left)]  # drop pad rows
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = best["locus"][acc]
        res["is_rc"][gi] = best["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(best["mm"][acc], 255).astype(np.uint8)
        res["split"][gi] = best["split"][acc]
        res["cigar_op"][gi] = best["op"][acc]
        res["op_len"][gi] = best["gaplen"][acc]
        return res

    def scan_rows(self, sub_r: np.ndarray, sub_l: np.ndarray):
        """Indel/splice fall-through scans for one padded row block;
        returns the per-row best-candidate dict of host arrays (schema of
        scan_fallthrough), or None."""
        eng = self.engine
        didx = eng.didx
        dev = didx.device
        best = scan_fallthrough(
            didx, eng.params,
            eng.params.derive(int(sub_r.shape[1]), didx.total_len),
            torch.from_numpy(np.ascontiguousarray(sub_r, np.int8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sub_l, np.int32)).to(dev),
            self.micro_indel_len, self.splice_junct_len)
        if best is None:
            return None
        return {k: v.cpu().numpy() for k, v in best.items()}


def scan_fallthrough(didx: DeviceIndex, params: AlignParams,
                     dp: DerivedParams, reads: torch.Tensor,
                     lengths: torch.Tensor, micro_indel_len: int,
                     splice_junct_len: int):
    """The indel and splice scans of a row block on didx's device; the
    per-row best candidate as a dict of device tensors, or None if no
    scan runs.

    Result schema: ok, score (-(1 << 20) where not ok), mm, split, locus,
    is_rc, op (signed indel, or 1<<30 for a splice), gaplen (the splice's
    N length).  Sense before antisense and indels before splices; a later
    scan replaces the best only on a strictly higher score.  No ownership
    limit: a junction's 3' segment may lie in a chunk's overlap tail."""
    from .splice_indel import indel_scan, splice_scan

    B, L = reads.shape
    dev = reads.device
    scan_args = (didx.packed, didx.entry_starts)
    best = None
    for is_rc in (False, True):
        seq = _rc_reads(reads, lengths) if is_rc else reads
        loci, vmask, _, _ = _strand_candidates(
            didx, seq, dp, params.cand_per_core, SPLICE_CAND_CAP,
            occ_skip=True)
        rcodes, rnlane = pack_reads(seq, lengths)
        cand = (loci, vmask, rcodes, rnlane, lengths, L)
        outs = []
        if micro_indel_len:
            o = indel_scan(*scan_args, *cand, micro_indel_len)
            outs.append({
                "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                "split": o["split"],
                "locus": torch.gather(loci, 1, o["cand"].to(
                    torch.int64)[:, None])[:, 0],
                "op": o["indel"].to(torch.int64),
                "gaplen": torch.zeros(B, dtype=torch.int64, device=dev),
            })
        if splice_junct_len:
            o = splice_scan(*scan_args, *cand, splice_junct_len)
            outs.append({
                "ok": o["ok"], "score": o["score"], "mm": o["mm"],
                "split": o["split"], "locus": o["locus5"],
                "op": torch.full((B,), 1 << 30, dtype=torch.int64,
                                 device=dev),
                "gaplen": (o["locus3"] - o["locus5"]).to(torch.int64),
            })
        for o in outs:
            o["is_rc"] = torch.full((B,), is_rc, dtype=torch.bool,
                                    device=dev)
            o["score"] = torch.where(o["ok"], o["score"], -(1 << 20))
            if best is None:
                best = o
            else:
                better = o["score"] > best["score"]
                best = {k: torch.where(better, o[k], best[k])
                        for k in best}
    return best


def cigar_for(length: int, cigar_op: int, op_len: int, split: int) -> str:
    """CIGAR string from the extended-aligner encodings (copy of
    biokanga_tpu/align/pipeline.py:913)."""
    if cigar_op == 0:
        return f"{length}M"
    if cigar_op == 1 << 30:  # splice: N gap of op_len at split
        return f"{split}M{op_len}N{length - split}M"
    g = int(cigar_op)
    if g > 0:  # genome deletion
        return f"{split}M{g}D{length - split}M"
    j = -g     # read insertion
    return f"{split}M{j}I{length - split - j}M"


# RESULT_KEYS, inexact_rows, rescue_ladder and pad_rows are copied from
# biokanga_tpu/align/pipeline.py:687-777 and :926 (numpy host code; that
# module imports jax).
RESULT_KEYS = ("unique", "any_hit", "best_mm", "next_mm", "inst",
               "locus", "is_rc", "ml_loci", "ml_mm", "ml_rc")
_LADDER_KEYS = ("overflow", "n_over", "cap_trunc")


def inexact_rows(res: dict, lengths, min_edit_dist: int):
    """Rows whose result is NOT provably exact under the skip-aware
    pigeonhole bound:

        exact  iff  no candidate-cap truncation AND
                    (no core skipped  OR
                     best_mm + n_over + MMDelta <= length // core_len)
    """
    n = np.asarray(lengths, np.int32) // np.int32(res["derived"].core_len)
    best = res["best_mm"].astype(np.int32)
    exact = (~res["cap_trunc"]) & (
        (res["n_over"] == 0)
        | (best + res["n_over"] + np.int32(min_edit_dist) <= n)
    )
    return ~exact


def rescue_ladder(run, reads, lengths, res: dict, params: AlignParams,
                  extra_keys=()):
    """Progressive-sensitivity rescue for inexact reads:

      step 1  medium-width complete enumeration (occ_skip at
              rescue_mid_H), in fixed 2,048-row dispatches;
      step 2  full-width truncating pass (first rescue_cand_per_core
              positions per core) for the still-inexact residue, except
              reads already excessive-multi at mm == 0, in fixed 512-row
              dispatches.

    `run(reads, lengths, H, cand_cap, occ_skip) -> host result dict`.
    Mutates `res` in place and returns it.
    """
    keys = RESULT_KEYS + _LADDER_KEYS + tuple(extra_keys)
    p = params
    need = inexact_rows(res, lengths, p.min_edit_dist)
    if not need.any():
        return res
    if p.rescue_mid_H > p.cand_per_core:
        rows = np.nonzero(need)[0]
        CH1 = 2048
        for s in range(0, len(rows), CH1):
            sub_rows = rows[s: s + CH1]
            k_n = len(sub_rows)
            sub_r = np.full((CH1, reads.shape[1]), 4, reads.dtype)
            sub_l = np.zeros(CH1, lengths.dtype)
            sub_r[:k_n] = reads[sub_rows]
            sub_l[:k_n] = lengths[sub_rows]
            sub = run(sub_r, sub_l, p.rescue_mid_H, p.rescue_mid_cap, True)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    multi0 = (res["any_hit"] & (res["best_mm"] == 0)
              & (res["inst"] > p.max_multi))
    need2 = inexact_rows(res, lengths, p.min_edit_dist) & ~multi0
    if need2.any():
        rows = np.nonzero(need2)[0]
        CH = 512
        cap = 8 * p.max_cand_per_strand
        for s in range(0, len(rows), CH):
            sub_rows = rows[s: s + CH]
            k_n = len(sub_rows)
            r = np.full((CH, reads.shape[1]), 4, reads.dtype)
            l = np.zeros(CH, lengths.dtype)
            r[:k_n] = reads[sub_rows]
            l[:k_n] = lengths[sub_rows]
            sub = run(r, l, p.rescue_cand_per_core, cap, False)
            for k in keys:
                res[k][sub_rows] = sub[k][:k_n]
    return res


def pad_rows(reads: np.ndarray, lengths: np.ndarray,
             target: int | None = None):
    """Pad a read block to a power-of-two row count (min 64) with N-filled
    rows of length 0."""
    B = reads.shape[0]
    if target is None:
        target = 64
        while target < B:
            target *= 2
    if B == target:
        return reads, lengths
    pr = np.full((target, reads.shape[1]), 4, dtype=reads.dtype)
    pr[:B] = reads
    pl = np.zeros(target, dtype=lengths.dtype)
    pl[:B] = lengths
    return pr, pl
