"""Copy of biokanga_tpu/parallel/chunked.py:39-548: alignment against a
genome-range chunked index on one device, for genomes past 2^31 bases.

Chunks are iterated OUTER (one device index per chunk), read blocks
INNER, and the per-read summaries merge exactly on the host — the role
of the reference's uhamming multi-node static sweep + file merge
(uhamming/uhamming.cpp:222-238).  The merge is exact because chunk
ownership makes the per-chunk candidate sets disjoint:

  best*  = lexicographic min over chunks of (mm, strand, global locus)
  inst*  = sum of per-chunk best-instance counts where chunk best == best*
  next*  = min over chunks of (chunk next-best if chunk best == best*
           else chunk best)
  ml*    = K-smallest of the union of per-chunk top-K lists

which reproduces the reference's LowMMCnt/NxtLowMMCnt acceptance rule
(libbiokanga/SfxArrayV2.h:70-77) over the whole genome.  Merged loci are
int64 on the host; device tensors stay chunk-local int32.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..align.params import AlignParams
from ..align.pipeline import AlignEngine, ExtendedAligner, pad_rows
from ..device import resolve_device
from ..index.chunked import ChunkedIndex, chunk_to_device
from ..ops.extend import MM_INVALID


def _max_tot_mm(lengths: np.ndarray, params: AlignParams) -> np.ndarray:
    if params.max_subs_per100 == 0:
        return np.zeros(len(lengths), np.int32)
    return np.clip(
        np.floor(lengths * (params.max_subs_per100 / 100.0) + 0.5), 1, 63
    ).astype(np.int32)


def merge_chunk_results(
    partials: list[dict],
    bases: np.ndarray,
    lengths: np.ndarray,
    params: AlignParams,
) -> dict:
    """Exact host-side merge of per-chunk result dicts (see module doc).

    Returns the single-index result schema with int64 global loci.
    """
    K = len(partials)
    if K == 1:
        p = dict(partials[0])
        p["locus"] = p["locus"].astype(np.int64) + int(bases[0])
        ml = p["ml_loci"].astype(np.int64)
        p["ml_loci"] = np.where(ml >= 0, ml + int(bases[0]), -1)
        return p
    best = np.stack([p["best_mm"].astype(np.int32) for p in partials])
    nxt = np.stack([p["next_mm"].astype(np.int32) for p in partials])
    inst = np.stack([p["inst"].astype(np.int64) for p in partials])
    rc = np.stack([p["is_rc"] for p in partials])
    loc_g = np.stack(
        [p["locus"].astype(np.int64) + int(bases[k])
         for k, p in enumerate(partials)]
    )
    ovf = np.any([p["overflow"] for p in partials], axis=0)
    # skip-aware exactness composition: a hidden hit lives in ONE chunk,
    # so the per-read pigeonhole charge is the worst chunk's skip count;
    # cap truncation anywhere taints the row
    n_over = np.max([p["n_over"] for p in partials], axis=0)
    cap_trunc = np.any([p["cap_trunc"] for p in partials], axis=0)

    # winner chunk by lexicographic (mm, strand, global locus)
    okey = best * 2 + rc.astype(np.int32)          # (K, B)
    cur_key = okey[0].copy()
    cur_loc = loc_g[0].copy()
    kstar = np.zeros(best.shape[1], np.int64)
    for k in range(1, K):
        better = (okey[k] < cur_key) | (
            (okey[k] == cur_key) & (loc_g[k] < cur_loc)
        )
        kstar = np.where(better, k, kstar)
        cur_key = np.where(better, okey[k], cur_key)
        cur_loc = np.where(better, loc_g[k], cur_loc)
    take = lambda a: np.take_along_axis(a, kstar[None, :], axis=0)[0]
    b_star = take(best)
    is_best = best == b_star[None, :]
    inst_star = np.sum(np.where(is_best, inst, 0), axis=0)
    # rows with NO valid candidate anywhere (best == MM_INVALID): inst is
    # the invalid-slot count, not a hit count — keep the winner's verbatim
    # so the merged dict matches the single-index output bit-for-bit
    inst_star = np.where(b_star >= MM_INVALID, take(inst), inst_star)
    # union second-smallest: best* itself when the union holds >= 2 best
    # instances (matches the single-index sorted-duplicates semantics)
    next_star = np.min(np.where(is_best, nxt, best), axis=0)
    next_star = np.where(inst_star >= 2, b_star, next_star)
    # per-chunk next_mm arrives saturated at chunk_best + MMDelta; the
    # min-merge then re-saturates at global best + MMDelta — equal to
    # saturate(true union second-best) because chunk bests are never
    # saturated and any sub-margin union value is sub-margin in its own
    # chunk
    next_star = np.minimum(next_star, b_star + params.min_edit_dist)

    mtm = _max_tot_mm(lengths, params)
    any_hit = b_star <= mtm
    unique = any_hit & ((next_star - b_star) >= params.min_edit_dist)

    # top-K multi-hit merge: K-smallest of the union by (mm, rc, locus)
    ml_mm = np.concatenate([p["ml_mm"] for p in partials], axis=1)
    ml_rc = np.concatenate([p["ml_rc"] for p in partials], axis=1)
    ml_loc = np.concatenate(
        [np.where(p["ml_loci"] >= 0,
                  p["ml_loci"].astype(np.int64) + int(bases[k]), -1)
         for k, p in enumerate(partials)],
        axis=1,
    )
    Kml = partials[0]["ml_mm"].shape[1]
    comp = (
        ((ml_mm.astype(np.int64) * 2 + ml_rc) << np.int64(44))
        | np.clip(ml_loc, 0, (1 << 44) - 1)
    )
    order = np.argsort(comp, axis=1, kind="stable")[:, :Kml]
    tk = lambda a: np.take_along_axis(a, order, axis=1)

    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": np.minimum(b_star, MM_INVALID).astype(np.uint8),
        "next_mm": np.minimum(next_star, MM_INVALID).astype(np.uint8),
        "inst": inst_star.astype(partials[0]["inst"].dtype),
        "locus": cur_loc,
        "is_rc": (cur_key & 1).astype(bool),
        "overflow": ovf,
        "n_over": n_over,
        "cap_trunc": cap_trunc,
        "ml_loci": tk(ml_loc),
        "ml_mm": tk(ml_mm),
        "ml_rc": tk(ml_rc),
    }


def _scan_every_chunk(ca, micro_indel_len, splice_junct_len, sub_r, sub_l):
    """ExtendedAligner.scan_rows of one padded row block against every
    chunk; the per-row winner by score (strictly higher replaces, so the
    earlier chunk wins ties), loci global int64.  None if no scan ran."""
    best = None
    for k in range(ca.ci.num_chunks):
        ext = ExtendedAligner(ca.engine_for(k), micro_indel_len,
                              splice_junct_len)
        b = ext.scan_rows(sub_r, sub_l)
        if b is None:
            continue
        b = dict(b)
        b["locus"] = b["locus"].astype(np.int64) + int(ca.ci.bases[k])
        if best is None:
            best = b
        else:
            better = b["score"] > best["score"]
            best = {kk: np.where(better, b[kk], best[kk]) for kk in best}
    return best


class ChunkedExtendedAligner:
    """Micro-indel + splice-junction fall-through over a ChunkedIndex:
    leftover reads scan against every chunk (ExtendedAligner.scan_rows on
    each resident chunk), winners merge by score across chunks — the
    -a/-A aligner modes past 2^31 bases (CSfxArrayV3::AlignReads
    fall-through, SfxArrayV2.cpp:7663-7760).

    Splice exactness at chunk cuts needs ci.overlap >= splice separation
    + read length (default chunks use 2048)."""

    def __init__(self, ca: "ChunkedAligner", micro_indel_len: int = 0,
                 splice_junct_len: int = 0):
        self.ca = ca
        self.micro_indel_len = micro_indel_len
        self.splice_junct_len = splice_junct_len

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        res = self.ca.align(reads, lengths)
        B = len(reads)
        res["cigar_op"] = np.zeros(B, np.int64)
        res["op_len"] = np.zeros(B, np.int64)
        res["split"] = np.zeros(B, np.int32)
        if not (self.micro_indel_len or self.splice_junct_len):
            return res
        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        best = _scan_every_chunk(self.ca, self.micro_indel_len,
                                 self.splice_junct_len, sub_r, sub_l)
        if best is None:
            return res
        acc = np.nonzero(best["ok"] & (best["score"] > -(1 << 20)))[0]
        acc = acc[acc < len(left)]
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = best["locus"][acc]
        res["is_rc"][gi] = best["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(best["mm"][acc], 255).astype(
            np.uint8)
        res["split"][gi] = best["split"][acc]
        res["cigar_op"][gi] = best["op"][acc]
        res["op_len"][gi] = best["gaplen"][acc]
        return res

    def fallthrough_blocks(self, blocks, results) -> int:
        """Apply the indel/splice fall-through to MANY aligned blocks with
        ONE chunk sweep: leftovers from every block gather into one row
        matrix, scan per chunk, winners write back into the per-block
        result dicts.  Returns the number of rescued reads."""
        rows = []   # (block, row)
        mats, lens = [], []
        L = max(r.shape[1] for r, _ in blocks)
        for b, ((reads, lengths), res) in enumerate(zip(blocks, results)):
            res.setdefault("cigar_op", np.zeros(len(lengths), np.int64))
            res.setdefault("op_len", np.zeros(len(lengths), np.int64))
            res.setdefault("split", np.zeros(len(lengths), np.int32))
            for i in np.nonzero(~res["unique"] & ~res["any_hit"])[0]:
                rows.append((b, int(i)))
                row = np.full(L, 4, reads.dtype)
                row[: reads.shape[1]] = reads[i]
                mats.append(row)
                lens.append(lengths[i])
        if not rows:
            return 0
        sub_r, sub_l = pad_rows(np.stack(mats),
                                np.asarray(lens, np.int32))
        best = _scan_every_chunk(self.ca, self.micro_indel_len,
                                 self.splice_junct_len, sub_r, sub_l)
        if best is None:
            return 0
        n_rescued = 0
        acc = np.nonzero(best["ok"] & (best["score"] > -(1 << 20)))[0]
        for j in acc:
            if j >= len(rows):
                continue
            b, i = rows[j]
            res = results[b]
            res["unique"][i] = True
            res["any_hit"][i] = True
            res["locus"][i] = best["locus"][j]
            res["is_rc"][i] = best["is_rc"][j]
            res["best_mm"][i] = min(int(best["mm"][j]), 255)
            res["split"][i] = best["split"][j]
            res["cigar_op"][i] = best["op"][j]
            res["op_len"][i] = best["gaplen"][j]
            n_rescued += 1
        return n_rescued


def chunk_of(bases: np.ndarray, glob_loci) -> np.ndarray:
    """Index of the chunk whose slice starts at or below each global
    locus."""
    return np.clip(np.searchsorted(bases, glob_loci, side="right") - 1, 0,
                   len(bases) - 1)


class ChunkedPEAligner:
    """Paired-end alignment against a ChunkedIndex: both mates through the
    chunk-merged SE path, global classification, then orphan rescue
    grouped by the anchor's chunk (one chunk index per chunk holding
    orphans) — the chunked realisation of CAligner::ProcessPairedEnds +
    AlignPairedRead (biokanga/Aligner.cpp:2876; SfxArrayV2.cpp:8247).

    An orphan whose rescue window crosses a chunk cut needs ci.overlap >=
    pair_max_len; a shorter overlap clips such windows, as in the JAX
    package (a warning says so).
    """

    def __init__(self, ca: "ChunkedAligner", pe=None):
        from ..align.pe import PEParams

        self.ca = ca
        self.pe = pe or PEParams()
        if ca.ci.overlap < self.pe.pair_max_len:
            warnings.warn(
                f"chunk overlap {ca.ci.overlap} < pair_max_len "
                f"{self.pe.pair_max_len}: PE rescue windows crossing chunk "
                "cuts will be clipped"
            )

    def align_pairs(self, reads1, len1, reads2, len2):
        from ..align.pe import PEAligner, _orient_mates, classify_pairs

        ca = self.ca
        ci = ca.ci
        res1 = ca.align(reads1, len1)
        res2 = ca.align(reads2, len2)
        starts = ci.entry_starts
        cls = classify_pairs(res1, res2, len1, len2, starts, self.pe)

        if self.pe.rescue:
            for which, (anch, mate_reads, mate_len, mres) in {
                1: (res1, reads2, len2, res2),
                2: (res2, reads1, len1, res1),
            }.items():
                rows_all = np.nonzero(cls[f"orphan{which}"])[0]
                if len(rows_all) == 0:
                    continue
                a_chunk = chunk_of(ci.bases, anch["locus"][rows_all])
                for k in np.unique(a_chunk):
                    rows = rows_all[a_chunk == k]
                    pea = PEAligner(ca.engine_for(int(k)), self.pe)
                    a_loc = (anch["locus"][rows]
                             - int(ci.bases[k])).astype(np.int32)
                    a_rc = anch["is_rc"][rows]
                    a_len = (len1 if which == 1 else len2)[rows]
                    ml = mate_len[rows]
                    # FR: the mate of a forward anchor is scanned as its
                    # reverse complement
                    m = _orient_mates(mate_reads[rows], ml, ~a_rc)
                    out = pea.rescue(a_loc, a_rc, a_len, m, ml)
                    ok = out["ok"]
                    mres["unique"][rows[ok]] = True
                    mres["locus"][rows[ok]] = (
                        out["locus"][ok].astype(np.int64) + int(ci.bases[k])
                    )
                    mres["is_rc"][rows[ok]] = ~a_rc[ok]
                    mres["best_mm"][rows[ok]] = out["mm"][ok]
            cls = classify_pairs(res1, res2, len1, len2, starts, self.pe)

        return {"res1": res1, "res2": res2, **cls}


class ChunkedAligner:
    """Align read sets against a ChunkedIndex on one device.

    One AlignEngine is reused across chunks: `engine_for(k)` points it at
    chunk k's device index, padded to the shapes of every chunk
    (ChunkedIndex.pad_shapes)."""

    def __init__(self, ci: ChunkedIndex, params: AlignParams | None = None,
                 device: torch.device | str = "cuda"):
        self.ci = ci
        self.params = params or AlignParams()
        self.device = resolve_device(device)
        self.pad_shapes = ci.pad_shapes()
        self.engine: AlignEngine | None = None

    def engine_for(self, k: int) -> AlignEngine:
        if self.engine is not None:
            self.engine.didx = None        # free the previous chunk first
        didx = chunk_to_device(self.ci, k, self.pad_shapes, self.device)
        if self.engine is None:
            self.engine = AlignEngine(didx, self.params)
        else:
            self.engine.didx = didx
        return self.engine

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        """One padded read block vs every chunk; exact merged result."""
        partials = []
        for k in range(self.ci.num_chunks):
            eng = self.engine_for(k)
            partials.append(eng.align_with_rescue(reads, lengths))
        res = merge_chunk_results(partials, self.ci.bases, lengths,
                                  self.params)
        res["derived"] = partials[0].get("derived")
        return res

    def align_blocks(self, blocks: list[tuple[np.ndarray, np.ndarray]],
                     checkpoint_dir: str | None = None):
        """Chunk-major streaming over many read blocks (one chunk index on
        the device at a time for the whole read set).  Returns merged
        dicts per block.

        checkpoint_dir: persist every (chunk, block) partial and resume a
        killed run at the first missing cell (utils/checkpoint.py)."""
        ckpt = None
        if checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpoint, config_signature

            sig = config_signature(
                [self.ci.bases, self.ci.owned, self.params,
                 [(r.shape, int(l.sum())) for r, l in blocks]]
            )
            ckpt = SweepCheckpoint(checkpoint_dir, sig)
        per_block: list[list[dict]] = [[] for _ in blocks]
        for k in range(self.ci.num_chunks):
            need = [b for b in range(len(blocks))
                    if ckpt is None or not ckpt.has(k, b)]
            eng = self.engine_for(k) if need else None
            for b, (reads, lengths) in enumerate(blocks):
                if ckpt is not None and b not in need:
                    per_block[b].append(ckpt.load(k, b))
                    continue
                res = eng.align_with_rescue(reads, lengths)
                if ckpt is not None:
                    ckpt.save(k, b, res)
                per_block[b].append(res)
        out = []
        for b, (reads, lengths) in enumerate(blocks):
            res = merge_chunk_results(per_block[b], self.ci.bases, lengths,
                                      self.params)
            res["derived"] = per_block[b][0].get("derived")
            out.append(res)
        return out


def two_level_chunk_sweep(ca, blocks, checkpoint_dir=None, progress=None):
    """Chunk sweep with GLOBAL two-level resolution.

    Cycle 1 runs only the FAST pass per (chunk, block), one block in
    flight, checkpointed.  The per-chunk fall-through
    (AlignEngine.finish_primary) would rerun the classic pass for every
    read whose home is another chunk (~(K-1)/K of the sweep), but the
    two-level exactness bound (AlignParams.derive_fast) only needs the
    GLOBAL best: every chunk's fast pass finds all of its hits with mm <=
    n_cores - 1, so after the exact merge a read with merged best <=
    n_cores - MMDelta and no overflow is resolved.  Only the unresolved
    remainder makes a second, classic + rescue cycle over the chunks.

    `ca` is a DeviceBuildChunkedAligner-like aligner (num_chunks,
    engine_for, bases, params, lut_bases, pad_n).  Returns merged result
    dicts per block (int64 global loci).
    """
    params = ca.params
    bases = ca.bases
    K = ca.num_chunks
    ckpt = None
    if checkpoint_dir:
        from ..utils.checkpoint import SweepCheckpoint, config_signature

        sig = config_signature(
            ["two_level_fast", bases, params,
             [(r.shape, int(l.sum())) for r, l in blocks]]
        )
        ckpt = SweepCheckpoint(checkpoint_dir, sig)

    per_block: list[list[dict]] = [[] for _ in blocks]
    fps = [None] * len(blocks)
    engine = None
    for k in range(K):
        need = [b for b in range(len(blocks))
                if ckpt is None or not ckpt.has(k, b)]
        if need:
            engine = ca.engine_for(k)
        pend = None
        for b in need:
            st = engine.launch_fast(*blocks[b])
            fps[b] = st[2]
            if pend is not None:
                bp, sp = pend
                res = engine.finish_fast(sp)
                if ckpt is not None:
                    ckpt.save(k, bp, res)
                per_block[bp].append(res)
            pend = (b, st)
        if pend is not None:
            bp, sp = pend
            res = engine.finish_fast(sp)
            if ckpt is not None:
                ckpt.save(k, bp, res)
            per_block[bp].append(res)
        for b in range(len(blocks)):
            if ckpt is not None and b not in need:
                per_block[b].append(ckpt.load(k, b))
        if progress is not None:
            progress("fast", k)

    merged = []
    unresolved = []  # (block, rows)
    for b, (reads, lengths) in enumerate(blocks):
        res = merge_chunk_results(per_block[b], bases, lengths, params)
        res["derived"] = per_block[b][0].get("derived")
        merged.append(res)
        fp = fps[b]
        if fp is None:
            fp = ca.params.derive_fast(
                int(reads.shape[1]),
                int(ca.pad_n) if hasattr(ca, "pad_n") else 0,
                ca.lut_bases,
            )
        if fp is None:
            rows = np.nonzero(res["overflow"])[0]
        else:
            bound = fp.resolved_bound(lengths, params.min_edit_dist)
            resolved = (
                res["best_mm"].astype(np.int32) + res["n_over"] <= bound
            ) & (~res["cap_trunc"])
            rows = np.nonzero(~resolved)[0]
        if len(rows):
            unresolved.append((b, rows))

    if unresolved:
        sub_reads = np.concatenate(
            [blocks[b][0][rows] for b, rows in unresolved]
        )
        sub_lens = np.concatenate(
            [blocks[b][1][rows] for b, rows in unresolved]
        )
        CH = 512
        M = len(sub_reads)
        pad = -M % CH
        if pad:
            sub_reads = np.concatenate(
                [sub_reads, np.full((pad, sub_reads.shape[1]), 4,
                                    sub_reads.dtype)]
            )
            sub_lens = np.concatenate([sub_lens,
                                       np.zeros(pad, sub_lens.dtype)])
        partials = []
        for k in range(K):
            engine = ca.engine_for(k)
            parts = []
            for s in range(0, len(sub_reads), CH):
                r, l = pad_rows(sub_reads[s : s + CH],
                                sub_lens[s : s + CH])
                sub = engine.align_batch(r, l)
                engine.rescue_pass(r, l, sub)
                parts.append(sub)
            partials.append(
                {key: np.concatenate([p[key] for p in parts])
                 for key in parts[0] if key != "derived"}
            )
            if progress is not None:
                progress("classic", k)
        sub_merged = merge_chunk_results(partials, bases, sub_lens, params)
        ofs = 0
        for b, rows in unresolved:
            for key in ("unique", "any_hit", "best_mm", "next_mm", "inst",
                        "locus", "is_rc", "overflow", "n_over", "cap_trunc",
                        "ml_loci", "ml_mm",
                        "ml_rc"):
                merged[b][key][rows] = sub_merged[key][ofs: ofs + len(rows)]
            ofs += len(rows)
    return merged
