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

Where every chunk fits on the device at once (index/chunked.py
`ResidentChunks`), `ChunkedAligner` keeps one AlignEngine a chunk, whose
launch keys share one set of CUDA graphs (`AlignEngine`'s `graphs`), and
a block's sweep enqueues every chunk's passes before it finishes the
first; otherwise it cycles the chunks through one engine.  Its
`launch_primary`, `finish_primary` and `engines_of` are what
align/pe.PEAligner pairs and rescues over.  Spans `chunked.sweep`,
`chunked.merge`; counters `chunked.index_bytes`, `chunked.uploads`
(utils/trace.py).
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from ..align.params import AlignParams
from ..align.pe import PEAligner
from ..align.pipeline import (RESULT_KEYS, AlignEngine, ExtendedAligner,
                              _high_priority_stream, pad_rows)
from ..device import resolve_device
from ..index.chunked import (ChunkedIndex, ResidentChunks, chunk_to_device,
                             fits_on_device, upload_chunked_index)
from ..index.device import index_nbytes
from ..ops.extend import MM_INVALID
from ..utils.trace import count, span


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
    device: torch.device | str = "cpu",
) -> dict:
    """Exact merge of per-chunk result dicts (see module doc), computed
    with torch on `device`: on a card, on its high-priority stream, so
    that it need not wait behind a sweep already enqueued there.

    Returns the single-index result schema with int64 global loci, as
    host numpy arrays.
    """
    K = len(partials)
    if K == 1:
        p = dict(partials[0])
        p["locus"] = p["locus"].astype(np.int64) + int(bases[0])
        ml = p["ml_loci"].astype(np.int64)
        p["ml_loci"] = np.where(ml >= 0, ml + int(bases[0]), -1)
        return p
    dev = torch.device(device)
    on = (torch.cuda.stream(_high_priority_stream(
        torch.cuda.current_device() if dev.index is None else dev.index))
        if dev.type == "cuda" else contextlib.nullcontext())
    with on:
        out = _merge(partials, bases, lengths, params, dev)
        return {k: v.cpu().numpy() for k, v in out.items()}


def _merge(partials, bases, lengths, params, dev) -> dict:
    K = len(partials)

    def field(key):
        """(K, ...) tensor of every chunk's `key` on `dev`."""
        parts = [torch.from_numpy(np.ascontiguousarray(p[key]))
                 for p in partials]
        out = torch.empty((K,) + tuple(parts[0].shape),
                          dtype=parts[0].dtype, device=dev)
        for k, t in enumerate(parts):
            out[k].copy_(t)
        return out

    base = torch.from_numpy(np.asarray(bases, np.int64)[:K]).to(dev)
    best = field("best_mm").to(torch.int32)
    nxt = field("next_mm").to(torch.int32)
    inst = field("inst")
    rc = field("is_rc")
    loc_g = field("locus").to(torch.int64) + base[:, None]
    ovf = field("overflow").any(dim=0)
    # skip-aware exactness composition: a hidden hit lives in ONE chunk,
    # so the per-read pigeonhole charge is the worst chunk's skip count;
    # cap truncation anywhere taints the row
    n_over = field("n_over").amax(dim=0)
    cap_trunc = field("cap_trunc").any(dim=0)

    # winner chunk by lexicographic (mm, strand, global locus), the first
    # chunk on ties: one argmin over the pair packed in an int64 (global
    # loci of up to 2^42 bases, past BioKanga's 1,000 Gbp of target)
    okey = best * 2 + rc                           # (K, B)
    if int(loc_g.min()) < 0 or int(loc_g.max()) >= 1 << 42:
        raise ValueError("chunk loci outside [0, 2^42)")
    kstar = torch.argmin((okey.to(torch.int64) << 42) | loc_g, dim=0)

    def take(t):
        return t.gather(0, kstar[None]).squeeze(0)

    b_star = take(best)
    is_best = best == b_star[None, :]
    inst_star = torch.where(is_best, inst, 0).sum(dim=0, dtype=torch.int64)
    # rows with NO valid candidate anywhere (best == MM_INVALID): inst is
    # the invalid-slot count, not a hit count — keep the winner's verbatim
    # so the merged dict matches the single-index output bit-for-bit
    inst_star = torch.where(b_star >= MM_INVALID, take(inst).to(torch.int64),
                            inst_star)
    # union second-smallest: best* itself when the union holds >= 2 best
    # instances (matches the single-index sorted-duplicates semantics)
    next_star = torch.where(is_best, nxt, best).amin(dim=0)
    next_star = torch.where(inst_star >= 2, b_star, next_star)
    # per-chunk next_mm arrives saturated at chunk_best + MMDelta; the
    # min-merge then re-saturates at global best + MMDelta — equal to
    # saturate(true union second-best) because chunk bests are never
    # saturated and any sub-margin union value is sub-margin in its own
    # chunk
    next_star = torch.minimum(next_star, b_star + params.min_edit_dist)

    mtm = torch.from_numpy(_max_tot_mm(lengths, params)).to(dev)
    any_hit = b_star <= mtm
    unique = any_hit & ((next_star - b_star) >= params.min_edit_dist)

    # top-K multi-hit merge: K-smallest of the union by (mm, rc, locus),
    # ties in chunk order
    B, Kml = partials[0]["ml_mm"].shape

    def union(t):
        return t.permute(1, 0, 2).reshape(B, K * Kml)

    ml_mm = union(field("ml_mm"))
    ml_rc = union(field("ml_rc"))
    ml_loc = field("ml_loci").to(torch.int64)
    ml_loc = union(torch.where(ml_loc >= 0, ml_loc + base[:, None, None], -1))
    comp = (((ml_mm.to(torch.int64) * 2 + ml_rc) << 44)
            | ml_loc.clamp(0, (1 << 44) - 1))
    order = torch.sort(comp, dim=1, stable=True).indices[:, :Kml]
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": b_star.clamp(max=MM_INVALID).to(torch.uint8),
        "next_mm": next_star.clamp(max=MM_INVALID).to(torch.uint8),
        "inst": inst_star.to(inst.dtype),
        "locus": take(loc_g),
        "is_rc": (take(okey) & 1).to(torch.bool),
        "overflow": ovf,
        "n_over": n_over,
        "cap_trunc": cap_trunc,
        "ml_loci": ml_loc.gather(1, order),
        "ml_mm": ml_mm.gather(1, order),
        "ml_rc": ml_rc.gather(1, order),
    }


def _scan_every_chunk(ca, micro_indel_len, splice_junct_len, sub_r, sub_l):
    """ExtendedAligner.scan_rows of one padded row block against every
    chunk; the per-row winner by score (strictly higher replaces, so the
    earlier chunk wins ties), loci global int64.  None if no scan ran."""
    best = None
    for k in range(ca.num_chunks):
        ext = ExtendedAligner(ca.engine_for(k), micro_indel_len,
                              splice_junct_len)
        b = ext.scan_rows(sub_r, sub_l)
        if b is None:
            continue
        b = dict(b)
        b["locus"] = b["locus"].astype(np.int64) + int(ca.bases[k])
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


class ChunkedPEAligner(PEAligner):
    """`PEAligner` over a `ChunkedAligner`: the mates through the
    chunk-merged SE path, global classification, and the orphan rescue
    on the engine of each anchor's chunk (`ChunkedAligner.engines_of`) —
    the chunked realisation of CAligner::ProcessPairedEnds +
    AlignPairedRead (biokanga/Aligner.cpp:2876; SfxArrayV2.cpp:8247).

    An orphan whose rescue window crosses a chunk cut needs an overlap >=
    pair_max_len; a shorter overlap clips such windows, as in the JAX
    package (a warning says so).
    """

    def __init__(self, ca: "ChunkedAligner", pe=None):
        super().__init__(ca, pe)
        self.ca = ca
        if ca.overlap < self.pe.pair_max_len:
            warnings.warn(
                f"chunk overlap {ca.overlap} < pair_max_len "
                f"{self.pe.pair_max_len}: PE rescue windows crossing chunk "
                "cuts will be clipped"
            )


def _finish_chunk(e: AlignEngine, reads, lengths, fast, classic) -> dict:
    """`e.finish_primary`'s result from `ChunkedAligner.launch_primary`'s
    passes of one chunk: the fast pass's resolved rows, and for the rest
    the classic pass of every row with the rescue ladder (rows are
    independent, so the result is align_with_rescue's row for row)."""
    res = e.finish_fast(fast)
    if classic is None:
        e.rescue_pass(reads, lengths, res)
        return res
    rows = e.unresolved(res, lengths, fast[2])
    count("engine.rerun_rows", len(rows))
    with span("engine.rerun"):
        sub = e.finish_fast(classic)
        kept = np.ones(len(reads), bool)
        kept[rows] = False
        for k in ("overflow", "n_over", "cap_trunc"):
            sub[k][kept] = 0
        e.rescue_pass(reads, lengths, sub)
        for k in RESULT_KEYS:
            sub[k][kept] = res[k][kept]
    sub["derived"] = res["derived"]
    return sub


class ChunkedAligner:
    """Align read sets against a chunked index on one device.

    `index`: a `ResidentChunks` (every chunk already on the device), or a
    host `ChunkedIndex`, which is uploaded once when it fits the device
    (`fits_on_device`).  A resident index gets one AlignEngine a chunk,
    the engines sharing one set of CUDA graphs; a block's sweep enqueues
    every chunk's fast pass and its classic pass before it finishes the
    first (the result is align_with_rescue's, chunk for
    chunk).  An index that does not fit cycles the chunks through one
    AlignEngine: `engine_for(k)` points it at chunk k's device index,
    padded to the shapes of every chunk (ChunkedIndex.pad_shapes)."""

    def __init__(self, index: ChunkedIndex | ResidentChunks,
                 params: AlignParams | None = None,
                 device: torch.device | str = "cuda"):
        self.params = params or AlignParams()
        self.device = resolve_device(device)
        if isinstance(index, ResidentChunks):
            self.ci, res = None, index
        else:
            self.ci = index
            res = (upload_chunked_index(index, self.device)
                   if fits_on_device(index, self.device) else None)
        src = res if res is not None else index
        self.bases, self.owned = src.bases, src.owned
        self.entry_names, self.entry_starts = src.entry_names, src.entry_starts
        self.overlap = src.overlap
        self.num_chunks = src.num_chunks
        self.resident = res
        self.engine: AlignEngine | None = None
        if res is not None:
            graphs: dict = {}
            self.engines = [AlignEngine(d, self.params, graphs=graphs)
                            for d in res.chunks]
        else:
            self.engines = None
            self.pad_shapes = index.pad_shapes()

    def engine_for(self, k: int) -> AlignEngine:
        """Chunk k's engine: the resident one, or the cycling engine
        pointed at chunk k, uploaded now."""
        if self.engines is not None:
            return self.engines[k]
        if self.engine is not None:
            self.engine.didx = None        # free the previous chunk first
        count("chunked.uploads", 1)
        didx = chunk_to_device(self.ci, k, self.pad_shapes, self.device)
        if self.engine is None:
            self.engine = AlignEngine(didx, self.params)
        else:
            self.engine.didx = didx
        return self.engine

    def index_bytes(self) -> int:
        """Device bytes of the chunk indexes held now: every chunk's when
        resident, else the one uploaded last."""
        if self.resident is not None:
            return self.resident.nbytes()
        return 0 if self.engine is None else index_nbytes(self.engine.didx)

    def stack(self, parts) -> np.ndarray:
        """`np.concatenate(parts)`, a block to `launch_primary`: in pinned
        memory where the resident engines stage their launches, so that
        every chunk's upload copies it as it lies."""
        if self.engines is None:
            return np.concatenate(parts)
        return self.engines[0].stack(parts)

    def entry_starts_host(self) -> np.ndarray:
        """The genome's entry starts (global), in host memory."""
        return self.entry_starts

    def engines_of(self, loci: np.ndarray):
        """(positions, engine, base) of the chunk holding each global
        locus, chunk by chunk in ascending order; cycling, each chunk is
        uploaded as its group is reached, so take them one at a time."""
        k_of = chunk_of(self.bases, loci)
        for k in np.unique(k_of):
            yield (np.nonzero(k_of == k)[0], self.engine_for(int(k)),
                   int(self.bases[k]))

    def launch_primary(self, reads: np.ndarray, lengths: np.ndarray):
        """Enqueue one padded read block against every resident chunk: each
        chunk's fast pass and, behind it, its classic pass of every row,
        since a read's hits lie in one chunk of many and each chunk leaves
        nearly every row unresolved.  Nothing waits for the device.  Pair
        with `finish_primary`; cycling, the whole sweep runs there."""
        with span("chunked.sweep"):
            count("chunked.index_bytes", self.index_bytes())
            if self.engines is None:
                return reads, lengths, None
            states = []
            for e in self.engines:
                fast = e.launch_fast(reads, lengths)
                states.append((fast, None if fast[2] is None
                               else e.launch(reads, lengths) + (None,)))
            return reads, lengths, states

    def finish_primary(self, pending) -> dict:
        """Every chunk's align_with_rescue result of a launched block,
        merged exactly."""
        reads, lengths, states = pending
        with span("chunked.sweep"):
            if states is None:
                partials = [
                    self.engine_for(k).align_with_rescue(reads, lengths)
                    for k in range(self.num_chunks)]
            else:
                partials = [_finish_chunk(e, reads, lengths, *st)
                            for e, st in zip(self.engines, states)]
        with span("chunked.merge"):
            res = merge_chunk_results(partials, self.bases, lengths,
                                      self.params, self.device)
        res["derived"] = partials[0].get("derived")
        return res

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        """One padded read block vs every chunk; exact merged result."""
        return self.finish_primary(self.launch_primary(reads, lengths))

    def align_blocks(self, blocks: list[tuple[np.ndarray, np.ndarray]],
                     checkpoint_dir: str | None = None):
        """Chunk-major streaming over many read blocks (cycling: one chunk
        index on the device at a time for the whole read set).  Returns
        merged dicts per block.

        checkpoint_dir: persist every (chunk, block) partial and resume a
        killed run at the first missing cell (utils/checkpoint.py)."""
        ckpt = None
        if checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpoint, config_signature

            sig = config_signature(
                [self.bases, self.owned, self.params,
                 [(r.shape, int(l.sum())) for r, l in blocks]]
            )
            ckpt = SweepCheckpoint(checkpoint_dir, sig)
        per_block: list[list[dict]] = [[] for _ in blocks]
        for k in range(self.num_chunks):
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
            res = merge_chunk_results(per_block[b], self.bases, lengths,
                                      self.params, self.device)
            res["derived"] = per_block[b][0].get("derived")
            out.append(res)
        return out

    def close(self) -> None:
        """Drop every engine, its graphs and the chunk indexes."""
        self.engines = self.engine = self.resident = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


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
    engine_for, bases, params, lut_bases, pad_n, device).  Returns merged
    result dicts per block (int64 global loci).
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
        res = merge_chunk_results(per_block[b], bases, lengths, params,
                                  ca.device)
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
        sub_merged = merge_chunk_results(partials, bases, sub_lens, params,
                                         ca.device)
        ofs = 0
        for b, rows in unresolved:
            for key in ("unique", "any_hit", "best_mm", "next_mm", "inst",
                        "locus", "is_rc", "overflow", "n_over", "cap_trunc",
                        "ml_loci", "ml_mm",
                        "ml_rc"):
                merged[b][key][rows] = sub_merged[key][ofs: ofs + len(rows)]
            ofs += len(rows)
    return merged
