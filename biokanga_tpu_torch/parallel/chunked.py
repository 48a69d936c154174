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
a block's results stay on the device until they are merged: its sweep
enqueues every chunk's passes, each chunk's select of its fast and
classic rows into a staging set behind them, and the merge behind the
last (ops/chunk_merge.py), and its finish fetches the one merged result.
Otherwise it cycles the chunks through one engine and merges on the
host's terms (`merge_chunk_results`).  Its `launch_primary`,
`finish_primary` and `engines_of` are what align/pe.PEAligner pairs and
rescues over.  Spans `chunked.sweep`, `chunked.merge`; counters
`chunked.index_bytes`, `chunked.uploads`, `chunked.merges`,
`chunked.device_merges` (utils/trace.py).
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from ..align.params import AlignParams
from ..align.pe import PEAligner
from ..align.pipeline import (AlignEngine, ExtendedAligner, _Fetch,
                              _high_priority_stream, _pinned, inexact_rows,
                              pad_rows, result_tensors)
from ..device import resolve_device
from ..index.chunked import (ChunkedIndex, ResidentChunks, chunk_to_device,
                             fits_on_device, upload_chunked_index)
from ..index.device import index_nbytes
from ..ops.chunk_merge import (FIELDS, max_tot_mm, merge_chunks,
                               merge_chunks_plain, one_chunk, select_chunk,
                               staging)
from ..utils.trace import count, span


def _side(device: torch.device):
    """The high-priority stream's context on a card, so that work there
    need not wait behind a sweep already enqueued; a no-op on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(_high_priority_stream(
        torch.cuda.current_device() if device.index is None
        else device.index))


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
    if len(partials) == 1:
        return one_chunk(partials[0], int(bases[0]))
    dev = torch.device(device)
    with _side(dev):
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
    mtm = torch.from_numpy(max_tot_mm(lengths, params.max_subs_per100))
    return merge_chunks_plain({k: field(k) for k in FIELDS}, base,
                              mtm.to(dev), params.min_edit_dist)


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


class ChunkedAligner:
    """Align read sets against a chunked index on one device.

    `index`: a `ResidentChunks` (every chunk already on the device), or a
    host `ChunkedIndex`, which is uploaded once when it fits the device
    (`fits_on_device`).  A resident index gets one AlignEngine a chunk,
    the engines sharing one set of CUDA graphs; a block's launch enqueues
    every chunk's fast pass and its classic pass, each chunk's select
    into a staging set and the exact merge, and its finish waits once
    for the merged result (each chunk's part of it is align_with_rescue's
    row for row).  An index that does not fit cycles the chunks through
    one AlignEngine: `engine_for(k)` points it at chunk k's device index,
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
            dev = res.chunks[0].device
            self._base = torch.as_tensor(
                np.asarray(self.bases[:self.num_chunks], np.int64),
                device=dev)
            # staging sets of blocks finished, free for the next launch;
            # each block in flight holds its own
            self._free: list[dict] = []
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
        nearly every row unresolved; behind those the chunk's select into
        a staging set, before the next chunk's passes replay the shared
        graphs; and behind the last select the exact merge and its copy to
        the host.  Nothing waits for the device.  Pair with
        `finish_primary`; cycling, the whole sweep runs there."""
        with span("chunked.sweep"):
            count("chunked.index_bytes", self.index_bytes())
            if self.engines is None:
                return reads, lengths, None
            dev = self.engines[0].didx.device
            B = len(reads)
            stage = self._staging(B, dev)
            ln = (_pinned(lengths, np.int32).to(dev, non_blocking=True)
                  if dev.type == "cuda" else
                  torch.from_numpy(np.ascontiguousarray(lengths, np.int32)))
            med = self.params.min_edit_dist
            passes = []
            for k, e in enumerate(self.engines):
                fast, fast_dp, fp = e.launch_fast(reads, lengths,
                                                  fetch=False)
                if fp is None:
                    classic, dp, fast = fast, fast_dp, None
                else:
                    classic, dp = e.launch(reads, lengths, fetch=False)
                with span("engine.rerun"):
                    select_chunk(stage, k, ln, classic, dp, med, fast, fp)
                passes.append((fast_dp, dp))
            count("engine.rerun_rows", stage["counts"][1])
        with span("chunked.merge"):
            out = self._merge_stage(stage, ln)
        return reads, lengths, (out, stage, ln, passes)

    def _staging(self, B: int, dev) -> dict:
        """A free staging set of B rows (made where none is), its counts
        zeroed on the stream of the launch."""
        Kml = max(1, self.params.max_multi)
        while self._free:
            stage = self._free.pop()
            if stage["best_mm"].shape[1] == B:
                stage["counts"].zero_()
                return stage
        return staging(self.num_chunks, B, Kml, dev)

    def _merge_stage(self, stage: dict, ln: torch.Tensor):
        """Enqueue the merge of a staging set and the copy of its result
        and counts to the host: a `_Fetch` on a card, else the tensors."""
        out = merge_chunks(stage, self._base, ln,
                           self.params.max_subs_per100,
                           self.params.min_edit_dist)
        out["counts"] = stage["counts"]
        if ln.device.type != "cuda":
            return out
        return _Fetch(out, None, torch.cuda.current_stream(ln.device))

    def _fetch_merged(self, out) -> tuple[dict, np.ndarray]:
        """(the merged host result, the staging counts) of `_merge_stage`."""
        got = {k: v.numpy() for k, v in result_tensors(out).items()}
        counts = got.pop("counts").copy()
        if counts[2, 0]:
            raise ValueError("chunk loci outside [0, 2^42)")
        return got, counts

    def finish_primary(self, pending) -> dict:
        """Every chunk's align_with_rescue result of a launched block,
        merged exactly.  Resident, the merged result of the launch stands
        unless some chunk holds rows for the rescue ladder: those chunks'
        slots then take the ladder on the host, and the block is merged
        again."""
        reads, lengths, state = pending
        count("chunked.merges", 1)
        if state is None:
            with span("chunked.sweep"):
                partials = [
                    self.engine_for(k).align_with_rescue(reads, lengths)
                    for k in range(self.num_chunks)]
            with span("chunked.merge"):
                res = merge_chunk_results(partials, self.bases, lengths,
                                          self.params, self.device)
            res["derived"] = partials[0].get("derived")
            return res
        out, stage, ln, passes = state
        with span("engine.fetch"):
            res, counts = self._fetch_merged(out)
        ladder = np.nonzero(counts[0])[0]
        count("chunked.device_merges", int(len(ladder) == 0))
        if len(ladder):
            res = self._ladder(reads, lengths, stage, ln, passes, ladder)
        self._free.append(stage)
        res["derived"] = passes[0][0]
        return res

    def _ladder(self, reads, lengths, stage, ln, passes, chunks) -> dict:
        """The rescue ladder, as `AlignEngine`'s finish takes it (under
        each chunk's classic pass), on the rows of `chunks` that need it
        (rows are independent), on the high-priority stream; then the
        block merged again.  The rows of all those chunks are found,
        fetched and written back at once."""
        med = self.params.min_edit_dist
        dev = ln.device
        with _side(dev):
            with span("chunked.sweep"), span("engine.rerun"):
                ks = torch.from_numpy(chunks).to(dev)
                keys = {key: stage[key][ks].cpu().numpy()
                        for key in ("best_mm", "n_over", "cap_trunc")}
                rows = [np.nonzero(inexact_rows(
                    {key: v[i] for key, v in keys.items()}
                    | {"derived": passes[k][1]}, lengths, med))[0]
                    for i, k in enumerate(chunks)]
                kk = torch.from_numpy(np.repeat(
                    chunks, [len(r) for r in rows])).to(dev)
                rr = torch.from_numpy(np.concatenate(rows)).to(dev)
                got = {key: stage[key][kk, rr].cpu().numpy()
                       for key in FIELDS}
                end = 0
                for k, r in zip(chunks, rows):
                    at = slice(end, end + len(r))
                    end += len(r)
                    part = {key: v[at] for key, v in got.items()}
                    part["derived"] = passes[k][1]
                    self.engines[k].rescue_pass(reads[r], lengths[r], part)
                    for key in FIELDS:
                        got[key][at] = part[key]
                for key in FIELDS:
                    stage[key][kk, rr] = torch.from_numpy(got[key]).to(dev)
                # inside the ladder's spans: `chunked.merge` opens once a
                # block, and chunked.index_gib counts blocks by it
                res, _ = self._fetch_merged(self._merge_stage(stage, ln))
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
        """Drop every engine, its graphs, the chunk indexes and the staging
        sets."""
        self.engines = self.engine = self.resident = None
        self._free, self._base = [], None
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
