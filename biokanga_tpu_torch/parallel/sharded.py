"""Sharded alignment over a mesh of ranks (torch.distributed).

Counterpart of biokanga_tpu/parallel/sharded.py, with the same results.
The reference distributes work through worker read batches and the BKS
TCP SW service (SURVEY.md §5); the JAX package runs one program over a
(dp, sp) device mesh, and here each point of the mesh is one process
(parallel/dist.py):

    dp — read blocks, data-parallel: rank (d, s) aligns dp block d;
    sp — the genome, sharded by range: rank (d, s) holds chunk s of a
         ChunkedIndex (index/chunked.py) on its device, and nothing else
         of the index, and runs the single-device align_core
         (align/pipeline.py) against it.

Chunk ownership (an alignment starts below `owned`) makes the chunks'
candidate sets disjoint, so the merge over sp is exact: the per-read
summaries (best, next, instances, strand, locus, the ladder flags and the
top-K multi-hit list) are all-gathered over the rank's sp group and
reduced with the rules of parallel/chunked.merge_chunk_results, on the
rank's device.  Loci stay (chunk, local int32) pairs on the device; the
host composes int64 global loci (ShardedAligner.align).

Each rank aligns the rows of its own dp block (`Mesh.rows` cuts them from
a batch) and returns them; `gather_results` joins the blocks on rank 0 in
the global read order, where the JAX call returns the whole batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..align.params import AlignParams
from ..align.pipeline import (
    align_core,
    mismatch_budget,
    pad_rows,
    rescue_ladder,
    scan_fallthrough,
)
from ..align.snp import pileup_batch
from ..index.chunked import ChunkedIndex, chunk_to_device
from ..index.device import DeviceIndex
from ..ops.extend import MM_INVALID
from ..ops.sort import sort2_rows
from .dist import Mesh, all_gather_sp, gather_results, sum_dp

__all__ = ["ChunkShardedIndex", "ShardedAligner", "build_sharded_align_fn",
           "build_sharded_fallthrough_fn", "build_sharded_pileup_fn",
           "combine_pileup_planes", "gather_results", "shard_chunked_index"]

NEG_SCORE = -(1 << 20)   # scan_fallthrough's score where a row is not ok


@dataclass
class ChunkShardedIndex:
    """This rank's chunk of a ChunkedIndex on its device, and the host
    arrays every rank keeps."""

    didx: DeviceIndex        # chunk `sp`, padded to the chunks' shapes
    n_sp: int
    bases: np.ndarray        # (n_sp,) int64 global chunk offsets
    slice_lens: np.ndarray   # (n_sp,) int64 real (unpadded) slice lengths
    entry_starts_global: np.ndarray  # (E+1,) int64
    entry_names: list[str]
    pad_n: int

    @property
    def total_len(self) -> int:
        return int(self.entry_starts_global[-1])


def shard_chunked_index(ci: ChunkedIndex, mesh: Mesh) -> ChunkShardedIndex:
    """Put chunk mesh.sp of ci, padded to ci.pad_shapes(), on the rank's
    device.  ci.num_chunks must equal n_sp (build with num_chunks=n_sp)."""
    if ci.num_chunks != mesh.n_sp:
        raise ValueError(
            f"chunk count {ci.num_chunks} != sp shards {mesh.n_sp}; build "
            "the index with build_chunked_index(..., num_chunks=n_sp)")
    shapes = ci.pad_shapes()
    return ChunkShardedIndex(
        didx=chunk_to_device(ci, mesh.sp, shapes, mesh.device),
        n_sp=mesh.n_sp,
        bases=ci.bases.copy(),
        slice_lens=np.asarray([c.total_len for c in ci.chunks], np.int64),
        entry_starts_global=ci.entry_starts.copy(),
        entry_names=list(ci.entry_names),
        pad_n=shapes[0],
    )


def _winner(key: torch.Tensor, better) -> torch.Tensor:
    """Index along axis 0 of the winner per column: chunk k replaces the
    current winner only where better(key[k], current) (earlier chunks win
    ties)."""
    cur = key[0]
    k_star = torch.zeros_like(cur)
    for k in range(1, key.shape[0]):
        b = better(key[k], cur)
        k_star = torch.where(b, k, k_star)
        cur = torch.where(b, key[k], cur)
    return k_star


def _take(a: torch.Tensor, k_star: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 0, k_star.to(torch.int64)[None])[0]


def merge_over_sp(mesh: Mesh, res: dict, lengths: torch.Tensor,
                  ap: AlignParams) -> dict:
    """Exact merge of this rank's align_core result with those of its sp
    group (biokanga_tpu/parallel/sharded.py:177-260): one all-gather of
    an (B, 8 + 2K) int32 summary, then the merge on the rank's device."""
    i32 = torch.int32
    summary = torch.cat([
        torch.stack([res[k].to(i32) for k in (
            "best_mm", "next_mm", "inst", "is_rc", "locus", "overflow",
            "n_over", "cap_trunc")], 1),
        res["ml_mm"].to(i32) * 2 + res["ml_rc"].to(i32),
        res["ml_loci"].to(i32)], 1)
    return merge_gathered(all_gather_sp(mesh, summary), lengths, ap)


def merge_gathered(g: torch.Tensor, lengths: torch.Tensor,
                   ap: AlignParams) -> dict:
    """The merge over sp of the gathered (n_sp, B, 8 + 2K) int32 summaries
    (merge_over_sp's layout: the eight per-read fields, then K keys
    mm * 2 + rc, then K loci)."""
    i32 = torch.int32
    K = (g.shape[2] - 8) // 2
    best, nxt, inst, rc, loc, ovf, n_over, cap_trunc = g[..., :8].unbind(-1)
    okey = best * 2 + rc
    # chunk order is global-locus order at equal (mm, strand): strictly
    # less suffices, the earlier chunk wins ties
    k_star = _winner(okey, lambda a, b: a < b)
    cur_key = _take(okey, k_star)
    b_star = cur_key >> 1
    is_best = best == b_star[None]
    inst_star = torch.where(is_best, inst, 0).sum(0, dtype=i32)
    # no valid candidate anywhere: keep the winner's count verbatim
    inst_star = torch.where(b_star >= MM_INVALID, _take(inst, k_star),
                            inst_star)
    next_star = torch.where(is_best, nxt, best).min(0).values
    next_star = torch.where(inst_star >= 2, b_star, next_star)
    # canonical saturation at best + MMDelta (merge_chunk_results)
    next_star = torch.minimum(next_star, b_star + ap.min_edit_dist)
    any_hit = b_star <= mismatch_budget(lengths, ap)
    unique = any_hit & ((next_star - b_star) >= ap.min_edit_dist)

    # top-K multi-hit union: a sort by (mm*2+rc, chunk, local locus), the
    # first two keys folded into one (chunk < n_sp; 511 * n_sp < 2^31).
    # Rows of K x n_sp pairs past 16,384 take the sort's wide path.
    n_sp, B = g.shape[:2]
    chunk = torch.arange(n_sp, dtype=i32, device=g.device)[:, None, None]
    key = (g[..., 8:8 + K] * n_sp + chunk).permute(1, 0, 2).reshape(B, -1)
    loci = g[..., 8 + K:].permute(1, 0, 2).reshape(B, -1)
    s_key, s_loc = sort2_rows(key.contiguous(), loci.contiguous())
    s_key = s_key[:, :K]
    ml_key = s_key // n_sp
    return {
        "unique": unique,
        "any_hit": any_hit,
        "best_mm": torch.clamp(b_star, max=MM_INVALID).to(torch.uint8),
        "next_mm": torch.clamp(next_star, max=MM_INVALID).to(torch.uint8),
        "inst": inst_star,
        "locus": _take(loc, k_star),
        "chunk": k_star,
        "is_rc": (cur_key & 1).to(torch.bool),
        "overflow": (ovf != 0).any(0),
        # a hidden hit lives in one chunk: the worst chunk's skip count
        "n_over": n_over.max(0).values,
        "cap_trunc": (cap_trunc != 0).any(0),
        "ml_loci": s_loc[:, :K],
        "ml_chunk": s_key % n_sp,
        "ml_mm": torch.clamp(ml_key >> 1, max=255).to(torch.uint8),
        "ml_rc": (ml_key & 1).to(torch.bool),
    }


def build_sharded_align_fn(mesh: Mesh, sidx: ChunkShardedIndex,
                           params: AlignParams, dp_params, H: int,
                           cand_cap: int | None = None,
                           occ_skip: bool = True):
    """step(reads (B, L) int8, lengths (B,) int32 on the rank's device, the
    rows of its dp block) -> the merged result dict of device tensors,
    exact single-index semantics, loci as (chunk, local)."""
    cap = int(cand_cap or params.max_cand_per_strand)

    def step(reads: torch.Tensor, lengths: torch.Tensor) -> dict:
        res = align_core(sidx.didx, reads, lengths, ap=params, dp=dp_params,
                         H=H, cand_cap=cap, strand=params.strand,
                         occ_skip=occ_skip)
        return merge_over_sp(mesh, res, lengths, params)

    return step


_SCAN_KEYS = ("ok", "score", "mm", "split", "locus", "is_rc", "op", "gaplen")


def build_sharded_fallthrough_fn(mesh: Mesh, sidx: ChunkShardedIndex,
                                 params: AlignParams, dp_params,
                                 micro_indel_len: int,
                                 splice_junct_len: int):
    """step(reads, lengths of leftover rows) -> the micro-indel and splice
    scans' best per row over every chunk: each rank scans its chunk
    (align/pipeline.scan_fallthrough), the winners merge by score over sp
    (the earlier chunk wins ties) — the -a/-A fall-through of
    SfxArrayV2.cpp:7663-7760 on the mesh."""

    def step(reads: torch.Tensor, lengths: torch.Tensor) -> dict:
        best = scan_fallthrough(sidx.didx, params, dp_params, reads,
                                lengths, micro_indel_len, splice_junct_len)
        g = all_gather_sp(mesh, torch.stack(
            [best[k].to(torch.int32) for k in _SCAN_KEYS], 1))
        cols = dict(zip(_SCAN_KEYS, g.unbind(-1)))
        scores = cols["score"]
        ks = _winner(scores, lambda a, b: a > b)
        out = {k: _take(v, ks) for k, v in cols.items()}
        top = scores.max(0).values
        out["ok"] = (out["ok"] != 0) & (top > NEG_SCORE)
        out["score"] = top
        out["is_rc"] = out["is_rc"] != 0
        out["chunk"] = ks
        return out

    return step


def build_sharded_pileup_fn(mesh: Mesh, sidx: ChunkShardedIndex):
    """step(chunk, loci, seqs, lengths, accept) of this rank's dp block ->
    (counts (pad_n, 4), match (pad_n,), mismatch (pad_n,)) int32 planes of
    chunk sp in local coordinates, summed over dp (the collective form of
    the reference's per-thread pileup merge, ProcessSNPs,
    Aligner.cpp:7609).  A rank piles up only the accepted alignments that
    live in its chunk; seqs are the aligned-strand codes.
    combine_pileup_planes folds the chunks' planes to global coordinates."""
    didx = sidx.didx
    n = sidx.pad_n

    def step(chunk, loci, seqs, lengths, accept):
        dev = didx.device
        t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)
        counts = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        match = torch.zeros(n, dtype=torch.int32, device=dev)
        mismatch = torch.zeros(n, dtype=torch.int32, device=dev)
        mine = t(accept, np.bool_) & (t(chunk, np.int32) == mesh.sp)
        pileup_batch(counts, match, mismatch, didx.genome,
                     t(loci, np.int32), t(seqs, np.int8),
                     t(lengths, np.int32), mine)
        return (sum_dp(mesh, counts), sum_dp(mesh, match),
                sum_dp(mesh, mismatch))

    return step


def combine_pileup_planes(planes: np.ndarray, sidx: ChunkShardedIndex):
    """Fold per-chunk local planes ((n_sp, pad_n, ...) host array, chunk k
    at index k) into one global array ((total, ...)); copied from
    biokanga_tpu/parallel/sharded.py:478-492.  Every aligned base is
    recorded once, in the chunk that accepted its alignment, so adding
    an overlap tail onto the next chunk's head is exact."""
    total = sidx.total_len
    out = np.zeros((total,) + planes.shape[2:], planes.dtype)
    for k in range(planes.shape[0]):
        b = int(sidx.bases[k])
        sl = int(min(sidx.slice_lens[k], total - b))
        out[b : b + sl] += planes[k, :sl]
    return out


class ShardedAligner:
    """Host driver of the sharded step for this rank's dp block: batches,
    the overflow rescue ladder and int64 global loci, as
    AlignEngine.align_with_rescue gives them on one device.

    Every rank of an sp group must call the same methods with the same
    rows (its dp block): each step gathers over the group."""

    def __init__(self, mesh: Mesh, ci: ChunkedIndex,
                 params: AlignParams | None = None):
        self.mesh = mesh
        self.params = params or AlignParams()
        self.sidx = shard_chunked_index(ci, mesh)
        self._fns = {}

    def _tensors(self, reads, lengths):
        dev = self.mesh.device
        return (torch.from_numpy(np.ascontiguousarray(reads, np.int8)).to(dev),
                torch.from_numpy(np.ascontiguousarray(lengths, np.int32)
                                 ).to(dev))

    def _run(self, reads, lengths, H, cand_cap, occ_skip: bool = True):
        L = int(reads.shape[1])
        key = (L, int(H), int(cand_cap), occ_skip)
        if key not in self._fns:
            dp = self.params.derive(L, self.sidx.total_len)
            self._fns[key] = (build_sharded_align_fn(
                self.mesh, self.sidx, self.params, dp, int(H),
                cand_cap=int(cand_cap), occ_skip=occ_skip), dp)
        fn, dp = self._fns[key]
        out = fn(*self._tensors(reads, lengths))
        res = {k: v.cpu().numpy() for k, v in out.items()}
        res["derived"] = dp
        return res

    def align(self, reads: np.ndarray, lengths: np.ndarray) -> dict:
        """This rank's dp block (B, L) int8 -> its result dict, loci int64."""
        ap = self.params
        res = self._run(reads, lengths, ap.cand_per_core,
                        ap.max_cand_per_strand)
        rescue_ladder(
            lambda r, l, H, cap, skip: self._run(r, l, H, cap, skip),
            reads, lengths, res, ap, extra_keys=("chunk", "ml_chunk"),
        )
        bases = self.sidx.bases
        res["locus"] = bases[res["chunk"]] + res["locus"].astype(np.int64)
        ml = res["ml_loci"].astype(np.int64)
        res["ml_loci"] = np.where(ml >= 0, bases[res["ml_chunk"]] + ml, -1)
        return res

    def align_extended(self, reads: np.ndarray, lengths: np.ndarray,
                       micro_indel_len: int = 0,
                       splice_junct_len: int = 0) -> dict:
        """align() + the sharded micro-indel/splice fall-through for the
        reads the Hamming pass could not accept (-a/-A on the mesh)."""
        res = self.align(reads, lengths)
        B = len(reads)
        res["cigar_op"] = np.zeros(B, np.int64)
        res["op_len"] = np.zeros(B, np.int64)
        res["split"] = np.zeros(B, np.int32)
        if not (micro_indel_len or splice_junct_len):
            return res
        left = np.nonzero(~res["unique"] & ~res["any_hit"])[0]
        if len(left) == 0:
            return res
        sub_r, sub_l = pad_rows(reads[left], lengths[left])
        key = (sub_r.shape[1], micro_indel_len, splice_junct_len,
               "fallthrough")
        if key not in self._fns:
            dp = self.params.derive(int(sub_r.shape[1]), self.sidx.total_len)
            self._fns[key] = (build_sharded_fallthrough_fn(
                self.mesh, self.sidx, self.params, dp, micro_indel_len,
                splice_junct_len), dp)
        fn, _ = self._fns[key]
        out = {k: v.cpu().numpy()
               for k, v in fn(*self._tensors(sub_r, sub_l)).items()}
        acc = np.nonzero(out["ok"])[0]
        acc = acc[acc < len(left)]
        gi = left[acc]
        res["unique"][gi] = True
        res["any_hit"][gi] = True
        res["locus"][gi] = (self.sidx.bases[out["chunk"][acc]]
                            + out["locus"][acc].astype(np.int64))
        res["is_rc"][gi] = out["is_rc"][acc]
        res["best_mm"][gi] = np.minimum(out["mm"][acc], 255).astype(np.uint8)
        res["split"][gi] = out["split"][acc]
        res["cigar_op"][gi] = out["op"][acc]
        res["op_len"][gi] = out["gaplen"][acc]
        return res
