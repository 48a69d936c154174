"""Suffix-prefix overlap detection between sequences.

Counterpart of biokanga_tpu/assembly/overlap.py, with the same results.
The re-design of the reference's packed-read overlap machinery
(CKangadna::GenRdsSfx sparse index + CdeNovoAssemb::BuildOverlapExtensions,
biokanga/Kangadna.cpp:6391, deNovoAssemb.cpp:939): the current sequence
set is indexed with the same bounded-suffix-array build used for genomes,
query k-mers (at a few anchor offsets, so sequencing errors in the first
bases don't kill the join) are range-looked-up in one batch on the
device, and candidate suffix-prefix overlaps are verified on the host
with a bounded compare.  This is the "sorted-prefix join" plan of
SURVEY §7.3.4; assembly/scale_overlap.py is the readset-scale pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..index.build import build_index
from ..index.device import to_device
from ..ops.lookup import pack_read_kmers, seed_range_lookup


@dataclass
class OverlapCandidates:
    """Seed matches: query-prefix-region k-mer found inside a target."""
    qids: np.ndarray       # (M,) query index
    qoffs: np.ndarray      # (M,) anchor offset within the query
    tids: np.ndarray       # (M,) target sequence index
    toffs: np.ndarray      # (M,) offset of the k-mer within the target


def find_prefix_occurrences(
    seqs: list[np.ndarray],
    queries: np.ndarray,      # (Q, L) int8 padded
    qlens: np.ndarray,
    k: int = 16,
    anchor_offsets: tuple = (0,),
    max_occ: int = 32,
    device: torch.device | str = "cuda",
):
    """Occurrences of each query's k-mer at each anchor offset within the
    sequence set, in (query, anchor, suffix-array) order. Returns
    (OverlapCandidates, index)."""
    idx = build_index([(str(i), s) for i, s in enumerate(seqs)],
                      lut_bases=min(8, k))
    didx = to_device(idx, device, pack=False)
    Q, L = queries.shape
    offs = tuple(o for o in anchor_offsets if o + k <= L)
    qd = torch.from_numpy(np.ascontiguousarray(queries, np.int8)).to(
        didx.device)
    qlh, qll, qhh, qhl, has_n = pack_read_kmers(qd, offs, k)
    start, end = seed_range_lookup(
        didx.key_hi, didx.key_lo, didx.lut, didx.lut_bases,
        qlh, qll, qhh, qhl, core_len=k, max_steps=didx.max_bsearch_steps,
    )
    start = start.cpu().numpy().astype(np.int64)
    size = np.minimum(end.cpu().numpy() - start, max_occ)
    size[has_n.cpu().numpy()] = 0
    size = size.reshape(-1)
    # the (query, anchor, j < size) triples in loop order, vectorised
    row = np.repeat(np.arange(size.size), size)
    j = np.arange(row.size) - np.repeat(np.cumsum(size) - size, size)
    p = idx.pos_sorted[start.reshape(-1)[row] + j].astype(np.int64)
    starts = idx.entry_starts
    e = np.searchsorted(starts, p, side="right") - 1
    S = max(1, len(offs))
    offs_a = np.asarray(offs or (0,), np.int64)
    return (
        OverlapCandidates(row // S, offs_a[row % S], e.astype(np.int64),
                          (p - starts[e]).astype(np.int64)),
        idx,
    )


def verify_overlaps(
    seqs: list[np.ndarray],
    queries: np.ndarray,
    qlens: np.ndarray,
    cands: OverlapCandidates,
    min_overlap: int,
    max_subs_per_100: float = 1.0,
):
    """Check candidates as dovetail overlaps: with the query k-mer at
    anchor offset o matching the target at toff, query position i aligns
    target position (toff - o + i); the overlap runs to the target end
    (length tlen - toff + o) and the query must extend past it.

    Returns (qid, tid, overlap_len, subs) for accepted overlaps,
    deduplicated to the first of each (qid, tid, implied shift)."""
    tlens = np.array([len(s) for s in seqs], np.int64)
    shift = cands.toffs - cands.qoffs           # query i -> target shift+i
    ov = tlens[cands.tids] - shift
    qmax = qlens[cands.qids]
    keep = (shift >= 0) & (ov >= min_overlap) & (ov < qmax)
    if not keep.any():
        return (np.zeros(0, np.int64),) * 4
    qid = cands.qids[keep]
    tid = cands.tids[keep]
    sh = shift[keep]
    ovl = ov[keep]

    seen = set()
    oq, ot, oo, os_ = [], [], [], []
    budget = lambda o: max(0, int(o * max_subs_per_100 / 100.0))
    for i in range(len(qid)):
        key = (int(qid[i]), int(tid[i]), int(sh[i]))
        if key in seen:
            continue
        seen.add(key)
        t = seqs[tid[i]]
        q = queries[qid[i]]
        o = int(ovl[i])
        a = t[int(sh[i]):]
        b = q[:o]
        s = int(np.sum((a != b) | (a >= 4) | (b >= 4)))
        if s <= budget(o):
            oq.append(int(qid[i]))
            ot.append(int(tid[i]))
            oo.append(o)
            os_.append(s)
    return (np.array(oq, np.int64), np.array(ot, np.int64),
            np.array(oo, np.int64), np.array(os_, np.int64))
