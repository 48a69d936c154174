"""Genome-scale suffix-prefix overlap discovery on the device.

Counterpart of biokanga_tpu/assembly/scale_overlap.py, with the same
results.  The host-verified pass (assembly/overlap.py) loops over
candidates on the host, fine at 10^3 sequences and hopeless at the 10^6
reads of a real readset (the reference assembles multi-Mbp readsets via
its packed sparse index, CKangadna::GenRdsSfx biokanga/Kangadna.cpp:6391,
CdeNovoAssemb::BuildOverlapExtensions deNovoAssemb.cpp:939).  Here every
step of a pass is tensor work:

  1. the CURRENT sequence set, both orientations, is concatenated into
     one "genome" whose entries are the sequences and suffix-indexed on
     the device (index/device_build.device_build_index);
  2. queries = every sequence in both orientations, k-mers at a few
     prefix anchor offsets; one batched range lookup and candidate
     diagonal dedup (the aligner's own _strand_candidates: the seed
     kernels and #1), with the queries' packed words;
  3. a candidate diagonal d implies target entry e, shift = d - start[e],
     overlap ov = len[e] - shift; the first ov query bases are verified
     by the windowed Hamming kernel (ops/extend_packed.
     hamming_extend_packed_win, #3w);
  4. the winner per target is chosen on the device: a scatter-max of a
     packed (overlap << shift_bits | query) score, then a recomputed
     sweep that counts the candidates tying the winner's overlap and
     keeps their least substitution count (scatter add and min), so only
     O(n) winner arrays reach the host.

Both orientations of every sequence are targets (entries 0..n-1 fwd,
n..2n-1 rc), so the overlap graph is bidirected: a dovetail whose left
piece is stored reverse-complemented is found as a right extension of
that piece's rc target.  Greedy-merge semantics match
assembly/assemble.one_pass: a target merges with its single best
(longest-overlap) right extension; a tie on overlap length disqualifies
the target; an extension source may attach to only one target.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..align.params import DerivedParams
from ..align.pipeline import _strand_candidates
from ..index.device_build import device_build_index
from ..ops.extend_packed import BASES_PER_WORD, hamming_extend_packed_win
from ..seq.encode import revcomp
from ..utils.trace import span

# queries are verified over at most this prefix window; dovetails longer
# than this (giant contig-contig overlaps) are rejected conservatively
VERIFY_CAP = 4096
_BIG = 1 << 30


@dataclass
class PassEdges:
    """Per-target winning right-extension (host arrays, length 2n).

    win_q >= n encodes the reverse-complement orientation of query
    (win_q - n).  ambiguous targets (a tie at the best overlap, or an
    overlap at the score-packing cap) must not be merged."""
    win_q: np.ndarray
    win_ov: np.ndarray
    win_subs: np.ndarray
    ambiguous: np.ndarray


def _sweep_batch(didx, starts32, lens32, qseq, qlen, qid0: int,
                 min_ov: int, sub_per100: int, best, tie_cnt, win_subs, *,
                 H: int, cap: int, shift_bits: int, offsets, core_len: int,
                 phase: str) -> None:
    """One query batch through candidates -> verify -> scatter, updating
    the (2n,) int32 winner tensors in place.

    phase='max': scatter-max packed (ov << shift_bits | qid) into best.
    phase='tie': recompute and count candidates whose ov equals the
    winner's, recording the minimum substitution count among them."""
    dp = DerivedParams(read_len=int(qseq.shape[1]), max_tot_mm=0,
                       core_len=core_len, core_delta=core_len,
                       max_slides=len(offsets), offsets=tuple(offsets))
    diag, valid, _, _, rcodes, rnlane = _strand_candidates(
        didx, qseq, qlen, False, dp, H, cap)
    i32 = torch.int32
    ent = torch.searchsorted(starts32, diag, right=True).to(i32) - 1
    entc = torch.clamp(ent, 0, lens32.shape[0] - 1).long()
    shift = diag - starts32[entc]
    ov = lens32[entc] - shift
    ovc = torch.clamp(ov, 0, VERIFY_CAP)
    mm = hamming_extend_packed_win(didx.packed, starts32, diag, valid,
                                   rcodes, rnlane, ovc)
    budget = torch.div(ovc * sub_per100, 100, rounding_mode="floor")
    n_half = lens32.shape[0] // 2          # physical sequence count
    base_t = torch.where(entc >= n_half, entc - n_half, entc)
    qid_col = qid0 + torch.arange(qseq.shape[0], dtype=i32,
                                  device=qseq.device)[:, None]
    base_q = torch.where(qid_col >= n_half, qid_col - n_half, qid_col)
    acc = (valid & (shift >= 0) & (ov >= min_ov) & (ov < qlen[:, None])
           & (ov <= VERIFY_CAP) & (mm <= budget)
           & (base_t != base_q))           # no self / fold-back joins
    ovs = torch.clamp(ov, max=(2**31 - 1) >> shift_bits)
    tid = torch.where(acc, entc, 0).reshape(-1)
    if phase == "max":
        score = (ovs << shift_bits) | qid_col
        best.scatter_reduce_(0, tid, torch.where(acc, score, -1).reshape(-1),
                             "amax")
        return
    b_ov = best[tid].reshape(acc.shape) >> shift_bits
    is_tie = acc & (ovs == b_ov)
    t0 = torch.where(is_tie, tid.reshape(acc.shape), 0).reshape(-1)
    tie_cnt.scatter_add_(0, t0, is_tie.reshape(-1).to(i32))
    win_subs.scatter_reduce_(0, t0, torch.where(is_tie, mm, _BIG).reshape(-1),
                             "amin")


def best_right_extensions(
    seqs: list[np.ndarray],
    min_overlap: int,
    max_subs_per_100: float = 1.0,
    k: int = 16,
    anchors: tuple = (0, 8, 16, 32),
    H: int = 32,
    batch: int = 4096,
    lut_bases: int = 12,
    device: torch.device | str = "cuda",
) -> PassEdges:
    """One pass of device-batched overlap discovery over the whole
    sequence set.  Targets AND queries are both orientations; returned
    winner arrays have length 2n (oriented targets: t < n fwd, t >= n
    rc), with win_q likewise oriented."""
    n = len(seqs)
    lens1 = np.fromiter((len(s) for s in seqs), np.int64, n)
    lens = np.concatenate([lens1, lens1])
    starts = np.zeros(2 * n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    with span("asm.index"):
        concat = (np.concatenate(seqs + [revcomp(s) for s in seqs]) if n
                  else np.zeros(0, np.int8))
        didx = device_build_index(concat.astype(np.int8), starts,
                                  lut_bases=lut_bases, device=device)
    dev = didx.device
    starts32 = torch.from_numpy(starts.astype(np.int32)).to(dev)
    lens32 = torch.from_numpy(lens.astype(np.int32)).to(dev)

    Lq = int(min(max(int(lens1.max()), k + max(anchors)), VERIFY_CAP))
    Lq = ((Lq + BASES_PER_WORD - 1) // BASES_PER_WORD) * BASES_PER_WORD
    nq = 2 * n
    shift_bits = max(1, int(np.ceil(np.log2(nq + 1))))
    offs = tuple(o for o in anchors if o + k <= Lq)
    cap = min(2 * H * len(offs), 192)

    # every oriented sequence's first Lq bases, N-padded: query row q is
    # entry q of the index genome (fwd 0..n-1, rc n..2n-1), built on the
    # device from the genome it already holds
    col = torch.arange(Lq, device=dev)
    qlen_all = torch.clamp(lens32, max=Lq)
    at = torch.clamp(starts32[:-1, None].long() + col, max=max(
        didx.genome.shape[0] - 1, 0))
    q_all = torch.where(col < qlen_all[:, None], didx.genome[at],
                        torch.full((), 4, dtype=torch.int8, device=dev))

    best = torch.full((nq,), -1, dtype=torch.int32, device=dev)
    tie_cnt = torch.zeros(nq, dtype=torch.int32, device=dev)
    win_subs = torch.full((nq,), _BIG, dtype=torch.int32, device=dev)
    common = dict(H=H, cap=cap, shift_bits=shift_bits, offsets=offs,
                  core_len=k)
    with span("asm.sweep"):
        for phase in ("max", "tie"):
            for orient in (0, 1):
                for b0 in range(0, n, batch):
                    q0 = orient * n + b0
                    q1 = orient * n + min(b0 + batch, n)
                    _sweep_batch(didx, starts32, lens32, q_all[q0:q1],
                                 qlen_all[q0:q1], q0, int(min_overlap),
                                 int(round(max_subs_per_100)), best,
                                 tie_cnt, win_subs, phase=phase, **common)
        best_h = best.cpu().numpy()
    tie_h = tie_cnt.cpu().numpy()
    subs_h = win_subs.cpu().numpy()
    has = best_h >= 0
    mask = (1 << shift_bits) - 1
    win_ov = np.where(has, best_h >> shift_bits, 0).astype(np.int64)
    ov_cap = (2**31 - 1) >> shift_bits
    return PassEdges(
        win_q=np.where(has, best_h & mask, -1).astype(np.int64),
        win_ov=win_ov,
        win_subs=np.where(has, subs_h, 0).astype(np.int64),
        # a capped score cannot prove the true longest overlap -> treat
        # as ambiguous (only reachable for >=2^(31-shift_bits)-base
        # dovetails, i.e. never for read-length sequences)
        ambiguous=(tie_h > 1) | (has & (win_ov >= ov_cap)),
    )
