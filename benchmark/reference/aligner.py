"""Plain reference of paired-end Hamming alignment, in torch and numpy.

It shares no code with the program under test and takes nothing the
program made: it reads the genome codes, the entry starts and the reads
that the benchmark generated, and builds its own seed index.

`find_hits` lists, for every read, every placement with at most M
mismatches on either strand, exhaustively: M + 1 disjoint seeds of
k = L // (M + 1) bases cover the read, so a placement with at most M
mismatches holds at least one seed exactly (pigeonhole), and every
position of every seed's exact matches is verified.  A placement is a
locus where the read lies wholly inside one entry; a mismatch is a
position where read and genome differ or either holds an N (code >= 4).

`answers` turns the hit lists into the aligner's per-mate fields, and
`pair_and_rescue` classifies the pairs and runs the orphan rescue over
the anchor's insert window, as biokanga's paired-end mode defines them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

MM_NONE = 255        # best_mm of a read with no counted placement


def rc_codes(reads: torch.Tensor) -> torch.Tensor:
    """Reverse complement of equal-length rows of base codes (N stays N)."""
    flipped = reads.flip(1)
    return torch.where(flipped >= 4, flipped, 3 - flipped).to(reads.dtype)


def hamming(genome_rows: torch.Tensor, seq: torch.Tensor,
            span: int | None = None) -> torch.Tensor:
    """Mismatches of each row of seq against the genome window beside it,
    over the first `span` bases (all of them when None)."""
    if span is not None:
        genome_rows, seq = genome_rows[:, :span], seq[:, :span]
    diff = (genome_rows != seq) | (genome_rows >= 4) | (seq >= 4)
    return diff.sum(dim=1, dtype=torch.int32)


@dataclass
class SeedIndex:
    k: int
    codes: torch.Tensor      # (m,) int64 sorted k-mer codes, -1 for N
    pos: torch.Tensor        # (m,) int64 genome positions in that order


def build_seed_index(genome: torch.Tensor, k: int) -> SeedIndex:
    """Every k-mer of the genome, sorted by its 2-bit code."""
    n = genome.numel()
    m = n - k + 1
    g = genome.to(torch.int64)
    code = torch.zeros(m, dtype=torch.int64, device=genome.device)
    bad = torch.zeros(m, dtype=torch.bool, device=genome.device)
    for j in range(k):
        w = g[j:j + m]
        code = code * 4 + w.clamp(max=3)
        bad |= w >= 4
    code[bad] = -1
    del g, bad
    codes, pos = torch.sort(code, stable=True)
    return SeedIndex(k, codes, pos)


def _seed_codes(seq: torch.Tensor, offsets: torch.Tensor, k: int):
    """(R, S) codes of the k-mers of seq at offsets; -1 where one holds N."""
    cols = offsets[:, None] + torch.arange(k, device=seq.device)[None, :]
    b = seq[:, cols].to(torch.int64)                      # (R, S, k)
    weights = 4 ** torch.arange(k - 1, -1, -1, device=seq.device)
    code = (b.clamp(max=3) * weights).sum(-1)
    return torch.where((b >= 4).any(-1), -1, code)


@dataclass
class Hits:
    """Every placement with at most M mismatches, one per row, sorted by
    (read, mm, is_rc, locus): the aligner's own order of hits."""
    read: np.ndarray     # int64
    mm: np.ndarray       # int32
    is_rc: np.ndarray    # bool
    locus: np.ndarray    # int64


def find_hits(genome: torch.Tensor, entry_starts: np.ndarray,
              reads: torch.Tensor, max_mm: int, index: SeedIndex,
              span: int | None = None, block: int = 256) -> Hits:
    """Every placement of each (equal-length) read with at most max_mm
    mismatches, on both strands.  `span` counts only the first span bases
    (the control's fault); the seeds always cover the whole read."""
    R, L = reads.shape
    n = genome.numel()
    k = index.k
    if (max_mm + 1) * k > L:
        raise ValueError(f"{max_mm + 1} seeds of {k} bases exceed {L}")
    dev = genome.device
    starts = torch.as_tensor(np.asarray(entry_starts, np.int64), device=dev)
    offsets = torch.arange(max_mm + 1, device=dev) * k
    windows = genome.unfold(0, L, 1)                       # (n - L + 1, L)
    out = []
    for s in range(0, R, block):
        part = reads[s:s + block]
        for is_rc in (False, True):
            seq = rc_codes(part) if is_rc else part
            q = _seed_codes(seq, offsets, k)                # (b, S)
            lo = torch.searchsorted(index.codes, q)
            hi = torch.searchsorted(index.codes, q, right=True)
            cnt = torch.where(q < 0, 0, hi - lo).reshape(-1)
            total = int(cnt.sum())
            if total == 0:
                continue
            cell = torch.repeat_interleave(
                torch.arange(cnt.numel(), device=dev), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            slot = lo.reshape(-1)[cell] + (
                torch.arange(total, device=dev) - first[cell])
            diag = index.pos[slot] - offsets[cell % offsets.numel()]
            row = cell // offsets.numel()
            ok = (diag >= 0) & (diag + L <= n)
            key = torch.unique(row[ok] * (n + 1) + diag[ok])
            row, diag = key // (n + 1), key % (n + 1)
            same = (torch.searchsorted(starts, diag, right=True)
                    == torch.searchsorted(starts, diag + L - 1, right=True))
            row, diag = row[same], diag[same]
            for c in range(0, row.numel(), 1 << 20):
                r, d = row[c:c + (1 << 20)], diag[c:c + (1 << 20)]
                mm = hamming(windows[d], seq[r], span)
                keep = mm <= max_mm
                out.append((r[keep] + s, mm[keep], is_rc, d[keep]))
    if not out:
        z = np.zeros(0, np.int64)
        return Hits(z, z.astype(np.int32), z.astype(bool), z)
    read = np.concatenate([o[0].cpu().numpy() for o in out])
    mm = np.concatenate([o[1].cpu().numpy() for o in out])
    is_rc = np.concatenate([np.full(o[0].numel(), o[2]) for o in out])
    locus = np.concatenate([o[3].cpu().numpy() for o in out])
    order = np.lexsort((locus, is_rc, mm, read))
    return Hits(read[order], mm[order], is_rc[order], locus[order])


def answers(hits: Hits, n_reads: int, min_edit_dist: int,
            max_multi: int) -> dict:
    """The per-read fields of the aligner from the hit lists: a read is
    placed (any_hit) when it has a hit; it is unique when exactly one hit
    has fewer than best + min_edit_dist mismatches; locus and strand are
    its first hit's; ml_* list its first max_multi hits (-1, 255, False
    past them)."""
    K = max(1, max_multi)
    res = {
        "unique": np.zeros(n_reads, bool), "any_hit": np.zeros(n_reads, bool),
        "best_mm": np.full(n_reads, MM_NONE, np.int32),
        "locus": np.full(n_reads, -1, np.int64),
        "is_rc": np.zeros(n_reads, bool),
        "ml_loci": np.full((n_reads, K), -1, np.int64),
        "ml_mm": np.full((n_reads, K), MM_NONE, np.int32),
        "ml_rc": np.zeros((n_reads, K), bool),
    }
    first = np.searchsorted(hits.read, np.arange(n_reads + 1))
    for i in np.nonzero(np.diff(first))[0]:
        lo, hi = first[i], first[i + 1]
        best = hits.mm[lo]
        res["any_hit"][i] = True
        res["best_mm"][i] = best
        res["locus"][i] = hits.locus[lo]
        res["is_rc"][i] = hits.is_rc[lo]
        res["unique"][i] = (
            int((hits.mm[lo:hi] < best + min_edit_dist).sum()) == 1)
        j = min(K, hi - lo)
        res["ml_loci"][i, :j] = hits.locus[lo:lo + j]
        res["ml_mm"][i, :j] = hits.mm[lo:lo + j]
        res["ml_rc"][i, :j] = hits.is_rc[lo:lo + j]
    return res


def classify(m1: dict, m2: dict, len1, len2, entry_starts, pair_min: int,
             pair_max: int, same_strand: bool = False) -> dict:
    """Proper pairs and orphans: a pair is proper when both mates are
    unique on one entry, in FR orientation (forward mate upstream, or on
    one strand with same_strand), with the insert (leftmost start to
    rightmost end) within [pair_min, pair_max]."""
    u1, u2 = m1["unique"], m2["unique"]
    l1, l2 = m1["locus"].astype(np.int64), m2["locus"].astype(np.int64)
    r1, r2 = m1["is_rc"], m2["is_rc"]
    starts = np.asarray(entry_starts, np.int64)
    same_entry = (np.searchsorted(starts, l1, side="right")
                  == np.searchsorted(starts, l2, side="right"))
    if same_strand:
        orient = r1 == r2
    else:
        orient = ((~r1) & r2 & (l1 <= l2)) | (r1 & (~r2) & (l2 <= l1))
    insert = np.maximum(l1 + len1, l2 + len2) - np.minimum(l1, l2)
    proper = (u1 & u2 & same_entry & orient & (insert >= pair_min)
              & (insert <= pair_max))
    return {"proper": proper, "orphan1": u1 & ~u2, "orphan2": u2 & ~u1}


def rescue_window(genome: torch.Tensor, entry_starts: np.ndarray,
                  anchor_loc, anchor_rc, anchor_len, mate: np.ndarray,
                  pair_max: int, max_mm: int, span: int | None = None):
    """Search each orphan mate over its anchor's insert window, on the
    strand opposite the anchor: a forward anchor at a looks for the
    mate's reverse complement at [a, a + W), a reverse anchor ending at e
    for the mate as read at [e - pair_max, e - pair_max + W), with
    W = max(8, pair_max - L).  Accepted where exactly one window locus
    has the least count and it is within max_mm.  Returns (ok, locus,
    is_rc, mm) numpy arrays; the mate's strand is the anchor's other."""
    B, L = mate.shape
    dev = genome.device
    n = genome.numel()
    W = max(8, pair_max - L)
    anchor_loc = np.asarray(anchor_loc, np.int64)
    fwd = ~np.asarray(anchor_rc, bool)
    win0 = np.where(fwd, anchor_loc, anchor_loc + anchor_len - pair_max)
    reads = torch.from_numpy(np.ascontiguousarray(mate, np.int8)).to(dev)
    flip = torch.from_numpy(fwd).to(dev)
    seq = torch.where(flip[:, None], rc_codes(reads), reads)
    loci = (torch.from_numpy(win0).to(dev)[:, None]
            + torch.arange(W, device=dev)[None, :])        # (B, W)
    starts = torch.as_tensor(np.asarray(entry_starts, np.int64), device=dev)
    valid = ((loci >= 0) & (loci + L <= n)
             & (torch.searchsorted(starts, loci, right=True)
                == torch.searchsorted(starts, loci + L - 1, right=True)))
    windows = genome.unfold(0, L, 1)
    safe = torch.where(valid, loci, 0).reshape(-1)
    mm = hamming(windows[safe], seq.repeat_interleave(W, 0), span)
    mm = torch.where(valid.reshape(-1), mm, 1 << 20).reshape(B, W)
    best = mm.min(dim=1).values
    n_best = (mm == best[:, None]).sum(dim=1)
    col = torch.where(mm == best[:, None],
                      torch.arange(W, device=dev)[None, :], W).min(1).values
    ok = (best <= max_mm) & (n_best == 1)
    return (ok.cpu().numpy(), win0 + col.cpu().numpy(), fwd,
            best.cpu().numpy().astype(np.int32))


def pair_and_rescue(genome: torch.Tensor, entry_starts: np.ndarray,
                    m1: dict, m2: dict, reads1: np.ndarray,
                    reads2: np.ndarray, pair_min: int, pair_max: int,
                    max_mm: int, span: int | None = None) -> dict:
    """Classify, rescue each orphan's mate in its anchor's window, and
    classify again.  A rescued mate becomes unique at its window locus
    with its count; its other fields keep their values.  Updates m1, m2
    in place and returns the final classification."""
    L1, L2 = reads1.shape[1], reads2.shape[1]
    cls = classify(m1, m2, L1, L2, entry_starts, pair_min, pair_max)
    for anchor, mate, mate_reads, a_len, key in (
            (m1, m2, reads2, L1, "orphan1"), (m2, m1, reads1, L2, "orphan2")):
        rows = np.nonzero(cls[key])[0]
        if not len(rows):
            continue
        ok, loc, rc, mm = rescue_window(
            genome, entry_starts, anchor["locus"][rows],
            anchor["is_rc"][rows], a_len, mate_reads[rows], pair_max,
            max_mm, span)
        got = rows[ok]
        mate["unique"][got] = True
        mate["locus"][got] = loc[ok]
        mate["is_rc"][got] = rc[ok]
        mate["best_mm"][got] = mm[ok]
    return classify(m1, m2, L1, L2, entry_starts, pair_min, pair_max)
