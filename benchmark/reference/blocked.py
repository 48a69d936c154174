"""Plain reference of exhaustive Hamming placement over a genome of
billions of bases, in torch and numpy: `find_hits` of aligner.py, by a
lemma whose index fits one card at any genome size.

It shares no code with the program under test and takes nothing the
program made.  Its result is `aligner.Hits`, and `judge` takes it as it
takes aligner.find_hits's.

The lemma.  Cut a read of L bases into P = M // 2 + 1 disjoint parts of
k = min(L // P, 27) bases, at offsets 0, k, ..., (P - 1) k.  A placement
with at most M mismatches has at most M inside the parts, so some part
has at most M // P <= 1 of them (P parts with two or more would hold
2P > M).  So every placement holds a part whose genome k-mer equals the
part itself or the part with one base changed.  A part's variants are
itself and each single change of one base to another of the five codes
A C G T N (0-4): with N a symbol of the k-mer's code, a mismatch that is
an N on either side is one change like any other.  At 2 x 100 bp and
-s 10 (M = 10): 6 parts of 16 bases, 1 + 4 x 16 = 65 variants a part,
390 a strand of a mate.

The index.  The k-mers are coded in base 5 (5^27 < 2^63) and sorted with
their positions in blocks of the genome of at most `block_len` start
positions, one block at a time, so that the sort of a block of 256 Mbp
takes a few GB of device memory whatever the genome's length.  A block's
k-mers are those that start in it, so the last k - 1 bases of a k-mer
may lie in the next block: every k-mer of the genome is in exactly one
block.  Each variant is looked up in each block; each position found
gives a candidate placement (the position less the part's offset), which
is verified against the whole genome tensor, so no placement is lost at
a block cut.  A placement is a locus where the read lies wholly inside
one entry, as in aligner.py.
"""
from __future__ import annotations

import numpy as np
import torch

from .aligner import Hits, hamming, rc_codes

MAX_K = 27          # 5^27 < 2^63: a base-5 code of k bases fits in int64
SYMBOLS = 5         # A C G T N


def parts(read_len: int, max_mm: int) -> tuple[int, int]:
    """(P, k): the lemma's number of parts and their length."""
    P = max_mm // 2 + 1
    k = min(read_len // P, MAX_K)
    if k < 1:
        raise ValueError(f"{P} parts do not fit {read_len} bases")
    return P, k


def _codes(seq: torch.Tensor, k: int) -> torch.Tensor:
    """Base-5 codes of the k-mers at every start of seq's last axis; codes
    above 4 count as N."""
    m = seq.shape[-1] - k + 1
    code = torch.zeros(seq.shape[:-1] + (m,), dtype=torch.int64,
                       device=seq.device)
    for j in range(k):
        code.mul_(SYMBOLS).add_(seq[..., j:j + m].clamp(max=4))
    return code


def _variants(seq: torch.Tensor, P: int, k: int) -> torch.Tensor:
    """(R, P, 1 + 4k) base-5 codes: each part itself and each single
    change of one of its bases to another of the five symbols."""
    R = seq.shape[0]
    b = seq[:, :P * k].reshape(R, P, k).to(torch.int64).clamp(max=4)
    w = SYMBOLS ** torch.arange(k - 1, -1, -1, device=seq.device)
    code = (b * w).sum(-1)                                    # (R, P)
    sym = torch.arange(SYMBOLS, device=seq.device)
    change = (sym[None, None, None, :] - b[..., None]) * w[:, None]
    keep = sym[None, None, None, :] != b[..., None]           # (R, P, k, 5)
    var = (code[..., None, None] + change)[keep].reshape(R, P, 4 * k)
    return torch.cat([code[..., None], var], dim=-1)


def find_hits(genome: torch.Tensor, entry_starts: np.ndarray,
              reads: torch.Tensor, max_mm: int,
              block_len: int = 256_000_000, span: int | None = None,
              verify: int = 1 << 20) -> Hits:
    """Every placement of each (equal-length) read with at most max_mm
    mismatches, on both strands, sorted by (read, mm, is_rc, locus).
    `span` counts only the first span bases (the control's fault); the
    parts are looked up as always."""
    R, L = reads.shape
    n = genome.numel()
    dev = genome.device
    P, k = parts(L, max_mm)
    starts = torch.as_tensor(np.asarray(entry_starts, np.int64), device=dev)
    windows = genome.unfold(0, L, 1)                       # (n - L + 1, L)
    seqs = [reads, rc_codes(reads)]
    queries = [_variants(s, P, k).reshape(R, -1) for s in seqs]
    V = queries[0].shape[1]
    part_ofs = (torch.arange(V, device=dev) // (1 + 4 * k)) * k
    found = []                                     # (read*2 + rc) * n + locus
    n_kmers = n - k + 1
    for b0 in range(0, n_kmers, block_len):
        b1 = min(b0 + block_len, n_kmers)
        codes, order = torch.sort(_codes(genome[b0:b1 + k - 1], k))
        for rc, q in enumerate(queries):
            lo = torch.searchsorted(codes, q)
            cnt = (torch.searchsorted(codes, q, right=True) - lo).reshape(-1)
            total = int(cnt.sum())
            if total == 0:
                continue
            cell = torch.repeat_interleave(
                torch.arange(cnt.numel(), device=dev), cnt)
            first = torch.cumsum(cnt, 0) - cnt
            slot = lo.reshape(-1)[cell] + (
                torch.arange(total, device=dev) - first[cell])
            diag = order[slot] + b0 - part_ofs[cell % V]
            row = cell // V
            ok = (diag >= 0) & (diag + L <= n)
            found.append(torch.unique((row[ok] * 2 + rc) * n + diag[ok]))
        del codes, order
    if found:
        key = torch.unique(torch.cat(found))
    else:
        key = torch.zeros(0, dtype=torch.int64, device=dev)
    rowrc, diag = key // n, key % n
    same = (torch.searchsorted(starts, diag, right=True)
            == torch.searchsorted(starts, diag + L - 1, right=True))
    rowrc, diag = rowrc[same], diag[same]
    out = []
    for c in range(0, rowrc.numel(), verify):
        rr, d = rowrc[c:c + verify], diag[c:c + verify]
        row, rc = rr // 2, rr % 2
        seq = torch.where(rc[:, None] == 1, seqs[1][row], seqs[0][row])
        mm = hamming(windows[d], seq, span)
        keep = mm <= max_mm
        out.append((row[keep], mm[keep], rc[keep] == 1, d[keep]))
    if not out:
        z = np.zeros(0, np.int64)
        return Hits(z, z.astype(np.int32), z.astype(bool), z)
    read = torch.cat([o[0] for o in out]).cpu().numpy()
    mm = torch.cat([o[1] for o in out]).cpu().numpy()
    is_rc = torch.cat([o[2] for o in out]).cpu().numpy()
    locus = torch.cat([o[3] for o in out]).cpu().numpy()
    order = np.lexsort((locus, is_rc, mm, read))
    return Hits(read[order], mm[order].astype(np.int32), is_rc[order],
                locus[order])
