"""Least times of the aligner's kernels on one H100, from the inputs alone.

Each kernel's bound is the larger of its bytes over the device memory
bandwidth and its integer operations over the int32 peak.  Bytes count
each input read once and each output written once, as far as these
inputs need them; operations count what the work needs on these inputs,
whatever kernel computes it.  The counts are frozen here: a later kernel
for the same function is held to the same numbers.

Peaks (the card's power limit is printed beside every share):
- HBM_BYTES_PER_S, 3.35 TB/s: NVIDIA's H100 SXM data sheet.
- INT32_OPS_PER_S, 16.73 T/s: derived, not a data-sheet figure: 132 SMs
  x 64 INT32 lanes an SM a clock x 1.98 GHz boost clock (Hopper
  architecture white paper).
"""
from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least time in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def sort_rows_counts(B: int, C: int) -> tuple[int, int]:
    """#1: ascending sort of each row of a (B, C) int32 matrix.  Bytes:
    the matrix in and out.  Operations: C * ceil(log2 C) compares a row,
    the comparison sort's lower bound."""
    return 2 * B * C * 4, B * C * max(0, math.ceil(math.log2(max(C, 1))))


def sort2_rows_counts(B: int, C: int) -> tuple[int, int]:
    """#2: each row of two (B, C) int32 matrices sorted by (key, value).
    Bytes: both in and both out.  Operations as #1."""
    return 2 * 2 * B * C * 4, B * C * max(0, math.ceil(math.log2(max(C, 1))))


def extend_counts(genome_len: int, has_n: bool, entry_starts: torch.Tensor,
                  loci: torch.Tensor, valid: torch.Tensor,
                  lengths: torch.Tensor, words: int) -> tuple[int, int]:
    """#3: packed Hamming counts of (B, C) candidate loci of B reads of
    `words` 16-base words each, against a genome of genome_len bases
    (with an N plane when has_n) split at entry_starts (E + 1,).

    Operations: every candidate tests its flag (1).  A flagged one tests
    its range (2); one inside the genome searches the entry starts (2 a
    step over bit_length(E + 1) steps, and the last compare).  One that
    passes all three counts the words of its read, ceil(len / 16) of
    them: a funnel shift, the XOR and the OR of the read's N lanes, a
    shift, the fold and mask, a popcount and an add (6 a word; with an N
    plane its funnel shift and OR, 8); then the clamp and the store (2).

    Bytes: the flags and the counts out (1 each a candidate), the locus
    of each flagged candidate (4), both packed planes of every read and
    its length (8 a word, 4), the entry starts (4 each), and the genome
    words that the candidates which pass cover, each once (4, and 4 more
    with an N plane)."""
    B, C = loci.shape
    loci = loci.to(torch.int64)
    ln = lengths.to(torch.int64)[:, None]
    last = loci + ln - 1
    starts = entry_starts.to(torch.int64)
    ranged = valid & (loci >= 0) & (last < genome_len)
    passes = ranged & (torch.searchsorted(starts, loci.clamp(min=0),
                                          right=True)
                       == torch.searchsorted(starts, last.clamp(min=0),
                                             right=True))
    row_words = ((ln + 15) // 16).expand(B, C)
    steps = int(starts.numel()).bit_length()
    per_word = 8 if has_n else 6
    n_flag = int(valid.sum())
    n_pass = int(passes.sum())
    ops = (B * C + 2 * n_flag + (2 * steps + 1) * int(ranged.sum())
           + per_word * int(row_words[passes].sum()) + 2 * n_pass)
    w0 = loci[passes] // 16
    w1 = last[passes] // 16
    span = torch.arange(words + 1, device=loci.device)
    cover = w0[:, None] + span[None, :]
    distinct = int(torch.unique(cover[cover <= w1[:, None]]).numel())
    n_bytes = (2 * B * C + 4 * n_flag + 8 * B * words + 4 * B
               + 4 * starts.numel() + 4 * distinct * (2 if has_n else 1))
    return n_bytes, ops
