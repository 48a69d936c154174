"""Batched seed-range lookup on the 32-base-bounded suffix array.

Counterpart of biokanga_tpu/ops/lookup.py: a prefix LUT gives each query
its bucket, and a fixed-trip binary search over (hi, lo) key pairs finds
the range inside it.  Queries are uint32 values held in int64
(device.u32); the index keys are int32 `device.key32` keys, and the
search flips the queries the same way, so every compare is the unsigned
compare of the JAX package.  Plain torch on every device: there is no
TPU kernel here.
"""
from __future__ import annotations

import torch

from ..device import U32_MASK, key32

# 31 halvings always converge for n < 2^31 elements (fallback bound).
MAX_BSEARCH_STEPS = 31


def _lower_bound(key_hi, key_lo, lo, hi, q_hi, q_lo, strict: bool,
                 steps: int):
    """First index i in [lo0, hi0] with key[i] > q (strict) or >= q; keys
    and queries alike `key32` keys."""
    last = key_hi.shape[0] - 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        # a converged lane may sit at n; its key is never used
        m = torch.clamp(mid, max=last)
        kh = key_hi[m]
        kl = key_lo[m]
        ge = (kl > q_lo) if strict else (kl >= q_lo)
        gt = (kh > q_hi) | ((kh == q_hi) & ge)
        done = lo >= hi
        new_hi = torch.where(gt, mid, hi)
        new_lo = torch.where(gt, lo, mid + 1)
        lo = torch.where(done, lo, new_lo)
        hi = torch.where(done, hi, new_hi)
    return lo


def seed_range_lookup(key_hi, key_lo, lut, lut_bases: int, q_lo_hi, q_lo_lo,
                      q_hi_hi, q_hi_lo, core_len: int = 0,
                      max_steps: int = MAX_BSEARCH_STEPS):
    """(start, end) int64 index ranges: all i with qlow <= key[i] <= qhigh.

    key_hi / key_lo: (n,) int32 sorted `key32` keys; lut: (4^P + 1,)
    int32 bucket starts; queries: int64 unsigned words of any batch shape.
    When core_len <= lut_bases the range is exactly a run of LUT buckets;
    otherwise a binary search of `max_steps` trips inside the bucket."""
    P = lut_bases
    shift = 32 - 2 * P
    lo0 = lut[q_lo_hi >> shift].to(torch.int64)
    hi0 = lut[(q_hi_hi >> shift) + 1].to(torch.int64)
    if 0 < core_len <= P:
        return lo0, hi0
    steps = min(max_steps, MAX_BSEARCH_STEPS)
    start = _lower_bound(key_hi, key_lo, lo0, hi0, key32(q_lo_hi),
                         key32(q_lo_lo), strict=False, steps=steps)
    end = _lower_bound(key_hi, key_lo, lo0, hi0, key32(q_hi_hi),
                       key32(q_hi_lo), strict=True, steps=steps)
    return start, end


def pack_read_kmers(codes: torch.Tensor, offsets, k: int):
    """Pack k bases at each offset of each read into query bounds.

    codes: (B, L) int8; offsets: core offsets, a tuple or an integer
    tensor on codes' device (no host copy then).  Returns (q_lo_hi,
    q_lo_lo, q_hi_hi, q_hi_lo), each (B, S) int64 unsigned words, and a
    (B, S) bool `has_n` marking cores that contain an N."""
    if not 1 <= k <= 32:
        raise ValueError(f"core length {k} outside 1..32")
    dev = codes.device
    idx = (torch.as_tensor(offsets, dtype=torch.int64, device=dev)[:, None]
           + torch.arange(k, device=dev))                     # (S, k)
    bases = codes[:, idx].to(torch.int64)                     # (B, S, k)
    has_n = (bases >= 4).any(dim=2)
    b2 = torch.where(bases >= 4, 0, bases)

    def pack(b):
        shifts = 2 * (15 - torch.arange(b.shape[-1], device=dev))
        return (b << shifts).sum(dim=2)

    hi = pack(b2[..., :16])
    if k > 16:
        lo = pack(b2[..., 16:])
        pad_lo = (1 << (2 * (32 - k))) - 1
        return hi, lo, hi, lo | pad_lo, has_n
    pad_hi = (1 << (2 * (16 - k))) - 1
    zero = torch.zeros_like(hi)
    ones = torch.full_like(hi, U32_MASK)
    return hi, zero, hi | pad_hi, ones, has_n


def rolling_seed_lookup(key_hi, key_lo, lut, pos_flat, seqs: torch.Tensor,
                        k: int, stride: int, S: int, H: int, lut_bases: int,
                        max_steps: int):
    """Seed lookup with rolling k-mer keys (biokanga_tpu/ops/lookup.py:87):
    k shifted adds over the whole (B, L) code matrix, the cores taken at
    every `stride`-th offset, then `seed_range_lookup`.  k <= 16 (one key
    word).  `pos_flat` is the index's sorted positions (the port's
    `DeviceIndex.pos_sorted`, tail-padded).

    Returns (pos (B, S, H) int32 candidate positions, valid (B, S, H)
    bool, size (B, S) int64 range sizes, 0 for a core with an N).  Only
    the valid slots of `pos` are defined as in the JAX package."""
    if not 1 <= k <= 16:
        raise ValueError(f"core length {k} outside 1..16")
    B, L = seqs.shape
    dev = seqs.device
    isn = seqs >= 4
    b = torch.where(isn, 0, seqs).to(torch.int64)
    bp = torch.nn.functional.pad(b, (0, k))
    isn_p = torch.nn.functional.pad(isn, (0, k))
    key = torch.zeros((B, L), dtype=torch.int64, device=dev)
    nwin = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for j in range(k):
        key += bp[:, j:j + L] << (2 * (15 - j))
        nwin |= isn_p[:, j:j + L]
    q_hi = key[:, ::stride][:, :S]
    has_n = nwin[:, ::stride][:, :S]
    pad_hi = (1 << (2 * (16 - k))) - 1
    start, end = seed_range_lookup(
        key_hi, key_lo, lut, lut_bases, q_hi, torch.zeros_like(q_hi),
        q_hi | pad_hi, torch.full_like(q_hi, U32_MASK), core_len=k,
        max_steps=max_steps)
    size = torch.where(has_n, 0, end - start)
    j = torch.arange(H, device=dev)
    idx = (start[..., None] + j).clamp_(0, pos_flat.shape[0] - 1)
    pos = pos_flat[idx].to(torch.int32)
    valid = j < torch.clamp(size, max=H)[..., None]
    return pos, valid, size
