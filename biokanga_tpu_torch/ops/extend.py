"""Dense Hamming extension: candidate windows counted base by base.

Counterpart of biokanga_tpu/ops/extend.py `hamming_extend`, same
contract.  The align engine takes this path only where the packed
extension cannot serve: an index moved without packed rows
(`to_device(pack=False)`) or reads past MAX_PACKED_READ_LEN bases.

The JAX version materialises the (B, C, L) genome windows of every
candidate, B x C x L bytes at once.  Here only the valid candidates are
gathered, in slabs of at most SLAB_BASES window bases, so the peak is
bounded by the slab whatever B, C and L are; a masked candidate gets
MM_INVALID, as in the JAX version.  This is torch code on the tensors'
device (the JAX function is XLA, not a Pallas kernel).
"""
from __future__ import annotations

import torch

from .extend_packed import MM_INVALID

# window bases of one slab (each base holds an int8 window code, an int64
# gather index and a few bool temporaries)
SLAB_BASES = 1 << 24


def hamming_extend(genome, entry_starts, loci, valid, reads, lengths):
    """(B, C) uint8 mismatch counts; MM_INVALID where masked.

    genome (n,) int8 codes (N = 4); entry_starts (E+1,) int32; loci
    (B, C) int32 window starts; valid (B, C) bool; reads (B, L) int8
    (N-padded); lengths (B,) int32.  A candidate is masked unless its
    window [locus, locus + length) lies in one entry of the genome; N on
    either side counts as a mismatch, and counts saturate at 254."""
    n = genome.shape[0]
    B, L = reads.shape
    dev = loci.device
    starts = entry_starts.to(torch.int64)
    loci64 = loci.to(torch.int64)
    last = loci64 + (lengths.to(torch.int64)[:, None] - 1)
    ent_a = torch.searchsorted(starts, loci64.contiguous(), right=True)
    ent_b = torch.searchsorted(starts, last.contiguous(), right=True)
    valid = valid & (loci64 >= 0) & (last < n) & (ent_a == ent_b)

    out = torch.full(loci.shape, MM_INVALID, dtype=torch.uint8, device=dev)
    row, col = valid.nonzero(as_tuple=True)
    step = max(1, SLAB_BASES // max(L, 1))
    span = torch.arange(L, device=dev)
    for s in range(0, row.shape[0], step):
        r, c = row[s:s + step], col[s:s + step]
        win = genome[torch.clamp(loci64[r, c][:, None] + span, 0, n - 1)]
        rd = reads[r]
        live = span[None, :] < lengths[r].to(torch.int64)[:, None]
        mism = ((win != rd) | (win >= 4) | (rd >= 4)) & live
        mm = mism.sum(dim=1)
        out[r, c] = torch.clamp(mm, max=MM_INVALID - 1).to(torch.uint8)
    return out
