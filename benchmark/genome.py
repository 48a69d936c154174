"""A configuration's genome, made on the device from the run's seed.

Uniform random bases (codes 0-3, no N) in the configuration's entry
lengths, drawn with a torch.Generator on the device in one call.  The
same seed on the same device gives the same genome.
"""
from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 64) - 1


def entry_starts(entries) -> np.ndarray:
    """(E + 1,) int64 starts of the entries [(name, length), ...]."""
    lens = np.asarray([int(length) for _, length in entries], np.int64)
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def make_genome(entries, seed: int, device) -> tuple[torch.Tensor,
                                                       np.ndarray]:
    """(codes (n,) int8 on device, entry starts (E + 1,) int64)."""
    starts = entry_starts(entries)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    codes = torch.randint(0, 4, (int(starts[-1]),), generator=gen,
                          device=device, dtype=torch.int8)
    return codes, starts
