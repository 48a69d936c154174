"""Port of biokanga_tpu/ops/shortmatch.py: every genome locus where a
short query matches within a mismatch budget (FindShortApproxMatches/).

The match count at every offset is a correlation of the one-hot genome
with one-hot queries, mismatches(o) = W - sum_j onehot_g[o+j] .
onehot_q[j]: one `torch.nn.functional.conv1d` a genome chunk, as the
JAX package leaves its convolution to XLA.  The inputs are 0 or 1 and
every sum is at most W, so the float32 convolution is exact (also where
cuDNN takes its inputs as TF32).  The genome is scanned in overlapping
chunks of 2^20 bases.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..seq.encode import revcomp


def _conv_mm_chunk(gchunk: torch.Tensor, q1hot: torch.Tensor,
                   W: int) -> torch.Tensor:
    """gchunk (L,) int8; q1hot (B, 4, W) f32 -> (B, L-W+1) mismatches."""
    chans = torch.arange(4, dtype=gchunk.dtype, device=gchunk.device)
    g1hot = (gchunk[None, :] == chans[:, None]).to(torch.float32)[None]
    out = torch.nn.functional.conv1d(g1hot, q1hot)        # (1, B, L-W+1)
    return (W - out[0]).to(torch.int32)


def find_short_matches(
    genome: np.ndarray,
    queries: list[np.ndarray],
    max_mm: int = 2,
    both_strands: bool = True,
    chunk: int = 1 << 20,
    device: str | torch.device = "cuda",
) -> list[tuple[int, int, str, int]]:
    """Return (query_idx, locus, strand, mismatches) for every hit.

    All queries must share one width W; N bases (code 4) in genome or
    query never match any channel, so they count as mismatches."""
    W = len(queries[0])
    if any(len(q) != W for q in queries):
        raise ValueError("all queries must share one width")
    dev = resolve_device(device)
    qs = [np.asarray(q, np.int8) for q in queries]
    strands = [(q, "+") for q in qs]
    if both_strands:
        strands += [(revcomp(q), "-") for q in qs]
    B = len(strands)
    q1hot = np.zeros((B, 4, W), np.float32)
    for b, (q, _) in enumerate(strands):
        for c in range(4):
            q1hot[b, c] = q == c
    q1hot_d = torch.from_numpy(q1hot).to(dev)

    L = len(genome)
    hits: list[tuple[int, int, str, int]] = []
    step = max(chunk - W + 1, 1)
    for s in range(0, max(L - W + 1, 1), step):
        seg = np.asarray(genome[s: s + chunk], np.int8)
        valid = len(seg) - W + 1
        if valid <= 0:
            break
        mm = _conv_mm_chunk(torch.from_numpy(seg).to(dev), q1hot_d, W)
        bidx, oidx = (mm[:, :valid] <= max_mm).nonzero(as_tuple=True)
        vals = mm[bidx, oidx]
        for b, o, v in zip(bidx.tolist(), oidx.tolist(), vals.tolist()):
            hits.append((b % len(qs), s + o, strands[b][1], v))
    hits.sort(key=lambda h: (h[0], h[1], h[2]))
    return hits
