"""Port of biokanga_tpu/ops/nw.py: batched Needleman-Wunsch global
alignment scores with Gotoh affine gaps (CNeedlemanWunsch,
libbiokanga/NeedlemanWunsch.h:10-13 defaults: match +1, mismatch -1,
gap open -3, gap extend -1).

DP rows advance in a loop with the batch as the leading dimension.  The
within-row horizontal state Y[j] = max(M[j-1]+open, Y[j-1]+ext) is a
max-plus linear recurrence, solved in closed form per row as
ext*j + cummax(M[j-1]+open-ext*j) (`torch.cummax`), so a row is a few
vector ops.  Scores only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

NW_MATCH = 1
NW_MISMATCH = -1
NW_GAP_OPEN = -3
NW_GAP_EXT = -1
_NEG = -(1 << 20)  # cNWScoreMsk clamp scale (NeedlemanWunsch.h:16)


def nw_score_batch(a: np.ndarray, b: np.ndarray,
                   match: int = NW_MATCH, mismatch: int = NW_MISMATCH,
                   gap_open: int = NW_GAP_OPEN,
                   gap_ext: int = NW_GAP_EXT,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """Global alignment scores for B sequence pairs.

    a: (B, La) int8 codes, b: (B, Lb); codes >= 4 never match.
    Returns (B,) int32 scores.  Opening a gap costs gap_open + gap_ext,
    extending costs gap_ext."""
    dev = resolve_device(device)
    a = torch.from_numpy(np.ascontiguousarray(a, np.int8)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(b, np.int8)).to(dev)
    B, La = a.shape
    go = gap_open + gap_ext
    ge = gap_ext
    i32 = torch.int32

    j = torch.arange(La + 1, dtype=i32, device=dev)
    M = torch.where(j == 0, 0, _NEG).to(i32).expand(B, La + 1)
    Y = torch.where(j == 0, _NEG, go + ge * (j - 1)).to(i32).expand(B, La + 1)
    X = torch.full((B, La + 1), _NEG, dtype=i32, device=dev)
    ge_j = (ge * j[1:]).to(i32)                     # (La,)
    neg_col = torch.full((B, 1), _NEG, dtype=i32, device=dev)
    a_ok = a < 4
    for r in range(b.shape[1]):
        sub = torch.where((a == b[:, r:r + 1]) & a_ok, match,
                          mismatch).to(i32)         # (B, La)
        # vertical state (gap consuming b), incl. column 0 boundary
        Xn = torch.maximum(M + go, X + ge)
        # match state from the previous row's diagonal best
        diag = torch.maximum(torch.maximum(M, X), Y)[:, :-1]
        Mn = torch.cat([neg_col, diag + sub], dim=1)
        best_mx = torch.maximum(Mn, Xn)
        # horizontal state: Y[j] = ge*j + cummax_k<=j (bestMX[k-1]+go-ge*k)
        u = best_mx[:, :-1] + go - ge_j[None, :]
        run = torch.cummax(u, dim=1).values
        Y = torch.cat([neg_col, run + ge_j[None, :]], dim=1)
        M, X = Mn, Xn
    final = torch.maximum(torch.maximum(M[:, -1], X[:, -1]), Y[:, -1])
    return final.cpu().numpy()


def nw_score_numpy(a: np.ndarray, b: np.ndarray,
                   match: int = NW_MATCH, mismatch: int = NW_MISMATCH,
                   gap_open: int = NW_GAP_OPEN,
                   gap_ext: int = NW_GAP_EXT) -> int:
    """Scalar reference implementation (test oracle) — full Gotoh with
    three state matrices."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = a.size, b.size
    go = gap_open + gap_ext
    M = np.full((lb + 1, la + 1), _NEG, dtype=np.int64)
    Ix = np.full_like(M, _NEG)
    Iy = np.full_like(M, _NEG)
    M[0, 0] = 0
    for j in range(1, la + 1):
        Iy[0, j] = go + gap_ext * (j - 1)
    for i in range(1, lb + 1):
        Ix[i, 0] = go + gap_ext * (i - 1)
    for i in range(1, lb + 1):
        for j in range(1, la + 1):
            s = match if (a[j - 1] == b[i - 1] and a[j - 1] < 4) \
                else mismatch
            best_prev = max(M[i - 1, j - 1], Ix[i - 1, j - 1],
                            Iy[i - 1, j - 1])
            M[i, j] = best_prev + s
            Ix[i, j] = max(M[i - 1, j] + go, Ix[i - 1, j] + gap_ext)
            Iy[i, j] = max(max(M[i, j - 1], Ix[i, j - 1]) + go,
                           Iy[i, j - 1] + gap_ext)
    return int(max(M[lb, la], Ix[lb, la], Iy[lb, la]))
