"""Scoring defaults and move codes of the banded Smith-Waterman.

The constants are copied from biokanga_tpu/ops/sw.py:30-40 (that module
imports jax); banded_sw_batch is its :44-120.
"""
NEG = -(10**7)

# default PacBio-ish scoring (cf. SSW.h defaults: match 1, mismatch -1,
# gap open -3, gap extend -1 in the reference's SW service)
DEFAULT_MATCH = 1
DEFAULT_MISMATCH = -1
DEFAULT_GAP_OPEN = -3
DEFAULT_GAP_EXT = -1

# traceback codes
TB_STOP, TB_DIAG, TB_UP, TB_LEFT = 0, 1, 2, 3


def banded_sw_batch(a, b, alen, blen, diag, W: int, match=DEFAULT_MATCH,
                    mismatch=DEFAULT_MISMATCH, gap_open=DEFAULT_GAP_OPEN,
                    gap_ext=DEFAULT_GAP_EXT, moves: bool = False):
    """Banded affine local SW of a batch of pairs (biokanga_tpu/ops/sw.py:44).

    a (B, La) int8 queries, b (B, Lb) int8 targets, alen, blen, diag (B,)
    int32; pair p aligns a[p, :alen] against the band j in
    [i + diag - W, i + diag + W] of b[p, :blen].  Returns (best, best_i,
    best_k) (B,) int32, the band coordinate k = j - i - diag + W, and, if
    `moves`, the move codes (B, La, 2W+1) uint8 (TB_* codes), else None.
    The best cell is the first row to reach the best score, then the
    lowest k of that row.

    On a CUDA tensor it runs kernel #6 (ops/banded_sw.banded_sw_score), or
    #5 (banded_sw_moves) when moves are asked for, on the band windows of
    ops/banded_sw.normalize_band, and unpacks the 2-bit move planes; on a
    CPU tensor it runs banded_sw_batch_plain.
    """
    if a.device.type == "cpu":
        return banded_sw_batch_plain(a, b, alen, blen, diag, W, match,
                                     mismatch, gap_open, gap_ext, moves)
    import torch

    from .banded_sw import banded_sw_moves, banded_sw_score, normalize_band

    La = a.shape[1]
    bwin, jlo, jhi = normalize_band(b, blen, diag, La, W)
    args = (a.to(torch.int8).contiguous(), bwin, alen.to(torch.int32), jlo,
            jhi, W, match, mismatch, gap_open, gap_ext)
    if not moves:
        return (*banded_sw_score(*args), None)
    best, bi, bk, mv = banded_sw_moves(*args)
    shift = 2 * torch.arange(16, dtype=torch.int32, device=a.device)
    codes = (mv[:, :, None, :] >> shift[None, None, :, None]) & 3
    return best, bi, bk, codes.reshape(a.shape[0], -1, 2 * W + 1)[
        :, :La].to(torch.uint8)


def banded_sw_batch_plain(a, b, alen, blen, diag, W: int,
                          match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                          gap_open=DEFAULT_GAP_OPEN, gap_ext=DEFAULT_GAP_EXT,
                          moves: bool = False):
    """The lazy-F row scan of biokanga_tpu/ops/sw.py:63-120 in torch, a
    loop over query rows on (B, 2W+1) band rows; targets are read by
    position (clipped to the row), not through band windows."""
    import torch

    i32 = torch.int32
    B, La = a.shape
    Lb = b.shape[1]
    K = 2 * W + 1
    dev = a.device
    ks = torch.arange(K, dtype=i32, device=dev)
    neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    H = torch.zeros((B, K), dtype=i32, device=dev)
    E = torch.full((B, K), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bk = torch.zeros(B, dtype=i32, device=dev)
    mv = (torch.zeros((B, La, K), dtype=torch.uint8, device=dev)
          if moves else None)
    a = a.to(i32)
    b = b.to(i32)
    alen = alen.to(torch.int64)
    blen = blen.to(torch.int64)[:, None]
    j0 = diag.to(torch.int64)[:, None] + ks.to(torch.int64) - W
    # rows past every alen hold NEG and STOP codes and cannot move best
    for i in range(min(La, int(alen.max())) if B else 0):
        j = j0 + i
        live = (j >= 0) & (j < blen) & (i < alen)[:, None]
        bj = torch.gather(b, 1, j.clamp(0, max(Lb - 1, 0))) if Lb else \
            torch.full((B, K), 4, dtype=i32, device=dev)
        ai = a[:, i:i + 1]
        sub = torch.where((ai == bj) & (ai < 4) & (bj < 4), match,
                          mismatch).to(i32)
        E = torch.maximum(torch.cat([H[:, 1:], neg], 1) + gap_open,
                          torch.cat([E[:, 1:], neg], 1) + gap_ext)
        Hd = H + sub
        H0 = torch.maximum(torch.maximum(Hd, E).clamp_min(0),
                           sub.clamp_min(0))
        run = torch.cummax(H0 - gap_ext * ks, dim=1).values
        F = (torch.cat([neg, run[:, :-1]], 1) + gap_ext * ks + gap_open
             - gap_ext)
        H = torch.where(live, torch.maximum(H0, F).clamp_min(0), NEG)
        E = torch.where(live, E, NEG)
        if moves:
            pos = H > 0
            mv[:, i] = torch.where(
                (H == Hd) & pos, TB_DIAG, torch.where(
                    (H == E) & pos, TB_UP, torch.where(
                        (H == F) & pos, TB_LEFT, TB_STOP))).to(torch.uint8)
        rb = H.max(1).values
        rk = torch.where(H == rb[:, None], ks, K).min(1).values
        better = rb > best
        best = torch.where(better, rb, best)
        bi = torch.where(better, i, bi)
        bk = torch.where(better, rk, bk)
    return best, bi, bk, mv
