"""Banded affine-gap local Smith-Waterman over a batch of pairs.

Counterpart of biokanga_tpu/ops/pallas_sw.py.  Each pair aligns a query
a[p] against a band of its target around the diagonal diag[p]: band
column k in [0, K), K = 2W+1, of query row i is target position
j = i + k - W + diag[p].  `normalize_band` cuts each target's band window
once, bwin[p, t] = b[p, t - W + diag[p]] (4 outside the target), so row i
reads bwin[p, i : i + K] and validity is jlo <= i + k - W < jhi.

    banded_sw_moves(a, bwin, alen, jlo, jhi, W) -> best, best_i, best_k, mv
    banded_sw_score(a, bwin, alen, jlo, jhi, W) -> best, best_i, best_k

The DP and its move codes are the JAX kernels' (see csrc/banded_sw.cu for
the recurrence).  `mv` is (B, ceil(La/16), K) int32: word [p, i >> 4, k]
holds the 2-bit code of row i, column k at bit 2*(i & 15), STOP past
alen.  This plane layout is the port's own contract with
ops/sw_trace.traceback_cols_packed; the JAX package pads the columns to
256 lanes and the rows to a multiple of 128, which changes no decoded
output.

On a CUDA tensor each wrapper launches csrc/banded_sw.cu (one warp a
pair up to W = 255, one block a pair with the band in registers up to
W = 4,095, past that one block a pair walking the band in segments with
its state row in shared memory or, where that does not fit, in a scratch
row of device memory allocated here) or raises; on a CPU tensor it runs
the plain version beside it, a loop over query rows in torch over (B, K)
tensors.  Both take any W and refuse the same scoring and shapes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .sw import (
    DEFAULT_GAP_EXT,
    DEFAULT_GAP_OPEN,
    DEFAULT_MATCH,
    DEFAULT_MISMATCH,
    NEG,
    TB_DIAG,
    TB_LEFT,
    TB_STOP,
    TB_UP,
)

# widest band of csrc/banded_sw.cu's one-warp path (K = 2W+1 <= 16 * 32)
MAX_SW_BAND = 255


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_window_len(La: int, W: int) -> int:
    """Columns of a band window: every row i < round_up(La, 16) reads
    bwin[i : i + 2W + 1]."""
    return _round_up(La, 16) + 2 * W + 1


def normalize_band(b: torch.Tensor, blen: torch.Tensor, diag: torch.Tensor,
                   La: int, W: int):
    """Per-pair target band windows on b's device.

    b (B, Lb) int8 targets; blen, diag (B,) ints.  Returns bwin (B, T)
    int8 with bwin[p, t] = b[p, t - W + diag[p]] (4 outside [0, blen)),
    T = band_window_len(La, W), and the int32 bounds jlo = -diag,
    jhi = blen - diag."""
    B, Lb = b.shape
    T = band_window_len(La, W)
    diag = diag.to(torch.int64)
    blen = blen.to(torch.int64)
    src = torch.arange(T, device=b.device)[None, :] - W + diag[:, None]
    ok = (src >= 0) & (src < blen[:, None])
    if Lb:
        got = torch.gather(b, 1, src.clamp(0, Lb - 1))
        bwin = torch.where(ok, got, 4).to(torch.int8)
    else:
        bwin = torch.full((B, T), 4, dtype=torch.int8, device=b.device)
    return (bwin, (-diag).to(torch.int32), (blen - diag).to(torch.int32))


def _check(name: str, a, bwin, alen, jlo, jhi, W: int, match: int,
           gap_open: int) -> None:
    if match + gap_open >= 0:
        # pallas_sw.py:373: the lazy-F out-of-band invariant needs it
        raise ValueError(
            f"{name}: custom scoring with match + gap_open >= 0 breaks the "
            f"lazy-F out-of-band invariant")
    if W < 0:
        raise ValueError(f"{name}: band half-width {W} is negative")
    if a.dim() != 2 or a.dtype != torch.int8:
        raise ValueError(f"{name}: a must be (B, La) int8, got "
                         f"{tuple(a.shape)} {a.dtype}")
    B, La = a.shape
    T = band_window_len(La, W)
    want = {"bwin": (bwin, torch.int8, (B, T)),
            "alen": (alen, torch.int32, (B,)),
            "jlo": (jlo, torch.int32, (B,)),
            "jhi": (jhi, torch.int32, (B,))}
    for arg, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype}, "
                             f"want {shape} {dtype}")
        if t.device != a.device:
            raise ValueError(f"{name}: {arg} on {t.device}, a on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {a.device}")


def _sw_plain(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open,
              gap_ext, moves: bool):
    """Row loop of the banded DP over (B, K) int32 tensors."""
    B, La = a.shape
    K = 2 * W + 1
    dev = a.device
    i32 = torch.int32
    ks = torch.arange(K, dtype=i32, device=dev)
    run_k = -gap_ext * ks                     # H0 - k * gap_ext
    f_k = gap_ext * ks + gap_open - gap_ext
    neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    H = torch.zeros((B, K), dtype=i32, device=dev)
    E = torch.full((B, K), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bk = torch.zeros(B, dtype=i32, device=dev)
    mv = (torch.zeros((B, -(-La // 16), K), dtype=i32, device=dev)
          if moves else None)
    alen64 = alen.to(torch.int64)[:, None]
    lo = jlo.to(torch.int64)[:, None]
    hi = jhi.to(torch.int64)[:, None]
    ks64 = ks.to(torch.int64)
    n_rows = min(La, int(alen.max())) if B else 0   # rows past alen: NEG
    for i in range(n_rows):
        ai = a[:, i : i + 1].to(i32)
        bj = bwin[:, i : i + K].to(i32)
        j = i + ks64 - W
        in_band = (j >= lo) & (j < hi) & (i < alen64)
        sub = torch.where((ai == bj) & (ai < 4) & (bj < 4), match, mismatch
                          ).to(i32)
        E = torch.maximum(torch.cat([H[:, 1:], neg], 1) + gap_open,
                          torch.cat([E[:, 1:], neg], 1) + gap_ext)
        Hd = H + sub
        H0 = torch.maximum(torch.maximum(Hd, E).clamp_min(0),
                           sub.clamp_min(0))
        run = torch.cummax(H0 + run_k, dim=1).values
        F = torch.cat([neg, run[:, :-1]], 1) + f_k
        H = torch.maximum(H0, F).clamp_min(0)
        H = torch.where(in_band, H, NEG)
        E = torch.where(in_band, E, NEG)
        if moves:
            pos = H > 0
            code = torch.where(
                (H == Hd) & pos, TB_DIAG, torch.where(
                    (H == E) & pos, TB_UP, torch.where(
                        (H == F) & pos, TB_LEFT, TB_STOP))).to(i32)
            mv[:, i >> 4] |= code << (2 * (i & 15))
        rb = H.max(1).values
        rk = torch.where(H == rb[:, None], ks, K).min(1).values
        better = rb > best
        best = torch.where(better, rb, best)
        bi = torch.where(better, i, bi)
        bk = torch.where(better, rk, bk)
    return best, bi, bk, mv


def banded_sw_moves_plain(a, bwin, alen, jlo, jhi, W: int,
                          match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                          gap_open=DEFAULT_GAP_OPEN, gap_ext=DEFAULT_GAP_EXT):
    _check("banded_sw_moves", a, bwin, alen, jlo, jhi, W, match, gap_open)
    return _sw_plain(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open,
                     gap_ext, moves=True)


def banded_sw_score_plain(a, bwin, alen, jlo, jhi, W: int,
                          match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                          gap_open=DEFAULT_GAP_OPEN, gap_ext=DEFAULT_GAP_EXT):
    _check("banded_sw_score", a, bwin, alen, jlo, jhi, W, match, gap_open)
    return _sw_plain(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open,
                     gap_ext, moves=False)[:3]


def _launch(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open, gap_ext,
            moves: bool):
    B, La = a.shape
    dev = a.device
    outs = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    mv = (torch.empty((B, -(-La // 16), 2 * W + 1), dtype=torch.int32,
                      device=dev) if moves else None)
    if B:
        args = [t.contiguous() for t in (a, bwin, alen, jlo, jhi)]
        lib = kernels.library()
        with torch.cuda.device(dev):
            # past what shared memory holds, each pair's state row (H, E
            # and, with moves, the code words of its 2W+1 columns)
            ints = ctypes.c_longlong(0)
            kernels.check(lib.banded_sw_scratch(W, int(moves),
                                                ctypes.byref(ints)),
                          "banded_sw_scratch")
            scratch = (torch.empty((B, ints.value), dtype=torch.int32,
                                   device=dev) if ints.value else None)
            err = lib.banded_sw(
                *[t.data_ptr() for t in args], *[o.data_ptr() for o in outs],
                None if mv is None else mv.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, La,
                args[1].shape[1], W, match, mismatch, gap_open, gap_ext,
                kernels.stream_ptr(dev))
        kernels.check(err, "banded_sw")
    return (*outs, mv)


def banded_sw_moves(a, bwin, alen, jlo, jhi, W: int, match=DEFAULT_MATCH,
                    mismatch=DEFAULT_MISMATCH, gap_open=DEFAULT_GAP_OPEN,
                    gap_ext=DEFAULT_GAP_EXT):
    """(best, best_i, best_k) (B,) int32 and the move planes mv.

    a (B, La) int8 queries (4 past alen); bwin (B, T) int8 band windows
    and jlo, jhi (B,) int32 from normalize_band; alen (B,) int32."""
    _check("banded_sw_moves", a, bwin, alen, jlo, jhi, W, match, gap_open)
    if a.device.type == "cpu":
        return _sw_plain(a, bwin, alen, jlo, jhi, W, match, mismatch,
                         gap_open, gap_ext, moves=True)
    out = _launch(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open,
                  gap_ext, moves=True)
    if a.shape[0]:
        banded_sw_moves.launches += 1
    return out


banded_sw_moves.launches = 0


def banded_sw_score(a, bwin, alen, jlo, jhi, W: int, match=DEFAULT_MATCH,
                    mismatch=DEFAULT_MISMATCH, gap_open=DEFAULT_GAP_OPEN,
                    gap_ext=DEFAULT_GAP_EXT):
    """(best, best_i, best_k) (B,) int32: banded_sw_moves without moves."""
    _check("banded_sw_score", a, bwin, alen, jlo, jhi, W, match, gap_open)
    if a.device.type == "cpu":
        return _sw_plain(a, bwin, alen, jlo, jhi, W, match, mismatch,
                         gap_open, gap_ext, moves=False)[:3]
    out = _launch(a, bwin, alen, jlo, jhi, W, match, mismatch, gap_open,
                  gap_ext, moves=False)
    if a.shape[0]:
        banded_sw_score.launches += 1
    return out[:3]


banded_sw_score.launches = 0
