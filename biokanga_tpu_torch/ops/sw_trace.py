"""Column-aligned traceback decode over packed move planes.

Counterpart of biokanga_tpu/ops/sw_trace.py `traceback_cols_packed`.  It
walks each pair's path up from its best cell through the move planes of
ops/banded_sw.banded_sw_moves and reports, for every query column, what
the target has there:

    out (B, La) int8: 0..3 target base, 4 target N, 5 query base deleted,
        6 not covered by the alignment;
    ins_cnt (B, La+1) int32: target bases inserted before query column c
        sit at index c (index 0 is always 0);
    ins_base (B, La+1, 4) int32: the same insertions by base (N as T).

On a CUDA tensor `traceback_cols_packed` launches csrc/sw_trace.cu (one
warp per pair, the move words of a 64-column window in registers) or
raises; on a CPU tensor it runs
`traceback_cols_packed_plain`, a loop over query rows, bottom up, in torch
over (B, K) tensors that follows the JAX decode line for line.
"""
from __future__ import annotations

import torch

from .. import kernels
from .sw import TB_DIAG, TB_LEFT, TB_UP


def _check(mv, best_i, best_k, bwin, W: int, La: int) -> None:
    K = 2 * W + 1
    if mv.dim() != 3 or mv.dtype != torch.int32 or mv.shape[2] != K \
            or mv.shape[1] * 16 < La:
        raise ValueError(f"traceback_cols_packed: mv is {tuple(mv.shape)} "
                         f"{mv.dtype}, want (B, >= {-(-La // 16)}, {K}) int32")
    B = mv.shape[0]
    for name, t, dtype in (("best_i", best_i, torch.int32),
                           ("best_k", best_k, torch.int32),
                           ("bwin", bwin, torch.int8)):
        if t.dtype != dtype or t.shape[0] != B or t.device != mv.device:
            raise ValueError(f"traceback_cols_packed: {name} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if bwin.dim() != 2 or bwin.shape[1] < La + K - 1:
        raise ValueError(f"traceback_cols_packed: bwin has "
                         f"{tuple(bwin.shape)}, want (B, >= {La + K - 1})")
    if mv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"traceback_cols_packed: unsupported device "
                         f"{mv.device}")


def traceback_cols_packed_plain(mv, best_i, best_k, bwin, W: int, La: int):
    _check(mv, best_i, best_k, bwin, W, La)
    B = mv.shape[0]
    K = 2 * W + 1
    dev = mv.device
    ks = torch.arange(K, device=dev)
    c4 = torch.arange(4, device=dev)
    bi = best_i.to(torch.int64)
    bk = best_k.to(torch.int64)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, La), 6, dtype=torch.int8, device=dev)
    ins_cnt = torch.zeros((B, La + 1), dtype=torch.int32, device=dev)
    ins_base = torch.zeros((B, La + 1, 4), dtype=torch.int32, device=dev)
    top = int(bi.max()) if B else -1          # rows above every start: 6
    for i in range(min(top, La - 1), -1, -1):
        codes = (mv[:, i >> 4, :] >> (2 * (i & 15))) & 3
        start_here = bi == i
        k = torch.where(start_here & ~active, bk, k)
        active = active | start_here
        last_non_l = torch.cummax(torch.where(codes != TB_LEFT, ks, -1),
                                  dim=1).values
        land = torch.gather(last_non_l, 1, k.clamp(0, K - 1)[:, None])[:, 0]
        ok_land = active & (land >= 0)
        lc = land.clamp(0, K - 1)[:, None]
        code2 = torch.gather(codes, 1, lc)[:, 0]
        is_d = ok_land & (code2 == TB_DIAG)
        is_u = ok_land & (code2 == TB_UP)
        tbrow = bwin[:, i : i + K].to(torch.int64)
        tb_land = torch.gather(tbrow, 1, lc)[:, 0]
        tb_land = torch.where(tb_land < 4, tb_land, 4)
        out[:, i] = torch.where(is_d, tb_land,
                                torch.where(is_u, 5, 6)).to(torch.int8)
        ins_m = (active[:, None] & (ks > land[:, None])
                 & (ks <= k[:, None]))
        ins_cnt[:, i + 1] = ins_m.sum(1, dtype=torch.int32)
        tb4 = torch.where(tbrow < 4, tbrow, 4).clamp(0, 3)
        ins_base[:, i + 1] = (ins_m[:, :, None] & (tb4[:, :, None] == c4)
                              ).sum(1, dtype=torch.int32)
        k = torch.where(is_d, land, torch.where(is_u, land + 1, k))
        active = active & (is_d | is_u) & (k >= 0) & (k < K)
    return out, ins_cnt, ins_base


def traceback_cols_packed(mv, best_i, best_k, bwin, W: int, La: int):
    """(out, ins_cnt, ins_base) of the first La query columns.

    mv (B, >= La/16, 2W+1) int32 move planes and best_i, best_k (B,)
    int32 from banded_sw_moves; bwin (B, T) int8 from normalize_band."""
    _check(mv, best_i, best_k, bwin, W, La)
    if mv.device.type == "cpu":
        return traceback_cols_packed_plain(mv, best_i, best_k, bwin, W, La)
    B, Wd, K = mv.shape
    dev = mv.device
    out = torch.empty((B, La), dtype=torch.int8, device=dev)
    ins_cnt = torch.empty((B, La + 1), dtype=torch.int32, device=dev)
    ins_base = torch.empty((B, La + 1, 4), dtype=torch.int32, device=dev)
    if B:
        args = [t.contiguous() for t in (mv, best_i, best_k, bwin)]
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.sw_trace_packed(
                *[t.data_ptr() for t in args], out.data_ptr(),
                ins_cnt.data_ptr(), ins_base.data_ptr(), B, La, Wd, K,
                args[3].shape[1], kernels.stream_ptr(dev))
        kernels.check(err, "sw_trace_packed")
        traceback_cols_packed.launches += 1
    return out, ins_cnt, ins_base


traceback_cols_packed.launches = 0
