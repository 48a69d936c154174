"""Collinear-chain DP of `blitz` over blocks sorted by (t, q).

Counterpart of biokanga_tpu/tools/blitz.py `_chain_scan` (:158), for a
batch of chains: (C, M) int32 q0, t0, ln, score and valid.  For each i in
order, over the j < i that pass the overlap (> -8) and gap (<= 100,000)
tests on both axes,

    cand_j = f_j - gcost(i, j),  gcost = gap_open + min(gap // 10, 10)
             for gap = max(dq, dt) > 0, else 0
    j*     = argmax cand, the lowest j on ties
    f_i    = score_i + cand_j* if that is > 0, else score_i
             (-10^9 for an invalid i); pred_i = j* or -1.

Results are per chain, so chains of any queries, strands and entries
share one call; padding a chain to a wider M changes none of its values.

On a CUDA tensor `chain_scan` launches csrc/blitz_chain.cu (a warp a
narrow chain, a block a wide one, at any M; see the source note there)
or raises; on a CPU tensor it runs `chain_scan_plain`, a loop over i
with vector ops over (C, M).
"""
from __future__ import annotations

import torch

from .. import kernels

NEGB = -(10**9)
C_GAP_EXTEND_COST = 1       # per 10 bp
C_GAP_EXTEND_LIMIT = 10
C_GAP_MAX_LEN = 100_000
C_MAX_OVERLAP_FLOAT = 8


def _check(*xs: torch.Tensor) -> None:
    shape, dev = xs[0].shape, xs[0].device
    for x in xs:
        if x.dim() != 2 or x.shape != shape or x.device != dev:
            raise ValueError("chain_scan: want (C, M) tensors of one shape "
                             "on one device")
    for x in xs[:4]:
        if x.dtype != torch.int32:
            raise ValueError(f"chain_scan: want int32, got {x.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"chain_scan: unsupported device {dev}")


def chain_scan_plain(q0, t0, ln, score, valid, gap_open: int):
    C, M = q0.shape
    valid = valid.to(torch.bool)
    f = torch.full((C, M), NEGB, dtype=torch.int32, device=q0.device)
    pred = torch.full((C, M), -1, dtype=torch.int32, device=q0.device)
    if not C or not M or not bool(valid.any()):
        return f, pred
    idxs = torch.arange(M, device=q0.device)
    qe, te = q0 + ln, t0 + ln
    last = int(valid.nonzero()[:, 1].max())
    for i in range(last + 1):
        dq = q0[:, i:i + 1] - qe
        dt = t0[:, i:i + 1] - te
        ok = (idxs < i) & valid & valid[:, i:i + 1]
        ok &= (dq > -C_MAX_OVERLAP_FLOAT) & (dt > -C_MAX_OVERLAP_FLOAT)
        ok &= (dq <= C_GAP_MAX_LEN) & (dt <= C_GAP_MAX_LEN)
        gap = torch.maximum(dq, dt).clamp(min=0)
        gcost = torch.where(
            gap > 0,
            gap_open + (gap // 10 * C_GAP_EXTEND_COST).clamp(
                max=C_GAP_EXTEND_LIMIT),
            0).to(torch.int32)
        cand = torch.where(ok, f - gcost, NEGB)
        j = cand.argmax(dim=1)
        best = cand.gather(1, j[:, None])[:, 0]
        take = best > 0
        fi = torch.where(take, score[:, i] + best, score[:, i])
        f[:, i] = torch.where(valid[:, i], fi, NEGB)
        pred[:, i] = torch.where(take, j, -1).to(torch.int32)
    return f, pred


def chain_scan(q0: torch.Tensor, t0: torch.Tensor, ln: torch.Tensor,
               score: torch.Tensor, valid: torch.Tensor, gap_open: int):
    """(f, pred), each (C, M) int32, of every chain in one call."""
    _check(q0, t0, ln, score, valid)
    if q0.device.type == "cpu":
        return chain_scan_plain(q0, t0, ln, score, valid, gap_open)
    C, M = q0.shape
    ins = [x.contiguous() for x in (q0, t0, ln, score)]
    ins.append(valid.to(torch.bool).contiguous())
    f = torch.empty((C, M), dtype=torch.int32, device=q0.device)
    pred = torch.empty_like(f)
    if C and M:
        lib = kernels.library()
        # a wide chain's rows past the shared memory: (C, M) int4 rows
        scratch = (torch.empty((C, M, 4), dtype=torch.int32,
                               device=q0.device)
                   if M > lib.blitz_chain_shared_max_m() else None)
        with torch.cuda.device(q0.device):
            err = lib.blitz_chain(
                *(x.data_ptr() for x in ins), f.data_ptr(), pred.data_ptr(),
                None if scratch is None else scratch.data_ptr(), C, M,
                gap_open, kernels.stream_ptr(q0.device))
        kernels.check(err, "blitz_chain")
        chain_scan.launches += 1
    return f, pred


chain_scan.launches = 0
