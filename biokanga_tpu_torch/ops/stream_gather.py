"""Checksum of gathered 64-byte rows: the kernel of the gather probe.

Counterpart of biokanga_tpu/ops/stream_gather.py `stream_gather_consume`,
same contract: for a table of R rows of 16 uint32 words and n row indices,

    sum over i, k, w of ((table[idx[i], w] >> 8k) & 0xFF)
                        ^ ((idx[i] >> 8k) & 0xFF)          mod 2^32.

Every byte of every gathered row enters the sum, so the function's time
is the time of the gather; scripts/probe_stream_gather_torch.py times it
against the table's size.  The table holds its uint32 words in int32
storage (same bits), `idx` is int32 in [0, R); the result is a 0-d int64
tensor in [0, 2^32) on the inputs' device.

On a CUDA tensor `stream_gather_consume` launches csrc/stream_gather.cu
or raises; on a CPU tensor it runs `stream_gather_consume_plain`, the
probe's own reference (scripts/probe_stream_gather.py:54-63) in torch.
The kernel sweeps the table region by region; `gather_plan` picks the
region size from the shapes alone (rows, n and the card's L2 size): half
the L2 where rows are wanted about once or more each, else the whole
table (see the source note).  Either is one launch.  The TPU version's
tile sizes are not arguments here.  `sort_rows=True` sorts the indices
first (`torch.sort`, outside the kernel) and gathers them in that order,
in one region: the same sum, with neighbouring rows in neighbouring
lanes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..device import U32_MASK, u32

ROW_WORDS = 16          # 64 B rows
ROW_BYTES = 4 * ROW_WORDS
# most regions a sweep takes: each costs a pass over the indices (~0.015
# ms for 6.3 M on an H100); past ~10 one pass over the whole table is
# faster
MAX_SWEEPS = 10


def gather_plan(rows: int, n: int, l2_bytes: int) -> int:
    """Rows of a region for n gathers from a table of `rows` rows on a
    card with `l2_bytes` of L2.

    Half the L2, so that each distinct row leaves device memory about
    once; the whole table (one region) where there is little reuse (n <
    rows) or it would take more than MAX_SWEEPS regions."""
    region = max(1, l2_bytes // 2 // ROW_BYTES)
    if n < rows or -(-rows // region) > MAX_SWEEPS:
        return rows
    return region


def _check_args(table: torch.Tensor, idx: torch.Tensor) -> None:
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[1] != ROW_WORDS):
        raise ValueError(f"stream_gather_consume: table is "
                         f"{tuple(table.shape)} {table.dtype}, want "
                         f"(R, {ROW_WORDS}) int32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"stream_gather_consume: idx is {tuple(idx.shape)} "
                         f"{idx.dtype}, want (n,) int32")
    if idx.device != table.device:
        raise ValueError(f"stream_gather_consume: idx on {idx.device}, "
                         f"table on {table.device}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_gather_consume: unsupported device "
                         f"{table.device}")
    if idx.numel() and table.shape[0] == 0:
        raise ValueError("stream_gather_consume: indices into an empty table")


def stream_gather_consume_plain(table: torch.Tensor,
                                idx: torch.Tensor) -> torch.Tensor:
    rows = u32(table[idx.to(torch.int64)])                 # (n, 16)
    i64 = idx.to(torch.int64)[:, None]
    acc = torch.zeros((), dtype=torch.int64, device=table.device)
    for k in range(4):
        bk = (rows >> (8 * k)) & 0xFF
        gk = (i64 >> (8 * k)) & 0xFF
        acc = acc + (bk ^ gk).sum()
    return acc & U32_MASK


_l2_bytes: dict[int, int] = {}


def l2_bytes(device: torch.device) -> int:
    """The L2 size of a CUDA device (cudaDevAttrL2CacheSize), asked once."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _l2_bytes:
        got = ctypes.c_int(0)
        with torch.cuda.device(index):
            kernels.check(kernels.library().stream_gather_l2_bytes(
                ctypes.byref(got)), "stream_gather_l2_bytes")
        _l2_bytes[index] = got.value
    return _l2_bytes[index]


def stream_gather_consume(table: torch.Tensor, idx: torch.Tensor,
                          sort_rows: bool = False) -> torch.Tensor:
    """0-d int64 checksum in [0, 2^32) of the rows `idx` of `table`.

    table: (R, 16) int32 bits of uint32 words; idx: (n,) int32 in [0, R)
    (not checked: an index outside the table reads outside it)."""
    _check_args(table, idx)
    if sort_rows:
        idx = torch.sort(idx).values
    if table.device.type == "cpu":
        return stream_gather_consume_plain(table, idx)
    if idx.shape[0] == 0:
        return torch.zeros((), dtype=torch.int64, device=table.device)
    table, idx = table.contiguous(), idx.contiguous()
    if table.data_ptr() % 16:                  # the kernel loads 16 B words
        table = table.clone()
    if idx.data_ptr() % 16:
        idx = idx.clone()
    R, n = table.shape[0], idx.shape[0]
    region = R if sort_rows else gather_plan(R, n, l2_bytes(table.device))
    out = torch.empty(1, dtype=torch.int32, device=table.device)
    lib = kernels.library()
    with torch.cuda.device(table.device):
        err = lib.stream_gather_consume(
            table.data_ptr(), idx.data_ptr(), n, R, region, out.data_ptr(),
            kernels.stream_ptr(table.device))
    kernels.check(err, "stream_gather_consume")
    stream_gather_consume.launches += 1
    stream_gather_consume.last_regions = -(-R // region)
    return u32(out[0])


# kernel launches (one a call) and the regions the last call swept
stream_gather_consume.launches = 0
stream_gather_consume.last_regions = None
