"""Row-wise sorts of the aligner: the dedup sort and the accept sort.

Counterpart of biokanga_tpu/ops/pallas_sort.py.  The JAX package sorts a
(C, B) matrix along C (`sort_cols`, `sort2_cols`); here a (B, C) int32
matrix is sorted along C, one read per row:

    sort_rows(x)           == torch.sort(x, dim=1).values
    sort2_rows(key, val)   == (key, val) sorted lexicographically per row

Each takes a keyword-only `out=` (a tensor, or the (key, val) pair) that
it writes into and returns: the align engine's CUDA graphs hand the
kernels their static buffers this way (align/pipeline.py).

On a CUDA tensor each wrapper launches its kernel from csrc/sort_rows.cu
(a bitonic network; one warp a row with the row in registers up to 1,024
values or 512 pairs, one block a row through shared memory up to 32,768
values or 16,384 pairs, and a scratch row in device memory past that,
at any width whose scratch rows fit; see the source note there) or
raises; on a CPU tensor it runs the plain version beside it, at any
width.  The align path's widest dedup row is 369 cores x 1,024 positions
(4,096 bp reads, `-m ultra`); the widest pair row is the sharded
multi-hit union's K x n_sp pairs (parallel/sharded.py).
"""
from __future__ import annotations

import torch

from .. import kernels

# shared-memory reach of csrc/sort_rows.cu's block path: a row of P
# values or pairs and P/32 or P/16 pad slots, 132 KB and 136 KB.  Wider
# rows take the scratch-row path.
MAX_SORT_C = 32_768
MAX_SORT2_C = 16_384


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"{name}: want a (B, C) int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_out(name: str, out: torch.Tensor, like: torch.Tensor) -> None:
    if (out.shape != like.shape or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out is {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, want a contiguous "
                         f"{tuple(like.shape)} {like.dtype} on {like.device}")


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def sort2_rows_plain(key: torch.Tensor, val: torch.Tensor):
    # one int64 key: key in the high word, val offset to unsigned below it,
    # so int64 order is the signed lexicographic (key, val) order
    packed = key.to(torch.int64) * 2**32 + (val.to(torch.int64) + 2**31)
    s = torch.sort(packed, dim=1).values
    return (s >> 32).to(torch.int32), ((s & 0xFFFFFFFF) - 2**31).to(torch.int32)


def sort_rows(x: torch.Tensor, *, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Ascending sort of each row of a (B, C) int32 tensor (into `out`)."""
    _check_rows("sort_rows", x)
    if out is not None:
        _check_out("sort_rows", out, x)
    if x.device.type == "cpu":
        if out is None:
            return sort_rows_plain(x)
        return out.copy_(sort_rows_plain(x))
    B, C = x.shape
    x = x.contiguous()
    if out is None:
        out = torch.empty_like(x)
    if B and C:
        lib = kernels.library()
        stream = kernels.stream_ptr(x.device)
        with torch.cuda.device(x.device):
            if C <= MAX_SORT_C:
                err = lib.sort_rows_i32(x.data_ptr(), out.data_ptr(), B, C,
                                        stream)
            else:
                P = 1 << (C - 1).bit_length()
                scratch = torch.empty((B, P), dtype=torch.int32,
                                      device=x.device)
                err = lib.sort_rows_wide_i32(x.data_ptr(), out.data_ptr(),
                                             scratch.data_ptr(), B, C, P,
                                             stream)
        kernels.check(err, "sort_rows_i32" if C <= MAX_SORT_C
                      else "sort_rows_wide_i32")
        sort_rows.launches += 1
    return out


sort_rows.launches = 0


def sort2_rows(key: torch.Tensor, val: torch.Tensor, *, out=None):
    """Sort each row of two (B, C) int32 tensors by (key, val) (into the
    pair `out`)."""
    _check_rows("sort2_rows", key)
    _check_rows("sort2_rows", val)
    if key.shape != val.shape or key.device != val.device:
        raise ValueError("sort2_rows: key and val differ in shape or device")
    if out is not None:
        for o in out:
            _check_out("sort2_rows", o, key)
    if key.device.type == "cpu":
        if out is None:
            return sort2_rows_plain(key, val)
        for o, r in zip(out, sort2_rows_plain(key, val)):
            o.copy_(r)
        return tuple(out)
    key, val = key.contiguous(), val.contiguous()
    if out is None:
        ok, ov = torch.empty_like(key), torch.empty_like(val)
    else:
        ok, ov = out
    B, C = key.shape
    if B and C:
        lib = kernels.library()
        stream = kernels.stream_ptr(key.device)
        ptrs = (key.data_ptr(), val.data_ptr(), ok.data_ptr(), ov.data_ptr())
        with torch.cuda.device(key.device):
            if C <= MAX_SORT2_C:
                err = lib.sort2_rows_i32(*ptrs, B, C, stream)
            else:
                # packed pairs: one int64 scratch row of P a row
                P = 1 << (C - 1).bit_length()
                scratch = torch.empty((B, P), dtype=torch.int64,
                                      device=key.device)
                err = lib.sort2_rows_wide_i32(*ptrs, scratch.data_ptr(), B,
                                              C, P, stream)
        kernels.check(err, "sort2_rows_i32" if C <= MAX_SORT2_C
                      else "sort2_rows_wide_i32")
        sort2_rows.launches += 1
    return ok, ov


sort2_rows.launches = 0
