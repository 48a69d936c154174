"""Index build on the device: keys, suffix order, LUT and packed rows.

Counterpart of biokanga_tpu/index/device_build.py `device_build_index`
(:142).  Only the int8 codes go to the device; the 32-base keys, their
sorted order and the prefix LUT are computed there, and the result is a
DeviceIndex like the one `index/device.to_device` makes from a host
build.  The JAX package sorts (key_hi, key_lo, pos) in one 3-key
`jax.lax.sort`; here two stable `torch.sort` passes, by key_lo and then
by key_hi, over positions in ascending order give that order exactly.
Keys are uint32 values held in int64 (device.u32).  The packed rows come
from ops/extend_packed.pack_genome on the host, as for a host index.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.extend_packed import pack_genome
from .device import MAX_CAND_PER_CORE, DeviceIndex


def _keys(codes: torch.Tensor):
    """(hi, lo) int64 unsigned 32-bit keys of every position: hi packs
    bases [i, i+16), lo bases [i+16, i+32); N and bases past the end
    pack as 0 (A)."""
    n = codes.shape[0]
    b = torch.where(codes >= 4, 0, codes).to(torch.int64)
    bp = torch.cat([b, torch.zeros(32, dtype=torch.int64, device=b.device)])
    hi = torch.zeros(n + 16, dtype=torch.int64, device=b.device)
    for j in range(16):
        hi += bp[j : j + n + 16] << (2 * (15 - j))
    return hi[:n], hi[16 : n + 16]


def device_build_index(codes: np.ndarray, entry_starts: np.ndarray,
                       lut_bases: int = 12,
                       device: torch.device | str = "cuda") -> DeviceIndex:
    """Build a DeviceIndex on `device` from host int8 codes (N = 4) and
    the (E+1,) entry starts."""
    device = torch.device(device)
    codes_h = np.ascontiguousarray(codes, np.int8)
    n = len(codes_h)
    codes_d = torch.from_numpy(codes_h).to(device)
    hi, lo = _keys(codes_d)

    # LUT: bucket starts by P-base prefix, counted over the unsorted keys
    P = lut_bases
    cnt = torch.bincount(hi >> (32 - 2 * P), minlength=4**P)
    lut = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                     torch.cumsum(cnt, 0)]).to(torch.int32)

    # (key_hi, key_lo, pos) order: stable sorts, least significant key first
    order = torch.sort(lo, stable=True).indices
    order = order[torch.sort(hi[order], stable=True).indices]
    key_hi, key_lo = hi[order], lo[order]

    pad = MAX_CAND_PER_CORE + (-(n + MAX_CAND_PER_CORE) % 64)
    pos = torch.cat([order.to(torch.int32),
                     torch.zeros(pad, dtype=torch.int32, device=device)])
    max_bucket = int(torch.diff(lut).max()) if n else 0
    return DeviceIndex(
        genome=codes_d,
        entry_starts=torch.from_numpy(
            np.asarray(entry_starts, np.int32)).to(device),
        pos_sorted=pos,
        key_hi=key_hi,
        key_lo=key_lo,
        lut=lut,
        lut_bases=P,
        entry_names=[],
        packed=pack_genome(codes_h, device),
        max_bsearch_steps=max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1),
    )
