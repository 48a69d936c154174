"""Device-resident index tensors, built from the host GenomeIndex.

Counterpart of biokanga_tpu/index/device.py.  The sorted positions stay
flat (the JAX package's 64-int rows served the TPU's row gathers); the
MAX_CAND_PER_CORE tail pad stays, so a candidate run of up to that many
slots read from any start <= n is in bounds.  Keys are int32 with the
sign bit flipped (device.key32), so that signed compares give the JAX
package's unsigned order in half the memory of int64 values.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import key32_from_numpy, u32_from_numpy
from ..ops.extend_packed import PackedGenome, pack_genome
from .build import GenomeIndex

MAX_CAND_PER_CORE = 4096


@dataclass
class DeviceIndex:
    """Index tensors on one device (single shard, < 2^31 bases)."""

    genome: torch.Tensor        # (n,) int8
    entry_starts: torch.Tensor  # (E+1,) int32
    pos_sorted: torch.Tensor    # (n + tail pad, cut to a multiple of 64,) int32
    key_hi: torch.Tensor        # (n,) int32 keys (device.key32)
    key_lo: torch.Tensor        # (n,) int32
    lut: torch.Tensor           # (4^P + 1,) int32
    lut_bases: int
    entry_names: list[str]
    packed: PackedGenome | None  # None: the engine takes the dense path
    # ceil(log2(max LUT bucket + 1)) + 1 — binary-search trip bound
    max_bsearch_steps: int = 31
    # chunk ownership limit: alignments start below it; None = all owned
    owned: int | None = None

    @property
    def total_len(self) -> int:
        return int(self.genome.shape[0])

    @property
    def device(self) -> torch.device:
        return self.genome.device


def index_nbytes(didx: DeviceIndex) -> int:
    """Device bytes of an index's tensors."""
    ts = [didx.genome, didx.entry_starts, didx.pos_sorted, didx.key_hi,
          didx.key_lo, didx.lut]
    if didx.packed is not None:
        ts += [t for t in (didx.packed.rows, didx.packed.n_rows)
               if t is not None]
    return sum(t.numel() * t.element_size() for t in ts)


def _bsearch_steps(lut: np.ndarray) -> int:
    max_bucket = int(np.diff(lut.astype(np.int64)).max())
    return max(1, int(np.ceil(np.log2(max_bucket + 1))) + 1)


def _padded_positions(pos_sorted: np.ndarray) -> np.ndarray:
    pos = np.concatenate([pos_sorted.astype(np.int32),
                          np.zeros(MAX_CAND_PER_CORE, np.int32)])
    return pos[: len(pos) // 64 * 64]


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)


def _keys(a, device) -> torch.Tensor:
    """uint32 host keys as `key32` keys on `device`."""
    return torch.from_numpy(key32_from_numpy(a)).to(device)


def to_device(idx: GenomeIndex, device: torch.device,
              pack: bool = True) -> DeviceIndex:
    """Move a host GenomeIndex to `device`, packing the genome rows unless
    `pack` is False (then `packed` is None and the engine extends on the
    dense path, ops/extend.py)."""
    device = torch.device(device)
    return DeviceIndex(
        genome=_tensor(idx.codes, np.int8, device),
        entry_starts=_tensor(idx.entry_starts, np.int32, device),
        pos_sorted=_tensor(_padded_positions(idx.pos_sorted), np.int32,
                           device),
        key_hi=_keys(idx.key_hi, device),
        key_lo=_keys(idx.key_lo, device),
        lut=_tensor(idx.lut, np.int32, device),
        lut_bases=idx.lut_bases,
        entry_names=list(idx.entry_names),
        packed=pack_genome(np.asarray(idx.codes), device) if pack else None,
        max_bsearch_steps=_bsearch_steps(np.asarray(idx.lut)),
    )


def from_arrays(arrays: dict, device: torch.device) -> DeviceIndex:
    """DeviceIndex from numpy copies of a JAX DeviceIndex's fields.

    `arrays` holds np.asarray of the JAX index's genome, entry_starts,
    pos_rows, key_hi, key_lo and lut, its lut_bases, entry_names and
    max_bsearch_steps, and its packed genome as packed_rows,
    packed_n_rows (None without Ns) and packed_length."""
    device = torch.device(device)
    n_rows = arrays.get("packed_n_rows")
    return DeviceIndex(
        genome=_tensor(arrays["genome"], np.int8, device),
        entry_starts=_tensor(arrays["entry_starts"], np.int32, device),
        pos_sorted=_tensor(np.asarray(arrays["pos_rows"]).reshape(-1),
                           np.int32, device),
        key_hi=_keys(arrays["key_hi"], device),
        key_lo=_keys(arrays["key_lo"], device),
        lut=_tensor(arrays["lut"], np.int32, device),
        lut_bases=int(arrays["lut_bases"]),
        entry_names=list(arrays["entry_names"]),
        packed=PackedGenome(
            rows=u32_from_numpy(arrays["packed_rows"], device),
            n_rows=None if n_rows is None else u32_from_numpy(n_rows, device),
            length=int(arrays["packed_length"]),
        ),
        max_bsearch_steps=int(arrays["max_bsearch_steps"]),
    )
