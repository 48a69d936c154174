"""Copy of biokanga_tpu/seq/rds.py: the packed `.rds` read container.

Parity role: the reference's CProcRawReads `.rds` preprocessed-read files
(libbiokanga/ProcRawReads.h:53,75 — V5/V6 records), produced by `kangar`
(kangar/kangar.cpp), filtered by `filterreads` (filterreads/), and accepted
as aligner input (biokanga/Aligner.cpp:8312 LoadReads).

TPU-first design: instead of the reference's per-record byte stream
(header + descriptor + packed bases per read), the container is columnar —
one global 2-bit-packed base array + an N-position bitmask + per-read
offset/length columns — so a block of reads decodes with a handful of
vectorised numpy ops straight into the aligner's fixed-width ReadBlock
device layout.  Stored as a single .npz (zip) file:

  meta      int64[3]   (format version, n_reads, total_bases)
  packed    uint8[ceil(total/4)]   4 bases/byte, 2 bits each (N stored as 0)
  nmask     uint8[ceil(total/8)]   np.packbits mask of N positions
  offsets   int64[n+1]  base offsets of each read into the global array
  flags     uint8[n]    bit0: PE second-mate; bit1: duplicate-marked
  names     uint8[...]  newline-joined read descriptors
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

RDS_VERSION = 1
FLAG_PE2 = 0x01
FLAG_DUP = 0x02

_WEIGHTS = np.array([1, 4, 16, 64], np.uint8)


def pack_2bit(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """codes int8 (0..3, 4=N) -> (packed uint8 4/byte, nmask packbits)."""
    n = len(codes)
    nmask = np.packbits(codes == 4)
    c = np.where(codes == 4, 0, codes).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
    packed = (c.reshape(-1, 4) * _WEIGHTS).sum(axis=1, dtype=np.uint8)
    return packed, nmask


def unpack_2bit(packed: np.ndarray, nmask: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit -> int8 codes of length n."""
    c = ((packed[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3)
    c = c.reshape(-1).astype(np.int8)[:n]
    isn = np.unpackbits(nmask)[:n].astype(bool)
    c[isn] = 4
    return c


@dataclass
class RDSInfo:
    version: int
    n_reads: int
    total_bases: int
    is_pe: bool


def write_rds(path: str, records, pe_interleaved: bool = False) -> int:
    """records: iterable of (name, codes[, flags]).  Returns n written.

    pe_interleaved: mark every odd record as the PE second mate
    (the kangar PE layout — mates interleaved 5',3',5',3'...).
    """
    names: list[str] = []
    chunks: list[np.ndarray] = []
    lengths: list[int] = []
    flags: list[int] = []
    for i, rec in enumerate(records):
        name, codes = rec[0], np.asarray(rec[1], np.int8)
        fl = rec[2] if len(rec) > 2 else 0
        if pe_interleaved and i % 2 == 1:
            fl |= FLAG_PE2
        names.append(name)
        chunks.append(codes)
        lengths.append(len(codes))
        flags.append(fl)
    allc = (np.concatenate(chunks) if chunks
            else np.empty(0, np.int8))
    packed, nmask = pack_2bit(allc)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    np.savez_compressed(
        path,
        meta=np.array([RDS_VERSION, len(names), len(allc)], np.int64),
        packed=packed,
        nmask=nmask,
        offsets=offsets,
        flags=np.array(flags, np.uint8),
        names=np.frombuffer("\n".join(names).encode(), np.uint8),
    )
    return len(names)


def is_rds(path: str) -> bool:
    if not (path.endswith(".npz") or path.endswith(".rds")):
        return False
    try:
        with np.load(path) as z:
            return "meta" in z and "packed" in z and "offsets" in z
    except Exception:
        return False


def rds_info(path: str) -> RDSInfo:
    with np.load(path) as z:
        meta = z["meta"]
        flags = z["flags"]
        return RDSInfo(int(meta[0]), int(meta[1]), int(meta[2]),
                       bool((flags & FLAG_PE2).any()))


class RDSFile:
    """Loaded container with vectorised block decode."""

    def __init__(self, path: str):
        z = np.load(path)
        self.meta = z["meta"]
        if int(self.meta[0]) > RDS_VERSION:
            raise ValueError(f"unsupported rds version {self.meta[0]}")
        self.n_reads = int(self.meta[1])
        total = int(self.meta[2])
        self.codes = unpack_2bit(z["packed"], z["nmask"], total)
        self.offsets = z["offsets"]
        self.flags = z["flags"]
        self.names = (z["names"].tobytes().decode().split("\n")
                      if z["names"].size else [])

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def read(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]: self.offsets[i + 1]]

    def records(self) -> Iterator[tuple[str, np.ndarray, int]]:
        for i in range(self.n_reads):
            yield self.names[i], self.read(i), int(self.flags[i])


def read_rds_blocks(path: str, block_size: int = 4096,
                    max_len: int | None = None,
                    mate: int | None = None):
    """Yield aligner ReadBlocks from an rds container.

    mate: None = all reads; 0 = only first mates; 1 = only second mates
    (PE-interleaved containers).
    """
    from .fasta import ReadBlock

    f = RDSFile(path)
    lens = f.lengths()
    sel = np.arange(f.n_reads)
    if mate is not None:
        want = FLAG_PE2 if mate == 1 else 0
        sel = sel[(f.flags & FLAG_PE2) == want]
    for s in range(0, len(sel), block_size):
        ids = sel[s: s + block_size]
        blens = lens[ids]
        w = int(max_len if max_len is not None else blens.max(initial=1))
        codes = np.full((len(ids), w), 4, np.int8)
        for r, i in enumerate(ids):
            L = min(int(blens[r]), w)
            codes[r, :L] = f.codes[f.offsets[i]: f.offsets[i] + L]
        yield ReadBlock(
            names=[f.names[i] for i in ids],
            codes=codes,
            lengths=np.minimum(blens, w).astype(np.int32),
        )
