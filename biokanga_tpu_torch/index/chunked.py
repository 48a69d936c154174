"""Copy of biokanga_tpu/index/chunked.py: the genome-range chunked index,
for genomes of 2^31 bases or more.

Reference capacity being matched: up to 100 M sequences / <1000 Gbp
total, with 5-byte suffix elements past 4G elements
(Docs/biokanga.index.txt:27-32, libbiokanga/SfxArrayV2.h:101-102).

The genome concatenation is split into OWNED ranges of at most max_chunk
(< 2^31) bases.  Each chunk is an independent local-coordinate
GenomeIndex over its slice = owned range + `overlap` tail, so every
alignment window that STARTS in the owned range lies inside the slice.
The ownership rule (local start < owned) makes the chunks' candidate sets
disjoint, so the best / next-best / instance merge across chunks is exact
(parallel/chunked.merge_chunk_results).  Global loci are int64 = chunk
base + local locus, composed on the host; device tensors stay chunk-local
int32.

Every chunk is padded to one set of shapes (`pad_shapes`).  The JAX
package did so to share one compiled graph; the padding also sets the
result, because AlignParams.derive takes the padded length to choose the
core length, so it is kept exactly: codes pad with N, keys with
0xFFFFFFFF, entry starts by repeating the slice length.

`ResidentChunks` holds every chunk's DeviceIndex on one device at once:
a host index uploaded once (`upload_chunked_index`), where its bytes fit
(`fits_on_device`), or chunks built on the device
(index/device_build.build_resident_chunks).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.extend_packed import PAD_ROWS, ROW_STRIDE_BASES, pack_genome
from .build import DEFAULT_LUT_BASES, GenomeIndex, build_index
from .device import (MAX_CAND_PER_CORE, DeviceIndex, _keys,
                     _padded_positions, _tensor, index_nbytes)

DEFAULT_OVERLAP = 2048  # must cover the longest alignment window - 1
# a host index is held on the device when its bytes are at most this share
# of the device's free memory: the rest is the engines' working memory
RESIDENT_SHARE = 0.75


@dataclass
class ChunkedIndex:
    chunks: list[GenomeIndex]   # local-coordinate index per chunk slice
    bases: np.ndarray           # (K,) int64 global offset of slice start
    owned: np.ndarray           # (K,) int64 owned length per chunk
    entry_names: list[str]
    entry_starts: np.ndarray    # (E+1,) int64 global entry boundaries
    overlap: int

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def total_len(self) -> int:
        return int(self.entry_starts[-1])

    def entry_of(self, glob_loci: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.entry_starts, glob_loci,
                               side="right") - 1

    def pad_shapes(self) -> tuple[int, int, int]:
        """(pad_n, pad_E, steps): the shapes every chunk is padded to."""
        pad_n = max(c.total_len for c in self.chunks)
        # strictly > every chunk length: the N-coded pad gives every
        # chunk's packed genome an N plane
        pad_n = (pad_n // 128 + 1) * 128
        pad_E = max(c.num_entries for c in self.chunks)
        steps = 1
        for c in self.chunks:
            max_bucket = int(np.diff(c.lut.astype(np.int64)).max())
            steps = max(steps, int(np.ceil(np.log2(max_bucket + 1))) + 1)
        return pad_n, pad_E, steps


def plan_chunks(total: int, max_chunk: int, overlap: int):
    """[(base, owned, slice_len)] — equal-ish owned ranges covering total."""
    if total <= max_chunk:
        return [(0, total, total)]
    k = -(-total // max_chunk)
    owned = -(-total // k)
    plans = []
    pos = 0
    while pos < total:
        o = min(owned, total - pos)
        s = min(o + overlap, total - pos)
        plans.append((pos, o, s))
        pos += o
    return plans


def build_chunked_index(
    seqs: list[tuple[str, np.ndarray]],
    max_chunk: int = 1 << 30,
    overlap: int = DEFAULT_OVERLAP,
    lut_bases: int = DEFAULT_LUT_BASES,
    num_chunks: int | None = None,
) -> ChunkedIndex:
    """Build the chunked index from (name, int8-codes) sequences.

    num_chunks forces an exact chunk count; otherwise ceil(total /
    max_chunk) chunks are built."""
    names = [n for n, _ in seqs]
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    total = int(starts[-1])
    codes = np.empty(total, dtype=np.int8)
    for i, (_, s) in enumerate(seqs):
        codes[starts[i] : starts[i + 1]] = s

    if num_chunks is not None:
        max_chunk = -(-total // num_chunks)
    plans = plan_chunks(total, max_chunk, overlap)

    chunks, bases, owned = [], [], []
    for base, own, slice_len in plans:
        sl = codes[base : base + slice_len]
        # split the slice at GLOBAL entry boundaries so containment
        # masking inside the chunk matches the unchunked index exactly
        cut = starts[(starts > base) & (starts < base + slice_len)] - base
        segs = np.split(sl, cut.astype(np.int64))
        chunk_seqs = [(f"__c{j}", seg) for j, seg in enumerate(segs)
                      if len(seg)]
        chunks.append(build_index(chunk_seqs, lut_bases=lut_bases))
        bases.append(base)
        owned.append(own)

    return ChunkedIndex(
        chunks=chunks,
        bases=np.asarray(bases, np.int64),
        owned=np.asarray(owned, np.int64),
        entry_names=names,
        entry_starts=starts,
        overlap=overlap,
    )


def save_chunked_index(ci: ChunkedIndex, path: str) -> None:
    """Versioned multi-chunk container in one .npz (the role of the
    reference's multi-block .sfx files, libbiokanga/SfxArrayV2.h:97-104)."""
    meta = {
        "format_version": 1,
        "chunked": True,
        "entry_names": ci.entry_names,
        "overlap": ci.overlap,
        "lut_bases": ci.chunks[0].lut_bases,
        "num_chunks": ci.num_chunks,
        "created_unix": time.time(),
    }
    arrays = {}
    for k, c in enumerate(ci.chunks):
        arrays[f"c{k}_codes"] = c.codes
        arrays[f"c{k}_entry_starts"] = c.entry_starts
        arrays[f"c{k}_pos_sorted"] = c.pos_sorted
        arrays[f"c{k}_key_hi"] = c.key_hi
        arrays[f"c{k}_key_lo"] = c.key_lo
        arrays[f"c{k}_lut"] = c.lut
        arrays[f"c{k}_names"] = np.frombuffer(
            json.dumps(c.entry_names).encode(), dtype=np.uint8
        )
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        bases=ci.bases,
        owned=ci.owned,
        entry_starts=ci.entry_starts,
        **arrays,
    )


def is_chunked_index(path: str) -> bool:
    with np.load(path) as z:
        if "meta" not in z:
            return False
        return bool(json.loads(z["meta"].tobytes().decode()
                               ).get("chunked", False))


def load_chunked_index(path: str) -> ChunkedIndex:
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        if not meta.get("chunked"):
            raise ValueError(f"{path} is not a chunked index")
        chunks = []
        for k in range(int(meta["num_chunks"])):
            chunks.append(GenomeIndex(
                codes=z[f"c{k}_codes"],
                entry_names=list(
                    json.loads(z[f"c{k}_names"].tobytes().decode())
                ),
                entry_starts=z[f"c{k}_entry_starts"],
                pos_sorted=z[f"c{k}_pos_sorted"],
                key_hi=z[f"c{k}_key_hi"],
                key_lo=z[f"c{k}_key_lo"],
                lut=z[f"c{k}_lut"],
                lut_bases=int(meta["lut_bases"]),
            ))
        return ChunkedIndex(
            chunks=chunks,
            bases=z["bases"],
            owned=z["owned"],
            entry_names=list(meta["entry_names"]),
            entry_starts=z["entry_starts"],
            overlap=int(meta["overlap"]),
        )


def pad_chunk_arrays(idx: GenomeIndex, pad_n: int, pad_E: int):
    """Host-side padding of one chunk's arrays to the uniform shapes.

    codes pad with N (code 4) so windows reaching into the pad can never
    be accepted; keys pad with 0xFFFFFFFF (sort-high) but the LUT caps
    every bucket at the REAL key count, so lookups never surface padded
    slots; entry_starts pad by repeating the real slice length so any
    window crossing the real end fails entry containment.
    """
    n = idx.total_len
    codes = np.full(pad_n, 4, np.int8)
    codes[:n] = idx.codes
    khi = np.full(pad_n, 0xFFFFFFFF, np.uint32)
    klo = np.full(pad_n, 0xFFFFFFFF, np.uint32)
    pos = np.zeros(pad_n, np.int32)
    khi[:n] = idx.key_hi
    klo[:n] = idx.key_lo
    pos[:n] = idx.pos_sorted.astype(np.int32)
    es = np.full(pad_E + 1, n, np.int64)
    es[: idx.num_entries + 1] = idx.entry_starts
    return codes, es, pos, khi, klo, idx.lut.astype(np.int32)


def chunk_to_device(ci: ChunkedIndex, k: int, pad_shapes=None,
                    device: torch.device | str = "cuda") -> DeviceIndex:
    """DeviceIndex for chunk k, padded to the uniform shapes, with the
    ownership limit set."""
    device = torch.device(device)
    if pad_shapes is None:
        pad_shapes = ci.pad_shapes()
    pad_n, pad_E, steps = pad_shapes
    idx = ci.chunks[k]
    codes, es, pos, khi, klo, lut = pad_chunk_arrays(idx, pad_n, pad_E)
    return DeviceIndex(
        genome=_tensor(codes, np.int8, device),
        entry_starts=_tensor(es, np.int32, device),
        pos_sorted=_tensor(_padded_positions(pos), np.int32, device),
        key_hi=_keys(khi, device),
        key_lo=_keys(klo, device),
        lut=_tensor(lut, np.int32, device),
        lut_bases=idx.lut_bases,
        entry_names=list(idx.entry_names),
        packed=pack_genome(codes, device),
        max_bsearch_steps=steps,
        owned=int(ci.owned[k]),
    )


@dataclass
class ResidentChunks:
    """Every chunk of a chunked index on one device at once: a DeviceIndex
    a chunk, padded to one shape and with its ownership limit, and the
    chunk plan in global coordinates."""

    chunks: list[DeviceIndex]
    bases: np.ndarray           # (K,) int64 global offset of slice start
    owned: np.ndarray           # (K,) int64 owned length per chunk
    entry_names: list[str]
    entry_starts: np.ndarray    # (E+1,) int64 global entry boundaries
    overlap: int

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def total_len(self) -> int:
        return int(self.entry_starts[-1])

    def nbytes(self) -> int:
        """Device bytes of every chunk's tensors."""
        return sum(index_nbytes(c) for c in self.chunks)


def padded_nbytes(ci: ChunkedIndex) -> int:
    """Device bytes of every chunk of `ci` as chunk_to_device makes them:
    codes, entry starts, tail-padded positions, two int32 key arrays, the
    LUT and the packed rows with their N plane (the N pad gives every
    chunk one)."""
    pad_n, pad_E, _ = ci.pad_shapes()
    pos = (pad_n + MAX_CAND_PER_CORE) // 64 * 64
    rows = 2 * (pad_n // ROW_STRIDE_BASES + PAD_ROWS) * 64
    lut = 4 * (4 ** ci.chunks[0].lut_bases + 1)
    one = pad_n + 4 * (pad_E + 1) + 4 * pos + 8 * pad_n + lut + rows
    return ci.num_chunks * one


def free_bytes(device: torch.device) -> int:
    """Free memory of `device`: the card's, or the host's available pages
    for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def fits_on_device(ci: ChunkedIndex, device: torch.device) -> bool:
    """Whether every chunk of `ci` can stay on `device`: its bytes at most
    RESIDENT_SHARE of the free memory."""
    return padded_nbytes(ci) <= RESIDENT_SHARE * free_bytes(device)


def upload_chunked_index(ci: ChunkedIndex,
                         device: torch.device | str = "cuda"
                         ) -> ResidentChunks:
    """Every chunk of a host ChunkedIndex on `device`, uploaded once."""
    shapes = ci.pad_shapes()
    return ResidentChunks(
        chunks=[chunk_to_device(ci, k, shapes, device)
                for k in range(ci.num_chunks)],
        bases=ci.bases, owned=ci.owned, entry_names=list(ci.entry_names),
        entry_starts=ci.entry_starts, overlap=ci.overlap)
