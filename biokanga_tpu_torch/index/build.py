"""Copy of biokanga_tpu/index/build.py: the host index build and its file,
and the bisulfite pair and colorspace indexes.

TPU-first design: instead of the reference's full suffix array with
pointer-chasing binary search (CSfxArrayV3, libbiokanga/SfxArrayV2.cpp —
build at :414-535, search at :7765+), we build a **32-base-bounded suffix
array**: genome positions sorted by the first 32 bases of their suffix,
packed as a (hi:uint32, lo:uint32) key pair (16 bases per word, 2 bits per
base, first base most significant).  Range queries for any seed/core length
k <= 32 are contiguous runs, found by batched fixed-trip binary search on
device — a gather-friendly access pattern — seeded by a direct-address
prefix LUT over the first P bases that collapses most of the search depth.

The reference itself bounds suffix comparisons (gMaxBaseCmpLen,
SfxArrayV2.cpp:22), so bounded-key sorting matches its effective semantics
for all seed lengths the toolkit uses (cores <= ~32 bp).

Entry (chromosome/contig) handling: sequences are concatenated WITHOUT
separator sentinels; keys spanning an entry boundary may produce spurious
seed ranges, but the extension stage masks any candidate whose alignment
window is not fully contained in a single entry (cf. the reference's
eBaseEOS separators, commdefs.h:108-124).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np

INDEX_FORMAT_VERSION = 1
DEFAULT_LUT_BASES = 12  # P: direct-address prefix length (4^P + 1 entries)


@dataclass
class GenomeIndex:
    """Host-resident index; index/device.to_device moves it to a device."""

    codes: np.ndarray        # (n,) int8 concatenated genome codes (N=4)
    entry_names: list[str]
    entry_starts: np.ndarray  # (E+1,) int64 — start offset per entry + total
    pos_sorted: np.ndarray   # (n,) int32/int64 positions sorted by 32-base key
    key_hi: np.ndarray       # (n,) uint32 — first 16 bases at pos_sorted
    key_lo: np.ndarray       # (n,) uint32 — bases 16..31 at pos_sorted
    lut: np.ndarray          # (4^P + 1,) int — bucket starts by P-base prefix
    lut_bases: int
    space: str = "base"      # "base" | "color" (SOLiD colorspace transform)

    @property
    def total_len(self) -> int:
        return int(self.entry_starts[-1])

    @property
    def num_entries(self) -> int:
        return len(self.entry_names)

    def entry_of(self, loci: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.entry_starts, loci, side="right") - 1


def pack_keys(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 key arrays for every genome position.

    hi[i] packs bases [i, i+16), lo[i] = hi[i+16] packs [i+16, i+32);
    N and out-of-range bases pack as 0 (A) — see module docstring.
    """
    n = codes.shape[0]
    b = codes.astype(np.uint32)
    b[b >= 4] = 0
    hi = np.zeros(n + 16, dtype=np.uint32)
    for j in range(16):
        shift = np.uint32(2 * (15 - j))
        hi[: n - j] |= b[j:] << shift
    lo = hi[16:]
    hi = hi[:n]
    return hi, lo


def build_index(
    seqs: list[tuple[str, np.ndarray]],
    lut_bases: int = DEFAULT_LUT_BASES,
) -> GenomeIndex:
    """Build the index from (name, int8-codes) sequences."""
    names = [n for n, _ in seqs]
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, (_, s) in enumerate(seqs):
        starts[i + 1] = starts[i] + len(s)
    total = int(starts[-1])
    if total >= 2**31:
        raise ValueError(
            "single-chunk index holds < 2^31 bases; build a chunked "
            "index (index/chunked.py build_chunked_index)"
        )
    codes = np.empty(total, dtype=np.int8)
    for i, (_, s) in enumerate(seqs):
        codes[starts[i] : starts[i + 1]] = s

    # native threaded key build + parallel sample sort (CMTqsort role,
    # libbiokanga/MTqsort.cpp); numpy lexsort fallback
    from ..utils.native import build_sorted_keys

    nat = build_sorted_keys(codes)
    if nat is not None:
        order, key_hi, key_lo = nat
    else:
        hi, lo = pack_keys(codes)
        order = np.lexsort((lo, hi)).astype(np.int32)
        key_hi = hi[order]
        key_lo = lo[order]

    P = lut_bases
    prefix = (key_hi >> np.uint32(32 - 2 * P)).astype(np.int64)
    counts = np.bincount(prefix, minlength=4**P)
    lut = np.zeros(4**P + 1, dtype=np.int64)
    np.cumsum(counts, out=lut[1:])
    lut = lut.astype(np.int32 if total < 2**31 else np.int64)

    return GenomeIndex(
        codes=codes,
        entry_names=names,
        entry_starts=starts,
        pos_sorted=order,
        key_hi=key_hi,
        key_lo=key_lo,
        lut=lut,
        lut_bases=P,
    )


def build_bisulfite_indexes(
    seqs: list[tuple[str, np.ndarray]],
    lut_bases: int = DEFAULT_LUT_BASES,
) -> tuple[GenomeIndex, GenomeIndex]:
    """Bisulfite index pair: (CT-collapsed, GA-collapsed) — the role of
    the reference's collapsed index copies built in SfxBlock2Disk
    (libbiokanga/SfxArrayV2.cpp:440-459; kangax -m1 mode)."""
    from ..seq.encode import ct_collapse, ga_collapse

    ct = build_index([(n, ct_collapse(s)) for n, s in seqs], lut_bases)
    ga = build_index([(n, ga_collapse(s)) for n, s in seqs], lut_bases)
    return ct, ga


def save_bisulfite_index(ct: GenomeIndex, ga: GenomeIndex,
                         path: str) -> None:
    meta = {
        "format_version": INDEX_FORMAT_VERSION,
        "bisulfite": True,
        "entry_names": ct.entry_names,
        "lut_bases": ct.lut_bases,
        "created_unix": time.time(),
    }
    arrays = {}
    for tag, idx in (("ct", ct), ("ga", ga)):
        arrays[f"{tag}_codes"] = idx.codes
        arrays[f"{tag}_pos_sorted"] = idx.pos_sorted
        arrays[f"{tag}_key_hi"] = idx.key_hi
        arrays[f"{tag}_key_lo"] = idx.key_lo
        arrays[f"{tag}_lut"] = idx.lut
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        entry_starts=ct.entry_starts,
        **arrays,
    )


def is_bisulfite_index(path: str) -> bool:
    with np.load(path) as z:
        if "meta" not in z:
            return False
        return bool(json.loads(z["meta"].tobytes().decode()
                               ).get("bisulfite", False))


def load_bisulfite_index(path: str) -> tuple[GenomeIndex, GenomeIndex]:
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        if not meta.get("bisulfite"):
            raise ValueError(f"{path} is not a bisulfite index")
        out = []
        for tag in ("ct", "ga"):
            out.append(GenomeIndex(
                codes=z[f"{tag}_codes"],
                entry_names=list(meta["entry_names"]),
                entry_starts=z["entry_starts"],
                pos_sorted=z[f"{tag}_pos_sorted"],
                key_hi=z[f"{tag}_key_hi"],
                key_lo=z[f"{tag}_key_lo"],
                lut=z[f"{tag}_lut"],
                lut_bases=int(meta["lut_bases"]),
            ))
        return out[0], out[1]


def build_colorspace_index(
    seqs: list[tuple[str, np.ndarray]],
    lut_bases: int = DEFAULT_LUT_BASES,
) -> GenomeIndex:
    """Colorspace index (kangax -C role, SfxArrayV2.cpp:300-380): each
    entry is transformed to SOLiD dibase colors (length L-1) before the
    standard key/LUT build.  Color loci map 1:1 to base-space starts."""
    from ..seq.encode import to_colorspace

    idx = build_index(
        [(n, to_colorspace(s)) for n, s in seqs], lut_bases=lut_bases
    )
    idx.space = "color"
    return idx


def save_index(idx: GenomeIndex, path: str) -> None:
    """Versioned on-disk index (.npz shards) — role of the reference's .sfx
    container (tsSfxHeaderV3, SfxArrayV2.h:171-200)."""
    meta = {
        "format_version": INDEX_FORMAT_VERSION,
        "entry_names": idx.entry_names,
        "lut_bases": idx.lut_bases,
        "space": idx.space,
        "created_unix": time.time(),
    }
    np.savez(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        codes=idx.codes,
        entry_starts=idx.entry_starts,
        pos_sorted=idx.pos_sorted,
        key_hi=idx.key_hi,
        key_lo=idx.key_lo,
        lut=idx.lut,
    )


def load_index(path: str) -> GenomeIndex:
    with np.load(path) as z:
        meta = json.loads(z["meta"].tobytes().decode())
        if meta["format_version"] > INDEX_FORMAT_VERSION:
            raise ValueError(f"index format {meta['format_version']} too new")
        return GenomeIndex(
            codes=z["codes"],
            entry_names=list(meta["entry_names"]),
            entry_starts=z["entry_starts"],
            pos_sorted=z["pos_sorted"],
            key_hi=z["key_hi"],
            key_lo=z["key_lo"],
            lut=z["lut"],
            lut_bases=int(meta["lut_bases"]),
            space=meta.get("space", "base"),
        )
