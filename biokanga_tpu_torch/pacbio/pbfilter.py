"""Copy of biokanga_tpu/pacbio/pbfilter.py: PacBio read filtering,
retained SMRTbell adapter / hairpin removal (host numpy).

Parity role: `pacbiokanga filter` (CPBFilter, pacbiokanga/PBFilter.cpp,
~1,500 LoC; compile-gated in the reference — pacbiokanga.cpp:70-80) with
CPacBioUtility's SMRTbell detection helpers (PacBioUtility.cpp).

A raw PacBio read that retained its SMRTbell hairpin adapter contains the
45 bp adapter sequence (possibly with sequencing errors) in the middle of
the read, with the flanks being near-reverse-complements of each other.
The filter scans every read for adapter occurrences at a Hamming tolerance,
splits the read at each hit, and keeps subreads >= min_subread_len.

Design: instead of the reference's per-read scalar scan threads,
all windows of a read are scored at once with a vectorised numpy
shift-compare (the per-read work is tiny and host-bound; device dispatch
would be dominated by transfer latency for typical readsets).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.encode import ascii_to_codes

# Standard PacBio SMRTbell adapter (45 bp hairpin stem-loop).
SMRTBELL = "ATCTCTCTCTTTTCCTCCTCCTCCGTTGTTGTTGTTGAGAGAGAT"


@dataclass
class PBFilterParams:
    min_subread_len: int = 500      # drop fragments shorter than this
    max_adapter_mm: int = 9         # <=20% mismatches over the 45bp adapter
    trim_ends: int = 0              # unconditionally trim N bp off each end
    adapter: str = SMRTBELL


@dataclass
class PBFilterStats:
    reads_in: int = 0
    reads_with_adapter: int = 0
    subreads_out: int = 0
    bases_in: int = 0
    bases_out: int = 0
    adapter_hits: int = 0


def find_adapter_hits(codes: np.ndarray, adapter: np.ndarray,
                      max_mm: int) -> np.ndarray:
    """Start positions of adapter occurrences within `codes` (Hamming).

    Vectorised sliding-window compare: build the (n_windows, alen) view via
    stride tricks and row-sum mismatches — one fused pass instead of the
    reference's per-offset loop.
    """
    n, k = len(codes), len(adapter)
    if n < k:
        return np.empty(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    mm = (win != adapter[None, :]).sum(axis=1)
    hits = np.flatnonzero(mm <= max_mm)
    if hits.size == 0:
        return hits
    # collapse runs of adjacent positions to the best (lowest-mm) one
    keep = []
    run_start = 0
    for i in range(1, hits.size + 1):
        if i == hits.size or hits[i] > hits[i - 1] + k // 2:
            seg = hits[run_start:i]
            keep.append(seg[np.argmin(mm[seg])])
            run_start = i
    return np.asarray(keep, np.int64)


def split_read(codes: np.ndarray, params: PBFilterParams,
               adapter_codes: np.ndarray) -> tuple[list[np.ndarray], int]:
    """Split one read at retained-adapter sites; return (subreads, n_hits)."""
    hits = find_adapter_hits(codes, adapter_codes, params.max_adapter_mm)
    k = len(adapter_codes)
    cuts = [0]
    for h in hits:
        cuts += [int(h), int(h) + k]
    cuts.append(len(codes))
    subs = []
    for s, e in zip(cuts[::2], cuts[1::2]):
        s += params.trim_ends
        e -= params.trim_ends
        if e - s >= params.min_subread_len:
            subs.append(codes[s:e])
    return subs, int(hits.size)


def pb_filter(reads: list[tuple[str, np.ndarray]],
              params: PBFilterParams | None = None,
              ) -> tuple[list[tuple[str, np.ndarray]], PBFilterStats]:
    """Filter a PacBio readset; returns (kept subreads, stats)."""
    params = params or PBFilterParams()
    adapter_codes = ascii_to_codes(params.adapter.encode())
    st = PBFilterStats()
    out: list[tuple[str, np.ndarray]] = []
    for name, codes in reads:
        st.reads_in += 1
        st.bases_in += len(codes)
        subs, n_hits = split_read(codes, params, adapter_codes)
        st.adapter_hits += n_hits
        if n_hits:
            st.reads_with_adapter += 1
        for i, s in enumerate(subs):
            nm = name if len(subs) == 1 and not n_hits else f"{name}/sub{i+1}"
            out.append((nm, s))
            st.subreads_out += 1
            st.bases_out += len(s)
    return out, st
