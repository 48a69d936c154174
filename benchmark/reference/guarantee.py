"""The search guarantee of biokanga's Hamming aligner, as its settings
state it, frozen here so that the check does not move with the program.

The aligner finds hits through exact seed cores.  With n pairwise
disjoint cores inside a read, any placement with at most n - 1
mismatches holds one core exactly (pigeonhole), so a pass finds every
such placement.  Two passes run: a fast pass of long disjoint cores, and
a classic pass of biokanga's own cores (Aligner.cpp:8722-8760,
9084-9097; SfxArrayV2.cpp:5829-5848) for the reads whose best hit the
fast pass cannot prove (best > n_fast - min_edit_dist).  Hence:

- `best_mm`: a read whose best placement has at most this many
  mismatches gets its best hit, its uniqueness and its first hit exactly
  (max(n_fast, n_classic) - min_edit_dist);
- `multi_mm`: every placement with at most this many mismatches is in
  the read's multi-hit list, up to its length (min(n_fast, n_classic) - 1).

Reads whose best hit lies past `best_mm` are held only to soundness: a
hit they report must be a true one, with its true count.
"""
from __future__ import annotations

from dataclasses import dataclass

CORE_ADD = {"ultra": 0, "more": 1, "default": 2, "less": 4}
SLIDES = {"ultra": 9, "more": 8, "default": 8, "less": 6}


@dataclass(frozen=True)
class Guarantee:
    max_mm: int        # the mismatch budget of a read
    best_mm: int
    multi_mm: int
    seed_k: int        # the reference's own seed length, L // (max_mm + 1)


def max_mismatches(read_len: int, subs_per100: int) -> int:
    if subs_per100 == 0:
        return 0
    return min(max(1, int(0.5 + read_len * subs_per100 / 100.0)), 63)


def _min_core_len(genome_len: int, mode: str) -> int:
    if genome_len <= 500_000:
        base = 4
    elif genome_len <= 20_000_000:
        base = 7
    elif genome_len <= 250_000_000:
        base = 11
    elif genome_len <= 3_500_000_000:
        base = 12
    else:
        base = 15
    return base + CORE_ADD[mode]


def _classic_offsets(read_len, genome_len, max_mm, min_edit_dist, mode):
    denom = max_mm + (1 if min_edit_dist == 1 else 2)
    core = max(_min_core_len(genome_len, mode), read_len // denom)
    slides = max(1, (SLIDES[mode] * read_len + 99) // 100)
    delta = max(read_len // slides - 1, core)
    core = min(core, 32)
    offs, d, ofs = [], delta, 0
    while len(offs) < slides and ofs <= read_len - core and d > core // 3:
        offs.append(ofs)
        if ofs + core + d > read_len:
            d = read_len - (ofs + core)
        ofs += d
        if d <= 0:
            break
    return core, offs


def _disjoint(core: int, offsets) -> int:
    n, end = 0, -1
    for o in sorted(offsets):
        if o > end:
            n, end = n + 1, o + core - 1
    return n


def guarantee(read_len: int, genome_len: int, lut_bases: int,
              subs_per100: int, min_edit_dist: int, mode: str) -> Guarantee:
    max_mm = max_mismatches(read_len, subs_per100)
    core, offs = _classic_offsets(read_len, genome_len, max_mm,
                                  min_edit_dist, mode)
    n_classic = _disjoint(core, offs)
    best, multi = n_classic - min_edit_dist, n_classic - 1
    junk_lut = genome_len / 4 ** lut_bases
    if lut_bases > core and junk_lut <= 8.0:
        F = lut_bases
    else:
        F = min(max(read_len // 8, core + 1), 32)
    n_fast = read_len // F
    if max_mm and F > core and n_fast >= 3 and n_fast > min_edit_dist:
        best = max(best, n_fast - min_edit_dist)
        multi = min(multi, n_fast - 1)
    return Guarantee(max_mm=max_mm, best_mm=min(best, max_mm),
                     multi_mm=min(multi, max_mm),
                     seed_k=read_len // (max_mm + 1))
