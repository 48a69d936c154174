"""Copy of biokanga_tpu/align/params.py: aligner parameters and ladders.

Numeric behavior mirrors the reference CLI/engine:
- subs per 100bp default 10, cap 63        (biokanga/Aligner.h:21,23)
- editdelta (MMDelta) default 1, max 2     (biokanga/kanga.cpp:247,770)
- maxmulti default 5, user cap 500         (biokanga/Aligner.h:61-62)
- MinCoreLen ladder by genome size + mode  (biokanga/Aligner.cpp:8722-8760)
- per-read MaxTotMM / CoreLen / CoreDelta  (biokanga/Aligner.cpp:9084-9097)
- core slide offset sequence               (libbiokanga/SfxArrayV2.cpp:5829-5848)
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

C_MIN_CORE_LEN = 4          # Aligner.h:24
C_MAX_TOT_ALLOWED_SUBS = 63  # Aligner.h:23
C_DFLT_ALLOWED_SUBS = 10     # Aligner.h:21
C_DFLT_MAX_MULTI = 5         # Aligner.h:61


class Sensitivity(str, Enum):
    ULTRA = "ultra"      # ePMUltraSens: slides 9, +0 core
    MORE = "more"        # ePMMoreSens: slides 8, +1 core
    DEFAULT = "default"  # ePMdefault:  slides 8, +2 core
    LESS = "less"        # less sensitive: slides 6, +4 core


_MODE_CORE_ADD = {
    Sensitivity.ULTRA: 0,
    Sensitivity.MORE: 1,
    Sensitivity.DEFAULT: 2,
    Sensitivity.LESS: 4,
}
_MODE_SLIDES = {
    Sensitivity.ULTRA: 9,
    Sensitivity.MORE: 8,
    Sensitivity.DEFAULT: 8,
    Sensitivity.LESS: 6,
}


def min_core_len(genome_len: int, mode: Sensitivity = Sensitivity.DEFAULT) -> int:
    """The genome-size core ladder (Aligner.cpp:8722-8741) + mode add."""
    if genome_len <= 500_000:
        base = C_MIN_CORE_LEN
    elif genome_len <= 20_000_000:
        base = C_MIN_CORE_LEN + 3
    elif genome_len <= 250_000_000:
        base = C_MIN_CORE_LEN + 7
    elif genome_len <= 3_500_000_000:
        base = C_MIN_CORE_LEN + 8
    else:
        base = C_MIN_CORE_LEN + 11
    return base + _MODE_CORE_ADD[mode]


@dataclass(frozen=True)
class AlignParams:
    max_subs_per100: int = C_DFLT_ALLOWED_SUBS   # -s
    min_edit_dist: int = 1                       # -e (MMDelta), 1..2
    max_multi: int = C_DFLT_MAX_MULTI            # -R
    mode: Sensitivity = Sensitivity.DEFAULT      # -m
    strand: str = "both"                         # -Q: both|sense|antisense
    # TPU batching knobs (no reference analogue; candidate caps replace
    # the reference's per-core iteration cap MaxIter=50000, SfxArrayV2.h:12)
    cand_per_core: int = 48
    rescue_cand_per_core: int = 1024
    # progressive-sensitivity rescue ladder step 1: medium-width COMPLETE
    # enumeration (cores with > rescue_mid_H occurrences still skipped) —
    # the TPU form of the reference's over-occurring-seed suppression +
    # sensitivity ladder (InitOverOccKMers / MaxIter, SfxArrayV2.h:12;
    # progressive driver SfxArrayV2.cpp:7663-7760)
    rescue_mid_H: int = 256
    rescue_mid_cap: int = 1024
    # post-dedup unique-locus cap per strand; truncation raises the
    # overflow flag so affected reads go through the rescue pass
    max_cand_per_strand: int = 192
    batch_size: int = 4096
    # two-level seeding: a LONG-core first pass resolves the typical read
    # with ~50x fewer candidates; unresolved reads fall back to the full
    # reference-core pass (the TPU reformulation of the reference's own
    # progressive-sensitivity driver, SfxArrayV2.cpp:7663-7760) — see
    # derive_fast for the exactness guarantee
    fast_pass: bool = True

    def derive(self, read_len: int, genome_len: int) -> "DerivedParams":
        if self.max_subs_per100 == 0:
            max_tot_mm = 0
        else:
            max_tot_mm = max(1, int(0.5 + read_len * self.max_subs_per100 / 100.0))
        max_tot_mm = min(max_tot_mm, C_MAX_TOT_ALLOWED_SUBS)
        mcl = min_core_len(genome_len, self.mode)
        denom = max_tot_mm + (1 if self.min_edit_dist == 1 else 2)
        core_len = max(mcl, read_len // denom)
        slides_per100 = _MODE_SLIDES[self.mode]
        max_slides = max(1, (slides_per100 * read_len + 99) // 100)
        core_delta = max(read_len // max_slides - 1, core_len)
        core_len = min(core_len, 32)  # index keys bound compares to 32 bases
        return DerivedParams(
            read_len=read_len,
            max_tot_mm=max_tot_mm,
            core_len=core_len,
            core_delta=core_delta,
            max_slides=max_slides,
            offsets=tuple(
                core_offsets(read_len, core_len, core_delta, max_slides)
            ),
        )


    def derive_fast(self, read_len: int, genome_len: int,
                    lut_bases: int) -> "FastPassParams | None":
        """Long-core FIRST-PASS parameters for two-level seeding.

        Exactness guarantee (pigeonhole over disjoint cores): with n
        disjoint cores of length F fully inside a read, any target locus
        whose Hamming distance (mismatches + N positions) is <= n-1 has
        at least one clean exact core, so the pass discovers EVERY hit
        with mm <= G = n-1.  A read is therefore fully RESOLVED by this
        pass — best/locus/inst/uniqueness all provably equal to the full
        reference-core pass — iff

            best_found <= G + 1 - MMDelta   and no candidate-cap overflow

        (any undiscovered hit has mm >= G+1, so it can neither beat the
        best nor shrink the accept margin below MMDelta).  Unresolved
        reads rerun through the classic pass, mirroring the reference's
        progressive sensitivity (CSfxArrayV3::AlignReads ladder,
        libbiokanga/SfxArrayV2.cpp:7663-7760).

        F is chosen as the LUT prefix width when that alone keeps the
        expected junk-hit rate low (pure-LUT lookup, no binary search),
        else read_len//8; passes that would not coarsen the cores (or
        give < 3 disjoint cores) return None -> single-level alignment.
        """
        dp = self.derive(read_len, genome_len)
        if not self.fast_pass or self.max_subs_per100 == 0:
            return None
        junk_lut = genome_len / 4 ** lut_bases
        if lut_bases > dp.core_len and junk_lut <= 8.0:
            F = lut_bases
        else:
            F = min(max(read_len // 8, dp.core_len + 1), 32)
        if F <= dp.core_len:
            return None
        n_disjoint = read_len // F
        if n_disjoint < 3 or n_disjoint <= self.min_edit_dist:
            return None
        offsets = [i * F for i in range(n_disjoint)]
        if offsets[-1] + F < read_len:
            offsets.append(read_len - F)  # flush core: free extra looks
        dpf = DerivedParams(
            read_len=read_len, max_tot_mm=dp.max_tot_mm, core_len=F,
            core_delta=F, max_slides=len(offsets), offsets=tuple(offsets),
        )
        junk = genome_len / 4 ** F
        H = 16 if junk <= 1.0 else (32 if junk <= 4.0 else 48)
        cap = max(32, 2 * H)
        return FastPassParams(dp=dpf, H=H, cand_cap=cap)


@dataclass(frozen=True)
class DerivedParams:
    read_len: int
    max_tot_mm: int
    core_len: int
    core_delta: int
    max_slides: int
    offsets: tuple[int, ...]


@dataclass(frozen=True)
class FastPassParams:
    dp: "DerivedParams"
    H: int          # per-core candidate slots in the fast pass
    cand_cap: int   # post-dedup per-strand cap in the fast pass

    def resolved_bound(self, lengths, min_edit_dist: int):
        """Per-read max best_mm for which the fast pass is exact:
        n_cores(read) - MMDelta, with n_cores = disjoint long cores fully
        inside the read (ragged reads have fewer)."""
        import numpy as np

        F = self.dp.core_len
        n_cores = np.minimum(
            np.asarray(lengths, np.int32) // F, self.dp.read_len // F
        )
        return n_cores - np.int32(min_edit_dist)


def core_offsets(L: int, core_len: int, core_delta: int, max_slides: int):
    """Replicates LocateCoreMultiples' slide loop exactly
    (SfxArrayV2.cpp:5829-5848): offsets step by CoreDelta; the step before
    the last is shrunk so the final core lands flush with the read end;
    the loop stops when the (possibly shrunken) delta falls to
    <= CoreLen/3 or the slide cap is reached."""
    offs = []
    d = core_delta
    ofs = 0
    slides = 0
    while slides < max_slides and ofs <= L - core_len and d > core_len // 3:
        offs.append(ofs)
        if ofs + core_len + d > L:
            d = L - (ofs + core_len)
        slides += 1
        ofs += d
        if d <= 0:
            break
    return offs
