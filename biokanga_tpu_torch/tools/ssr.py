"""Copy of biokanga_tpu/tools/ssr.py (host numpy).

SSR (simple sequence repeat) discovery — capability match for
`biokanga ssr` (CSSRDiscovery, biokanga/SSRdiscovery.cpp): find tandem
repeats of 1..6 bp elements with at least `min_tandem` repeats
(cDfltMinTandemRpts = 5, SSRdiscovery.h:12), report CSV/BED.

Vectorised: for each element length k, a self-shift compare marks
positions where seq[i] == seq[i+k]; runs of length >= k*(min_rpts-1)
starting at a period boundary are SSRs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.encode import codes_to_ascii
from ..seq.fasta import read_seqs


@dataclass
class SSRHit:
    chrom: str
    start: int      # 0-based
    end: int        # exclusive
    unit_len: int
    repeats: int
    unit: str


def find_ssrs_in_seq(
    codes: np.ndarray, min_unit: int = 1, max_unit: int = 6,
    min_tandem: int = 5, chrom: str = "",
) -> list[SSRHit]:
    n = len(codes)
    hits: list[SSRHit] = []
    covered = np.zeros(n, dtype=bool)  # prefer smaller units (e.g. AT over ATAT)
    for k in range(min_unit, max_unit + 1):
        if n < k * min_tandem:
            continue
        eq = (codes[:-k] == codes[k:]) & (codes[:-k] < 4)
        # run-length encode eq
        d = np.diff(np.concatenate([[0], eq.view(np.int8), [0]]))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        for s, e in zip(starts, ends):
            run = e - s                       # matched shifted positions
            total = run + k                   # total repeated span
            rpts = total // k
            if rpts < min_tandem:
                continue
            span_end = s + (rpts * k)
            if covered[s:span_end].any():
                continue
            unit = codes_to_ascii(codes[s : s + k]).decode()
            # skip homopolymer-decomposable units (e.g. unit "AA" == "A")
            if k > 1 and len(set(unit)) == 1:
                continue
            covered[s:span_end] = True
            hits.append(SSRHit(chrom, int(s), int(span_end), k, int(rpts), unit))
    hits.sort(key=lambda h: h.start)
    return hits


def discover_ssrs(
    paths, min_unit=1, max_unit=6, min_tandem=5,
) -> list[SSRHit]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        for rec in read_seqs(p):
            out.extend(
                find_ssrs_in_seq(rec.codes, min_unit, max_unit, min_tandem,
                                 chrom=rec.name)
            )
    return out


def write_ssrs_csv(path, hits):
    with open(path, "w") as f:
        f.write('"SSR_ID","Chrom","Start","End","UnitLen","Repeats","Unit"\n')
        for i, h in enumerate(hits, 1):
            f.write(
                f'{i},"{h.chrom}",{h.start},{h.end},{h.unit_len},'
                f'{h.repeats},"{h.unit}"\n'
            )


def write_ssrs_bed(path, hits):
    with open(path, "w") as f:
        for h in hits:
            f.write(
                f"{h.chrom}\t{h.start}\t{h.end}\t{h.unit}x{h.repeats}\t0\t+\n"
            )
