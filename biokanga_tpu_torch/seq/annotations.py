"""Copy of biokanga_tpu/seq/annotations.py: BED (incl. BED12 exons),
GFF3 and GTF parsers and interval queries.

Parity role: CBEDfile (libbiokanga/BEDfile.cpp — feature/exon queries,
spliced transcript support), CGFFFile, CGTFFile.  Host-side, returning
numpy-backed feature tables ready for vectorised interval queries.
"""
from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Feature:
    chrom: str
    start: int           # 0-based
    end: int             # exclusive
    name: str
    score: float = 0.0
    strand: str = "+"
    exon_starts: list = field(default_factory=list)  # relative to start
    exon_sizes: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)

    @property
    def exon_count(self):
        return max(1, len(self.exon_sizes))

    def exons(self):
        if not self.exon_sizes:
            return [(self.start, self.end)]
        return [
            (self.start + s, self.start + s + l)
            for s, l in zip(self.exon_starts, self.exon_sizes)
        ]

    def spliced_len(self):
        return sum(e - s for s, e in self.exons())


def _open(path):
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.seek(0)
        return gzip.open(f, "rt")
    f.seek(0)
    return open(path, "r")


def read_bed(path: str) -> list[Feature]:
    out = []
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "track", "browser")):
                continue
            fl = line.split("\t")
            feat = Feature(
                chrom=fl[0], start=int(fl[1]), end=int(fl[2]),
                name=fl[3] if len(fl) > 3 else f"feat{len(out)+1}",
                score=float(fl[4]) if len(fl) > 4 and fl[4] != "." else 0.0,
                strand=fl[5] if len(fl) > 5 else "+",
            )
            if len(fl) >= 12:  # BED12 with exon blocks
                sizes = [int(x) for x in fl[10].rstrip(",").split(",") if x]
                starts = [int(x) for x in fl[11].rstrip(",").split(",") if x]
                feat.exon_sizes = sizes
                feat.exon_starts = starts
                feat.attrs["thick_start"] = int(fl[6])
                feat.attrs["thick_end"] = int(fl[7])
            out.append(feat)
    return out


_GTF_ATTR = re.compile(r'(\w+)\s+"([^"]*)"')
_GFF_ATTR = re.compile(r"(\w+)=([^;]*)")


def read_gtf(path: str, feature_types=("exon",)) -> list[Feature]:
    """GTF exons grouped into transcripts (spliced features)."""
    groups: dict[str, Feature] = {}
    with _open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 9 or fl[2] not in feature_types:
                continue
            attrs = dict(_GTF_ATTR.findall(fl[8]))
            tid = attrs.get("transcript_id", attrs.get("gene_id", fl[8]))
            s, e = int(fl[3]) - 1, int(fl[4])
            g = groups.get(tid)
            if g is None:
                g = Feature(chrom=fl[0], start=s, end=e, name=tid,
                            strand=fl[6], attrs=attrs)
                g.exon_starts, g.exon_sizes = [], []
                groups[tid] = g
            g.start = min(g.start, s)
            g.end = max(g.end, e)
            g.exon_starts.append(s)
            g.exon_sizes.append(e - s)
    out = []
    for g in groups.values():
        order = np.argsort(g.exon_starts)
        abs_starts = [g.exon_starts[i] for i in order]
        g.exon_sizes = [g.exon_sizes[i] for i in order]
        g.exon_starts = [s - g.start for s in abs_starts]
        out.append(g)
    out.sort(key=lambda x: (x.chrom, x.start))
    return out


def read_gff3(path: str, feature_types=("gene", "mRNA", "exon")) -> list[Feature]:
    out = []
    with _open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 9 or fl[2] not in feature_types:
                continue
            attrs = dict(_GFF_ATTR.findall(fl[8]))
            out.append(
                Feature(
                    chrom=fl[0], start=int(fl[3]) - 1, end=int(fl[4]),
                    name=attrs.get("ID", attrs.get("Name", fl[8])),
                    strand=fl[6], attrs=attrs,
                )
            )
    return out


class FeatureIndex:
    """Vectorised interval overlap queries over a feature table
    (CBEDfile's locus->feature query role)."""

    def __init__(self, features: list[Feature]):
        self.features = features
        self.by_chrom: dict[str, np.ndarray] = {}
        self._starts: dict[str, np.ndarray] = {}
        self._maxend: dict[str, np.ndarray] = {}
        chroms: dict[str, list[int]] = {}
        for i, ft in enumerate(features):
            chroms.setdefault(ft.chrom, []).append(i)
        for c, idxs in chroms.items():
            idxs = sorted(idxs, key=lambda i: features[i].start)
            arr = np.array(idxs, dtype=np.int64)
            starts = np.array([features[i].start for i in idxs], np.int64)
            ends = np.array([features[i].end for i in idxs], np.int64)
            self.by_chrom[c] = arr
            self._starts[c] = starts
            self._maxend[c] = np.maximum.accumulate(ends)

    def overlapping(self, chrom: str, start: int, end: int) -> list[int]:
        """Feature indices overlapping [start, end)."""
        if chrom not in self.by_chrom:
            return []
        starts = self._starts[chrom]
        maxend = self._maxend[chrom]
        idxs = self.by_chrom[chrom]
        hi = int(np.searchsorted(starts, end, side="left"))
        out = []
        j = hi - 1
        while j >= 0 and maxend[j] > start:
            ft = self.features[idxs[j]]
            if ft.end > start and ft.start < end:
                out.append(int(idxs[j]))
            j -= 1
        return out
