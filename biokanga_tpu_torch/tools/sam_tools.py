"""Copy of biokanga_tpu/tools/sam_tools.py (host numpy).

SAM utilities.

- filtchrom : filter SAM/BAM records by chromosome regex (capability match
  for `biokanga filtchrom`, CFilterSAMAlignments,
  biokanga/FilterSAMAlignments.cpp)
- remaploci : remap alignment loci between coordinate systems given a BED
  of part placements (capability match for `biokanga remaploci`,
  CRemapLoci, biokanga/RemapLoci.cpp) — the inverse of pseudogenome
  concatenation: alignments against a pseudo-chrom are lifted back to the
  original sequences.
"""
from __future__ import annotations

import re


def filter_sam_by_chrom(
    inpath: str, outpath: str, pattern: str, exclude: bool = False
) -> tuple[int, int]:
    """Keep records whose RNAME matches (or doesn't, with exclude)."""
    rx = re.compile(pattern)
    kept = total = 0
    with open(inpath) as fin, open(outpath, "w") as fout:
        for line in fin:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    m = re.search(r"SN:(\S+)", line)
                    name = m.group(1) if m else ""
                    if bool(rx.search(name)) == exclude:
                        continue
                fout.write(line)
                continue
            total += 1
            rname = line.split("\t", 3)[2]
            if bool(rx.search(rname)) != exclude:
                fout.write(line)
                kept += 1
    return total, kept


def load_bed_parts(bed_path: str):
    """BED rows (chrom, start, end, name) -> part list sorted by start."""
    parts = []
    with open(bed_path) as f:
        for line in f:
            fld = line.rstrip("\n").split("\t")
            if len(fld) < 4:
                continue
            parts.append((fld[0], int(fld[1]), int(fld[2]), fld[3]))
    parts.sort(key=lambda p: (p[0], p[1]))
    return parts


def remap_sam(inpath: str, outpath: str, bed_path: str) -> tuple[int, int]:
    """Remap records aligned to a concatenated pseudo-chrom back onto the
    original part sequences named in the BED. Records spanning part
    boundaries are dropped (counted)."""
    parts = load_bed_parts(bed_path)
    by_chrom: dict[str, list] = {}
    for chrom, s, e, name in parts:
        by_chrom.setdefault(chrom, []).append((s, e, name))
    import bisect

    starts = {c: [p[0] for p in ps] for c, ps in by_chrom.items()}

    remapped = dropped = 0
    with open(inpath) as fin, open(outpath, "w") as fout:
        for line in fin:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    continue  # headers rewritten below on first record
                fout.write(line)
                continue
            fld = line.rstrip("\n").split("\t")
            rname, pos = fld[2], int(fld[3])
            if rname == "*" or rname not in by_chrom:
                fout.write(line)
                continue
            # read span from CIGAR M/D/N ops
            span = sum(
                int(m.group(1))
                for m in re.finditer(r"(\d+)([MDN=X])", fld[5])
            ) or 1
            i = bisect.bisect_right(starts[rname], pos - 1) - 1
            if i < 0:
                dropped += 1
                continue
            s, e, name = by_chrom[rname][i]
            if pos - 1 + span > e:
                dropped += 1
                continue
            fld[2] = name
            fld[3] = str(pos - s)
            fout.write("\t".join(fld) + "\n")
            remapped += 1
    return remapped, dropped
