"""Copy of biokanga_tpu/tools/converters.py (host numpy).

Format converter tools (SURVEY §2.6 converter family).

Parity roles: bed2csv, csv2bed, csv2fasta, fasta2bed, BEDFilter,
BEDMerge, GFFfilter, GTFfilter, genwiggle/genNormWiggle,
splitmultifasta, fastafilter, FastaToPE — each a thin, well-tested
host-side transform (these are file-centric utilities in the reference;
one main .cpp each linking libbiokanga).
"""
from __future__ import annotations

import csv
import re

import numpy as np

from ..seq.annotations import read_bed
from ..seq.encode import ascii_to_codes, codes_to_ascii
from ..seq.fasta import read_seqs, write_fasta, write_fastq


def bed2csv(inpath: str, outpath: str) -> int:
    n = 0
    with open(outpath, "w") as out:
        out.write('"Chrom","Start","End","Name","Score","Strand"\n')
        for ft in read_bed(inpath):
            out.write(
                f'"{ft.chrom}",{ft.start},{ft.end},"{ft.name}",'
                f'{ft.score:g},"{ft.strand}"\n'
            )
            n += 1
    return n


def csv2bed(inpath: str, outpath: str) -> int:
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        rd = csv.reader(f)
        header = next(rd)
        col = {c.strip('"').lower(): i for i, c in enumerate(header)}
        ic, is_, ie = col.get("chrom", 0), col.get("start", 1), col.get("end", 2)
        iname = col.get("name")
        istr = col.get("strand")
        for r in rd:
            name = r[iname].strip('"') if iname is not None else f"f{n+1}"
            strand = r[istr].strip('"') if istr is not None else "+"
            out.write(
                f"{r[ic].strip(chr(34))}\t{int(r[is_])}\t{int(r[ie])}\t"
                f"{name}\t0\t{strand}\n"
            )
            n += 1
    return n


def csv2fasta(inpath: str, outpath: str, seq_col: str = "seq",
              name_col: str = "name") -> int:
    recs = []
    with open(inpath) as f:
        rd = csv.reader(f)
        header = next(rd)
        col = {c.strip('"').lower(): i for i, c in enumerate(header)}
        si = col.get(seq_col.lower(), len(header) - 1)
        ni = col.get(name_col.lower(), 0)
        for i, r in enumerate(rd):
            recs.append((r[ni].strip('"') or f"seq{i+1}",
                         ascii_to_codes(r[si].strip('"').encode())))
    write_fasta(outpath, recs)
    return len(recs)


def fasta2bed(inpath: str, outpath: str) -> int:
    """Full-length single-exon BED12 row per sequence (the reference's
    fasta2bed.cpp:256 format string)."""
    n = 0
    with open(outpath, "w") as out:
        for rec in read_seqs(inpath):
            name = rec.name.split()[0]
            ln = len(rec.codes)
            out.write(
                f"{name}\t0\t{ln}\t{name}\t0\t+\t0\t{ln}\t0\t1\t{ln},\t0\n"
            )
            n += 1
    return n


def bed_filter(inpath: str, outpath: str, chrom_regex: str | None = None,
               min_len: int = 0, max_len: int | None = None) -> int:
    rx = re.compile(chrom_regex) if chrom_regex else None
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        for line in f:
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 3:
                continue
            length = int(fl[2]) - int(fl[1])
            if rx and not rx.search(fl[0]):
                continue
            if length < min_len or (max_len is not None and length > max_len):
                continue
            out.write(line)
            n += 1
    return n


def bed_merge(inpath: str, outpath: str, max_gap: int = 0) -> int:
    """Merge overlapping/adjacent features (BEDMerge role)."""
    feats = read_bed(inpath)
    by_chrom: dict[str, list] = {}
    for ft in feats:
        by_chrom.setdefault(ft.chrom, []).append((ft.start, ft.end))
    n = 0
    with open(outpath, "w") as out:
        for chrom in sorted(by_chrom):
            ivs = sorted(by_chrom[chrom])
            cs, ce = ivs[0]
            for s, e in ivs[1:]:
                if s <= ce + max_gap:
                    ce = max(ce, e)
                else:
                    out.write(f"{chrom}\t{cs}\t{ce}\tm{n+1}\t0\t+\n")
                    n += 1
                    cs, ce = s, e
            out.write(f"{chrom}\t{cs}\t{ce}\tm{n+1}\t0\t+\n")
            n += 1
    return n


def gff_filter(inpath: str, outpath: str, feature_types=None,
               attr_regex: str | None = None) -> int:
    """GFF3/GTF row filter (GFFfilter/GTFfilter roles)."""
    rx = re.compile(attr_regex) if attr_regex else None
    types = set(feature_types) if feature_types else None
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        for line in f:
            if line.startswith("#"):
                out.write(line)
                continue
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 9:
                continue
            if types and fl[2] not in types:
                continue
            if rx and not rx.search(fl[8]):
                continue
            out.write(line)
            n += 1
    return n


def gen_wiggle(sam_path: str, outpath: str, normalise: bool = False,
               span: int = 1) -> int:
    """Coverage wiggle from SAM (genWiggle/genNormWiggle roles)."""
    from .expression import read_sam_loci

    chrom_lens: dict[str, int] = {}
    with open(sam_path) as f:
        for line in f:
            if not line.startswith("@"):
                break
            m = re.search(r"SN:(\S+).*LN:(\d+)", line)
            if m:
                chrom_lens[m.group(1)] = int(m.group(2))
    cov = {c: np.zeros(l, np.float64) for c, l in chrom_lens.items()}
    total = 0
    for chrom, s, e, strand in read_sam_loci(sam_path):
        if chrom in cov:
            cov[chrom][s:e] += 1
            total += 1
    scale = 1e6 / max(total, 1) if normalise else 1.0
    n_lines = 0
    with open(outpath, "w") as out:
        out.write('track type=wiggle_0 name="coverage"\n')
        for chrom, arr in cov.items():
            out.write(f"fixedStep chrom={chrom} start=1 step={span} "
                      f"span={span}\n")
            for i in range(0, len(arr), span):
                out.write(f"{arr[i:i+span].mean() * scale:g}\n")
                n_lines += 1
    return n_lines


def split_multifasta(inpath: str, outdir: str, prefix: str = "") -> int:
    import os

    n = 0
    for rec in read_seqs(inpath):
        safe = re.sub(r"[^\w.-]", "_", rec.name)
        write_fasta(os.path.join(outdir, f"{prefix}{safe}.fa"),
                    [(rec.name, rec.codes)])
        n += 1
    return n


def fasta_filter(inpath: str, outpath: str, min_len: int = 0,
                 dedupe_ids: bool = True) -> int:
    """Length filter + duplicate-identifier fixing (fastafilter role)."""
    seen: dict[str, int] = {}
    recs = []
    for rec in read_seqs(inpath):
        if len(rec.codes) < min_len:
            continue
        name = rec.name
        if dedupe_ids:
            if name in seen:
                seen[name] += 1
                name = f"{name}.{seen[rec.name]}"
            else:
                seen[name] = 0
        recs.append((name, rec.codes))
    write_fasta(outpath, recs)
    return len(recs)


def fasta_to_pe(inpath: str, out1: str, out2: str) -> int:
    """Split an interleaved PE file into mate files (FastaToPE role)."""
    r1, r2 = [], []
    for i, rec in enumerate(read_seqs(inpath)):
        (r1 if i % 2 == 0 else r2).append((rec.name, rec.codes))
    write_fasta(out1, r1)
    write_fasta(out2, r2)
    return len(r1)
