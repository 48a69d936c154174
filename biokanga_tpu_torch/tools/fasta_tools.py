"""Copy of biokanga_tpu/tools/fasta_tools.py (host numpy).

FASTA utility subcommands.

- fasta2nxx : N10..N90 length distribution + composition stats
  (reference: biokanga/FastaNxx.cpp, `fasta2nxx` subcommand)
- xfasta    : extract subsequences / filter by length or name
  (reference: biokanga/fastaextract.cpp, `xfasta`)
- pseudogenome : concatenate sequences into a pseudo-genome with an
  accompanying BED of the original parts
  (reference: biokanga/genpseudogenome.cpp, `pseudogenome`)
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..seq.encode import codes_to_ascii
from ..seq.fasta import read_seqs, write_fasta


@dataclass
class NxxStats:
    num_seqs: int
    total_bp: int
    min_len: int
    max_len: int
    mean_len: float
    nxx: dict  # {10: N10, 20: N20, ... 90: N90}
    base_counts: np.ndarray  # A,C,G,T,N
    gc_pcnt: float


def fasta_nxx(paths: list[str] | str) -> NxxStats:
    if isinstance(paths, str):
        paths = [paths]
    lengths = []
    base_counts = np.zeros(5, dtype=np.int64)
    for p in paths:
        for rec in read_seqs(p):
            lengths.append(len(rec.codes))
            base_counts += np.bincount(
                np.clip(rec.codes, 0, 4), minlength=5
            ).astype(np.int64)
    if not lengths:
        raise ValueError("no sequences")
    lengths = np.sort(np.array(lengths, dtype=np.int64))[::-1]
    total = int(lengths.sum())
    csum = np.cumsum(lengths)
    nxx = {}
    for pct in range(10, 100, 10):
        k = int(np.searchsorted(csum, total * pct / 100.0))
        nxx[pct] = int(lengths[min(k, len(lengths) - 1)])
    acgt = base_counts[:4].sum()
    return NxxStats(
        num_seqs=len(lengths),
        total_bp=total,
        min_len=int(lengths[-1]),
        max_len=int(lengths[0]),
        mean_len=total / len(lengths),
        nxx=nxx,
        base_counts=base_counts,
        gc_pcnt=100.0 * (base_counts[1] + base_counts[2]) / max(acgt, 1),
    )


def xfasta_extract(
    inpath: str,
    outpath: str,
    name_pattern: str | None = None,
    min_len: int = 0,
    max_len: int | None = None,
    start: int = 0,           # 0-based subsequence window applied per seq
    end: int | None = None,
) -> int:
    rx = re.compile(name_pattern) if name_pattern else None
    n = 0

    def gen():
        nonlocal n
        for rec in read_seqs(inpath):
            if rx and not rx.search(rec.name):
                continue
            L = len(rec.codes)
            if L < min_len or (max_len is not None and L > max_len):
                continue
            s = rec.codes[start : end if end is not None else L]
            if len(s) == 0:
                continue
            n += 1
            yield rec.name, s

    write_fasta(outpath, gen())
    return n


def gen_pseudogenome(
    inpaths: list[str] | str,
    out_fasta: str,
    out_bed: str | None = None,
    pseudo_name: str = "PseudoG",
    sep_n: int = 100,
) -> tuple[int, int]:
    """Concatenate all sequences into one pseudo-chromosome, parts separated
    by `sep_n` Ns; write a BED mapping parts back to original names."""
    if isinstance(inpaths, str):
        inpaths = [inpaths]
    parts = []
    bed_rows = []
    ofs = 0
    for p in inpaths:
        for rec in read_seqs(p):
            if parts:
                parts.append(np.full(sep_n, 4, dtype=np.int8))
                ofs += sep_n
            bed_rows.append((pseudo_name, ofs, ofs + len(rec.codes), rec.name))
            parts.append(rec.codes)
            ofs += len(rec.codes)
    cat = np.concatenate(parts) if parts else np.zeros(0, np.int8)
    write_fasta(out_fasta, [(pseudo_name, cat)])
    if out_bed:
        with open(out_bed, "w") as f:
            for chrom, s, e, name in bed_rows:
                f.write(f"{chrom}\t{s}\t{e}\t{name}\t0\t+\n")
    return len(bed_rows), len(cat)
