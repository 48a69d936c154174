"""Copy of biokanga_tpu/tools/converters2.py (host numpy).

Second converter/utility batch (SURVEY §2.6 tool tail).

Parity roles (one reference tool dir each, all thin mains over libbiokanga):
psl2csv, blast2csv, csv2stats, csvfilter, csvmerge, csv2feat, fasta2dist,
genGenomeFromAGP, dmpbioseq, HammingDist.
"""
from __future__ import annotations

import csv
import re

import numpy as np

from ..seq.encode import ascii_to_codes, revcomp
from ..seq.fasta import read_seqs, write_fasta

PSL_COLS = [
    "matches", "misMatches", "repMatches", "nCount", "qNumInsert",
    "qBaseInsert", "tNumInsert", "tBaseInsert", "strand", "qName", "qSize",
    "qStart", "qEnd", "tName", "tSize", "tStart", "tEnd", "blockCount",
    "blockSizes", "qStarts", "tStarts",
]


def psl2csv(inpath: str, outpath: str) -> int:
    """PSL (BLAT/blitz output) -> CSV (psl2csv tool role)."""
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        out.write(",".join(f'"{c}"' for c in PSL_COLS) + "\n")
        for line in f:
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 21 or not fl[0].isdigit():
                continue  # skip psLayout header block
            vals = []
            for i, v in enumerate(fl[:21]):
                vals.append(f'"{v}"' if PSL_COLS[i] in
                            ("strand", "qName", "tName", "blockSizes",
                             "qStarts", "tStarts") else v)
            out.write(",".join(vals) + "\n")
            n += 1
    return n


BLAST6_COLS = [
    "qseqid", "sseqid", "pident", "length", "mismatch", "gapopen",
    "qstart", "qend", "sstart", "send", "evalue", "bitscore",
]


def blast2csv(inpath: str, outpath: str) -> int:
    """BLAST tabular (-outfmt 6) -> CSV (blast2csv tool role)."""
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        out.write(",".join(f'"{c}"' for c in BLAST6_COLS) + "\n")
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 12:
                continue
            vals = [f'"{fl[0]}"', f'"{fl[1]}"'] + fl[2:12]
            out.write(",".join(vals) + "\n")
            n += 1
    return n


def _read_csv(inpath):
    with open(inpath) as f:
        rd = csv.reader(f)
        header = [c.strip('"') for c in next(rd)]
        rows = [r for r in rd if r]
    return header, rows


def csv2stats(inpath: str, outpath: str) -> int:
    """Numeric column summary stats of a CSV (csv2stats tool role)."""
    header, rows = _read_csv(inpath)
    n = 0
    with open(outpath, "w") as out:
        out.write('"Column","N","Min","Max","Mean","Median","StdDev"\n')
        for j, name in enumerate(header):
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[j].strip('"')))
                except (ValueError, IndexError):
                    pass
            if not vals:
                continue
            a = np.asarray(vals)
            out.write(f'"{name}",{a.size},{a.min():g},{a.max():g},'
                      f"{a.mean():.6g},{np.median(a):.6g},"
                      f"{a.std(ddof=0):.6g}\n")
            n += 1
    return n


def csvfilter(inpath: str, outpath: str, column: str, op: str,
              value: str) -> int:
    """Row filter on one column (csvfilter tool role).

    op: eq/ne/lt/le/gt/ge (numeric when both sides parse) or 'match'
    (regex on the raw field).
    """
    header, rows = _read_csv(inpath)
    low = [h.lower() for h in header]
    if column.lower() not in low:
        raise ValueError(f"no column '{column}' in {header}")
    j = low.index(column.lower())
    rx = re.compile(value) if op == "match" else None
    try:
        numval = float(value)
    except ValueError:
        numval = None
    n = 0
    with open(inpath) as f, open(outpath, "w") as out:
        out.write(next(f))
        rd = csv.reader(f)
        import operator as _op
        ops = {"eq": _op.eq, "ne": _op.ne, "lt": _op.lt, "le": _op.le,
               "gt": _op.gt, "ge": _op.ge}
        for r in rd:
            if not r:
                continue
            cell = r[j].strip('"')
            if rx is not None:
                ok = bool(rx.search(cell))
            else:
                try:
                    ok = (numval is not None
                          and ops[op](float(cell), numval))
                except ValueError:
                    ok = ops[op](cell, value)
            if ok:
                out.write(",".join(
                    f'"{c}"' if not _is_num(c) else c for c in r) + "\n")
                n += 1
    return n


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def csvmerge(inpaths: list[str], outpath: str, key: str) -> int:
    """Outer-join CSV files on a key column (csvmerge tool role)."""
    tables = []
    for p in inpaths:
        header, rows = _read_csv(p)
        low = [h.lower() for h in header]
        j = low.index(key.lower())
        tables.append((p, header, j,
                       {r[j].strip('"'): r for r in rows}))
    keys: list[str] = []
    seen = set()
    for _, _, _, d in tables:
        for k in d:
            if k not in seen:
                seen.add(k)
                keys.append(k)
    with open(outpath, "w") as out:
        cols = [f'"{key}"']
        for p, header, j, _ in tables:
            cols += [f'"{p}:{h}"' for i, h in enumerate(header) if i != j]
        out.write(",".join(cols) + "\n")
        for k in keys:
            row = [f'"{k}"']
            for _, header, j, d in tables:
                r = d.get(k)
                for i in range(len(header)):
                    if i == j:
                        continue
                    row.append(r[i] if r is not None and i < len(r) else "")
            out.write(",".join(row) + "\n")
    return len(keys)


def csv2feat(inpath: str, outpath: str) -> int:
    """CSV loci -> BED feature file (csv2feat tool role)."""
    header, rows = _read_csv(inpath)
    low = [h.lower() for h in header]

    def col(*names, default=None):
        for nm in names:
            if nm in low:
                return low.index(nm)
        return default

    ic = col("chrom", "chr", default=0)
    is_ = col("start", "loci", default=1)
    ie = col("end", default=None)
    iname = col("name", "feature", "feat")
    istr = col("strand")
    n = 0
    with open(outpath, "w") as out:
        for r in rows:
            s = int(float(r[is_].strip('"')))
            e = int(float(r[ie].strip('"'))) if ie is not None else s + 1
            name = (r[iname].strip('"') if iname is not None else f"f{n+1}")
            strand = r[istr].strip('"') if istr is not None else "+"
            out.write(f"{r[ic].strip(chr(34))}\t{s}\t{e}\t{name}\t0\t"
                      f"{strand}\n")
            n += 1
    return n


def fasta2dist(inpath: str, outpath: str, kmerlen: int = 4) -> int:
    """Pairwise K-mer-composition distance matrix CSV (fasta2dist role).

    Distance = 1 - cosine similarity of K-mer frequency vectors; the
    all-pairs step is one normalised Gram matmul (MXU-shaped when run
    under jax; numpy here as readsets are tiny)."""
    names, profs = [], []
    for rec in read_seqs(inpath):
        c = rec.codes
        if len(c) < kmerlen:
            continue
        v = np.zeros(len(c) - kmerlen + 1, np.int64)
        good = np.ones(len(v), bool)
        for j in range(kmerlen):
            cj = c[j: len(c) - kmerlen + 1 + j]
            good &= cj < 4
            v = v * 4 + np.clip(cj, 0, 3)
        counts = np.bincount(v[good], minlength=4 ** kmerlen).astype(float)
        norm = np.linalg.norm(counts)
        profs.append(counts / (norm or 1.0))
        names.append(rec.name)
    P = np.asarray(profs)
    D = 1.0 - P @ P.T
    with open(outpath, "w") as out:
        out.write('"Seq",' + ",".join(f'"{n}"' for n in names) + "\n")
        for i, nm in enumerate(names):
            out.write(f'"{nm}",' +
                      ",".join(f"{max(D[i, j], 0.0):.6f}"
                               for j in range(len(names))) + "\n")
    return len(names)


def agp2genome(agp_path: str, contigs_path: str, outpath: str) -> int:
    """AGP v2 + component FASTA -> assembled genome FASTA
    (genGenomeFromAGP tool role)."""
    comps = {rec.name: rec.codes for rec in read_seqs(contigs_path)}
    objects: dict[str, list[np.ndarray]] = {}
    order: list[str] = []
    with open(agp_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fl = line.rstrip("\n").split("\t")
            obj, comp_type = fl[0], fl[4]
            if obj not in objects:
                objects[obj] = []
                order.append(obj)
            if comp_type in ("N", "U"):
                objects[obj].append(np.full(int(fl[5]), 4, np.int8))
            else:
                cid, cs, ce, orient = fl[5], int(fl[6]), int(fl[7]), fl[8]
                if cid not in comps:
                    raise ValueError(f"AGP component '{cid}' not in contigs")
                seg = comps[cid][cs - 1: ce]
                if orient in ("-", "minus"):
                    seg = revcomp(seg)
                objects[obj].append(seg)
    write_fasta(outpath,
                ((obj, np.concatenate(objects[obj])) for obj in order))
    return len(order)


def dmpbioseq(inpath: str, outpath: str, max_seqs: int | None = None) -> int:
    """Dump a packed container (.rds or index .npz) to readable text
    (dmpbioseq tool role)."""
    from ..seq.encode import codes_to_ascii
    from ..seq.rds import RDSFile, is_rds

    n = 0
    with open(outpath, "w") as out:
        if is_rds(inpath):
            f = RDSFile(inpath)
            out.write(f"# rds container: {f.n_reads} reads, "
                      f"{int(f.meta[2])} bases\n")
            for name, codes, fl in f.records():
                out.write(f">{name} len={len(codes)} flags={fl:#x}\n")
                out.write(codes_to_ascii(codes).decode() + "\n")
                n += 1
                if max_seqs and n >= max_seqs:
                    break
        else:
            from ..index.build import load_index

            idx = load_index(inpath)
            out.write(f"# index: {idx.num_entries} entries, "
                      f"{idx.total_len} bp\n")
            for i, name in enumerate(idx.entry_names):
                s = int(idx.entry_starts[i])
                e = int(idx.entry_starts[i + 1]
                        if i + 1 < len(idx.entry_starts) else idx.total_len)
                out.write(f">{name} start={s} len={e - s}\n")
                out.write(codes_to_ascii(
                    np.asarray(idx.codes[s:e])).decode() + "\n")
                n += 1
                if max_seqs and n >= max_seqs:
                    break
    return n


def hamming_dist(inpath: str, outpath: str, window: int = 0) -> int:
    """Transform a uhamming CSV ("Chrom","Loci","Hamming") into a Hamming
    histogram, optionally adding per-window mean rows (HammingDist role)."""
    header, rows = _read_csv(inpath)
    hams = np.array([int(r[2]) for r in rows], np.int64)
    hist = np.bincount(hams) if hams.size else np.zeros(1, np.int64)
    n = 0
    with open(outpath, "w") as out:
        out.write('"Hamming","Count","Frac"\n')
        tot = max(int(hist.sum()), 1)
        for h, c in enumerate(hist):
            out.write(f"{h},{int(c)},{int(c) / tot:.6f}\n")
            n += 1
        if window:
            out.write('"Chrom","WindowStart","MeanHamming"\n')
            by_chrom: dict[str, list[tuple[int, int]]] = {}
            for r in rows:
                by_chrom.setdefault(r[0].strip('"'), []).append(
                    (int(r[1]), int(r[2])))
            for chrom, pts in by_chrom.items():
                pts.sort()
                loci = np.array([p[0] for p in pts])
                vals = np.array([p[1] for p in pts], float)
                for ws in range(0, int(loci.max()) + 1, window):
                    m = (loci >= ws) & (loci < ws + window)
                    if m.any():
                        out.write(f'"{chrom}",{ws},{vals[m].mean():.4f}\n')
                        n += 1
    return n
