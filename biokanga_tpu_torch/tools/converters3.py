"""Copy of biokanga_tpu/tools/converters3.py (host numpy).

Remaining format converters / container generators (SURVEY §2.6 group 2):
genbioseq, genbiobed, genbiomultialign, fasta2struct.

Reference parity notes:
- genbioseq (genbioseq/genbioseq.cpp): fasta -> packed biosequence
  container (CBioSeqFile role, libbiokanga/BioSeqFile.cpp) — here the
  packed container is the framework's .rds npz store.
- genbiobed (genbiobed/genbiobed.cpp): BED -> preprocessed feature
  container (CBEDfile binary form) for fast annotation lookups.
- genbiomultialign (genbiomultialign/genbiomultialign.cpp): MAF multiple
  alignments -> packed .algn container (CMAlignFile role,
  libbiokanga/MAlignFile.cpp).
- fasta2struct (fasta2struct/fasta2struct.cpp:230-244): per-sequence DNA
  conformational characteristic profiles (CTwister octamer-table role,
  libbiokanga/Twister.cpp) — implemented as a vectorized dinucleotide-step
  lookup (B-DNA step parameters) with optional user parameter table,
  windowed min/max summaries, CSV output.
"""
from __future__ import annotations

import numpy as np

from ..seq.fasta import read_seqs


def genbioseq(inpaths: list[str], outpath: str) -> int:
    """Multifasta -> packed biosequence container (.rds npz store;
    CBioSeqFile::CreateBioseq role)."""
    from ..seq.rds import write_rds

    def gen():
        for path in inpaths:
            for rec in read_seqs(path):
                yield (rec.name, rec.codes)

    return write_rds(outpath, gen(), pe_interleaved=False)


def genbiobed(inpath: str, outpath: str) -> int:
    """BED -> preprocessed binary feature container: sorted feature
    arrays npz loadable via load_biobed (CBEDfile binary-form role)."""
    from ..seq.annotations import read_bed

    feats = read_bed(inpath)
    feats.sort(key=lambda f: (f.chrom, f.start, f.end))
    chroms = sorted({f.chrom for f in feats})
    cidx = {c: i for i, c in enumerate(chroms)}
    np.savez(
        outpath,
        format=np.array(["biobed-v1"]),
        chroms=np.array(chroms),
        chrom_id=np.array([cidx[f.chrom] for f in feats], dtype=np.int32),
        start=np.array([f.start for f in feats], dtype=np.int64),
        end=np.array([f.end for f in feats], dtype=np.int64),
        name=np.array([f.name for f in feats]),
        score=np.array([f.score for f in feats], dtype=np.float64),
        strand=np.array([f.strand for f in feats]),
    )
    return len(feats)


def load_biobed(path: str):
    """Load a genbiobed container -> list of (chrom, start, end, name,
    score, strand) tuples."""
    z = np.load(path, allow_pickle=False)
    assert str(z["format"][0]) == "biobed-v1", "not a biobed container"
    chroms = [str(c) for c in z["chroms"]]
    return [
        (chroms[int(ci)], int(s), int(e), str(n), float(sc), str(st))
        for ci, s, e, n, sc, st in zip(
            z["chrom_id"], z["start"], z["end"], z["name"], z["score"],
            z["strand"]
        )
    ]


def _parse_maf(inpath: str):
    """Yield MAF alignment blocks as (score, [(src, start, size, strand,
    src_size, aligned_text), ...])."""
    block_score = 0.0
    rows = []
    opener = open
    if inpath.endswith(".gz"):
        import gzip

        opener = gzip.open
    with opener(inpath, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("a"):
                if rows:
                    yield block_score, rows
                    rows = []
                block_score = 0.0
                for tok in line.split()[1:]:
                    if tok.startswith("score="):
                        block_score = float(tok[6:])
            elif line.startswith("s"):
                fl = line.split()
                rows.append(
                    (fl[1], int(fl[2]), int(fl[3]), fl[4], int(fl[5]), fl[6])
                )
            elif not line.strip() and rows:
                yield block_score, rows
                rows = []
    if rows:
        yield block_score, rows


_ALGN_ALPHA = "ACGTN-"


def genbiomultialign(inpaths: list[str], outpath: str) -> int:
    """MAF file(s) -> packed multiple-alignment container (.algn npz:
    per-block species rows with column-packed codes; CMAlignFile role)."""
    srcs: list[str] = []
    sidx: dict[str, int] = {}
    scores, blk_row_ofs = [], [0]
    row_src, row_start, row_size, row_strand, row_srcsize = [], [], [], [], []
    col_codes = []  # one flat int8 array per row (gap = 5)
    lut = np.full(256, 4, dtype=np.int8)
    for i, ch in enumerate(_ALGN_ALPHA):
        lut[ord(ch)] = i
        lut[ord(ch.lower())] = i
    n_blocks = 0
    for path in inpaths:
        for score, rows in _parse_maf(path):
            widths = {len(r[5]) for r in rows}
            if len(widths) != 1:
                raise ValueError(f"ragged MAF block in {path}")
            scores.append(score)
            for src, start, size, strand, srcsize, text in rows:
                if src not in sidx:
                    sidx[src] = len(srcs)
                    srcs.append(src)
                row_src.append(sidx[src])
                row_start.append(start)
                row_size.append(size)
                row_strand.append(0 if strand == "+" else 1)
                row_srcsize.append(srcsize)
                col_codes.append(
                    lut[np.frombuffer(text.encode(), dtype=np.uint8)]
                )
            blk_row_ofs.append(len(row_src))
            n_blocks += 1
    row_ofs = np.zeros(len(col_codes) + 1, dtype=np.int64)
    if col_codes:
        row_ofs[1:] = np.cumsum([len(c) for c in col_codes])
    np.savez(
        outpath,
        format=np.array(["algn-v1"]),
        srcs=np.array(srcs) if srcs else np.array([], dtype="U1"),
        block_score=np.array(scores, dtype=np.float64),
        block_row_ofs=np.array(blk_row_ofs, dtype=np.int64),
        row_src=np.array(row_src, dtype=np.int32),
        row_start=np.array(row_start, dtype=np.int64),
        row_size=np.array(row_size, dtype=np.int64),
        row_strand=np.array(row_strand, dtype=np.int8),
        row_srcsize=np.array(row_srcsize, dtype=np.int64),
        row_ofs=row_ofs,
        codes=(np.concatenate(col_codes) if col_codes
               else np.zeros(0, dtype=np.int8)),
    )
    return n_blocks


def load_biomultialign(path: str):
    """Load an .algn container -> (block_scores, blocks) where each block
    is a list of (src, start, size, strand, src_size, aligned_text)."""
    z = np.load(path, allow_pickle=False)
    assert str(z["format"][0]) == "algn-v1", "not an algn container"
    srcs = [str(s) for s in z["srcs"]]
    alpha = np.frombuffer(_ALGN_ALPHA.encode(), dtype=np.uint8)
    blocks = []
    bro = z["block_row_ofs"]
    for b in range(len(bro) - 1):
        rows = []
        for r in range(int(bro[b]), int(bro[b + 1])):
            text = alpha[
                z["codes"][int(z["row_ofs"][r]): int(z["row_ofs"][r + 1])]
            ].tobytes().decode()
            rows.append(
                (srcs[int(z["row_src"][r])], int(z["row_start"][r]),
                 int(z["row_size"][r]),
                 "+" if int(z["row_strand"][r]) == 0 else "-",
                 int(z["row_srcsize"][r]), text)
            )
        blocks.append(rows)
    return list(map(float, z["block_score"])), blocks


# --- fasta2struct -----------------------------------------------------------
# B-DNA dinucleotide-step conformational parameters (published consensus
# crystallographic means; Olson et al. PNAS 1998 style step tables).  Order
# of characteristics matches the reference CLI enumeration
# (fasta2struct.cpp:237): energy, minor-groove, major-groove, twist, roll,
# tilt, rise, slide, shift (rmsd/ORChid omitted — octamer-table specific).
STRUCT_PARAMS = ["energy", "minorgroove", "majorgroove", "twist", "roll",
                 "tilt", "rise", "slide", "shift"]

# rows: AA AC AG AT CA CC CG CT GA GC GG GT TA TC TG TT
_STEP_TABLE = np.array([
    # energy minor major twist roll  tilt  rise  slide shift
    [-1.00, 2.85, 3.40, 35.6, 0.7, -0.8, 3.27, -0.08, -0.02],  # AA
    [-1.44, 3.05, 3.40, 32.2, 0.7, 0.3, 3.36, -0.58, 0.13],   # AC
    [-1.28, 3.25, 3.40, 27.7, 4.5, -0.1, 3.34, -0.25, 0.02],  # AG
    [-0.88, 2.65, 3.40, 32.0, 1.1, 0.0, 3.31, -0.59, 0.00],   # AT
    [-1.45, 3.45, 3.40, 36.3, 4.7, 0.5, 3.33, 0.53, 0.04],    # CA
    [-1.84, 3.55, 3.40, 33.1, 3.6, 0.3, 3.42, -0.22, 0.09],   # CC
    [-2.17, 3.65, 3.40, 31.3, 5.4, 0.0, 3.39, 0.41, 0.00],    # CG
    [-1.28, 3.25, 3.40, 27.7, 4.5, 0.1, 3.34, -0.25, -0.02],  # CT
    [-1.30, 3.15, 3.40, 36.9, 1.9, -0.6, 3.37, 0.09, -0.02],  # GA
    [-2.24, 3.40, 3.40, 33.6, 0.3, 0.0, 3.40, -0.38, 0.00],   # GC
    [-1.84, 3.55, 3.40, 33.1, 3.6, -0.3, 3.42, -0.22, -0.09], # GG
    [-1.44, 3.05, 3.40, 32.2, 0.7, -0.3, 3.36, -0.58, -0.13], # GT
    [-0.58, 3.60, 3.40, 36.0, 3.3, 0.0, 3.42, 0.05, 0.00],    # TA
    [-1.30, 3.15, 3.40, 36.9, 1.9, 0.6, 3.37, 0.09, 0.02],    # TC
    [-1.45, 3.45, 3.40, 36.3, 4.7, -0.5, 3.33, 0.53, -0.04],  # TG
    [-1.00, 2.85, 3.40, 35.6, 0.7, 0.8, 3.27, -0.08, 0.02],   # TT
], dtype=np.float64)


def load_struct_params(path: str) -> np.ndarray:
    """Optional user parameter table: CSV rows `step,<9 values>` where step
    is a dinucleotide (AA..TT). Missing steps keep the built-in values."""
    table = _STEP_TABLE.copy()
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    with open(path) as f:
        for line in f:
            fl = [x.strip() for x in line.strip().split(",")]
            if len(fl) < 10 or len(fl[0]) != 2 or fl[0].upper() == "STEP":
                continue
            d = fl[0].upper()
            if d[0] in code and d[1] in code:
                table[code[d[0]] * 4 + code[d[1]]] = [
                    float(v) for v in fl[1:10]
                ]
    return table


def seq_struct_profile(codes: np.ndarray, param: str,
                       table: np.ndarray | None = None) -> np.ndarray:
    """Per-step conformational values for one sequence (length L -> L-1
    step values; steps touching an N are NaN)."""
    t = _STEP_TABLE if table is None else table
    col = STRUCT_PARAMS.index(param)
    c = np.asarray(codes, dtype=np.int64)
    a, b = c[:-1], c[1:]
    valid = (a < 4) & (b < 4)
    idx = np.where(valid, a * 4 + b, 0)
    vals = t[idx, col]
    return np.where(valid, vals, np.nan)


def fasta2struct(inpath: str, outpath: str, param: str = "minorgroove",
                 params_file: str | None = None, winlen: int = 0,
                 trunc: int = 0) -> int:
    """Mode-0 fasta conformation (fasta2struct.cpp): CSV of per-sequence
    conformational profiles — full profile stats plus optional sliding-
    window min/max (confwinlen role)."""
    table = load_struct_params(params_file) if params_file else None
    n = 0
    with open(outpath, "w") as out:
        out.write("\"Seq\",\"Param\",\"Len\",\"Mean\",\"Min\",\"Max\","
                  "\"WinLen\",\"WinMin\",\"WinMax\"\n")
        for rec in read_seqs(inpath):
            codes = rec.codes[:trunc] if trunc else rec.codes
            if len(codes) < 2:
                continue
            prof = seq_struct_profile(codes, param, table)
            finite = prof[np.isfinite(prof)]
            if finite.size == 0:
                continue
            wmin = wmax = float("nan")
            w = winlen if 0 < winlen <= len(prof) else len(prof)
            if finite.size >= 1:
                k = np.ones(w) / w
                means = np.convolve(np.nan_to_num(prof), k, mode="valid")
                cnts = np.convolve(np.isfinite(prof).astype(float), k,
                                   mode="valid")
                ok = cnts > 0.999
                if ok.any():
                    wmin = float(means[ok].min())
                    wmax = float(means[ok].max())
            name = rec.name.split()[0]
            out.write(
                f"\"{name}\",\"{param}\",{len(codes)},"
                f"{float(finite.mean()):.4f},{float(finite.min()):.4f},"
                f"{float(finite.max()):.4f},{w},{wmin:.4f},{wmax:.4f}\n"
            )
            n += 1
    return n
