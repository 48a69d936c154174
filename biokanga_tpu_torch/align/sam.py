"""Copy of biokanga_tpu/align/sam.py: the single-end and paired-end SAM
writers.

Role of the reference's CSAMfile SAM path (libbiokanga/SAMfile.cpp;
writer invoked from CAligner::WriteBAMReadHits, biokanga/Aligner.cpp:5543).
align/bam.sam_to_bam turns the SAM into BAM.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..seq.encode import codes_to_ascii, revcomp
from .pipeline import cigar_for


def sam_header(entry_names, entry_lengths, program="biokanga-tpu", version="0.1.0"):
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, ln in zip(entry_names, entry_lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    lines.append(f"@PG\tID:{program}\tPN:{program}\tVN:{version}")
    return "\n".join(lines) + "\n"


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int  # 1-based
    mapq: int
    cigar: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: tuple = ()

    def line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            self.rnext,
            str(self.pnext),
            str(self.tlen),
            self.seq,
            self.qual,
        ]
        fields.extend(self.tags)
        return "\t".join(fields)


def write_pe_sam(
    out,
    entry_names,
    entry_starts,
    names1, reads1, len1,
    names2, reads2, len2,
    pe_result,           # dict from PEAligner.align_pairs
    write_header=True,
    report_unmapped=True,
):
    """Write paired-end alignments with proper SAM flag/RNEXT/PNEXT/TLEN
    semantics (role of WriteBAMReadHits' PE path, Aligner.cpp:5543).  Of
    a mate's result only unique, locus, is_rc and best_mm are read.  The
    entry of every locus is looked up once per block, not once per
    record as in the JAX writer; the records are the same."""
    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        starts = np.asarray(entry_starts)
        if write_header:
            out.write(sam_header(entry_names, np.diff(starts)))
        res1, res2 = pe_result["res1"], pe_result["res2"]
        proper = pe_result["proper"]
        lines = []
        N = len(names1)
        ents, poss = [], []
        for res in (res1, res2):
            ent = np.searchsorted(starts, res["locus"][:N], "right") - 1
            ents.append(ent)
            poss.append(res["locus"][:N] - starts[ent] + 1)
        for i in range(N):
            for mate, (names, reads, lens, res, ores) in enumerate(
                (
                    (names1, reads1, len1, res1, res2),
                    (names2, reads2, len2, res2, res1),
                )
            ):
                L = int(lens[i])
                codes = reads[i, :L]
                mapped = bool(res["unique"][i])
                omapped = bool(ores["unique"][i])
                flag = 0x1 | (0x40 if mate == 0 else 0x80)
                if proper[i]:
                    flag |= 0x2
                if not mapped:
                    flag |= 0x4
                if not omapped:
                    flag |= 0x8
                if mapped and res["is_rc"][i]:
                    flag |= 0x10
                if omapped and ores["is_rc"][i]:
                    flag |= 0x20
                if mapped:
                    ent = int(ents[mate][i])
                    pos = int(poss[mate][i])
                    rname = entry_names[ent]
                    rc = bool(res["is_rc"][i])
                    seq = codes_to_ascii(revcomp(codes) if rc else codes).decode()
                    if omapped:
                        oent = int(ents[1 - mate][i])
                        rnext = "=" if oent == ent else entry_names[oent]
                        pnext = int(poss[1 - mate][i])
                        if proper[i]:
                            tl = int(pe_result["insert"][i])
                            tlen = tl if res["locus"][i] <= ores["locus"][i] else -tl
                        else:
                            tlen = 0
                    else:
                        rnext, pnext, tlen = "=", pos, 0
                    rec = SamRecord(
                        qname=names[i], flag=flag, rname=rname, pos=pos,
                        mapq=60, cigar=f"{L}M", rnext=rnext, pnext=pnext,
                        tlen=tlen, seq=seq, qual="*",
                        tags=(f"NM:i:{int(res['best_mm'][i])}",),
                    )
                elif report_unmapped:
                    rec = SamRecord(
                        qname=names[i], flag=flag, rname="*", pos=0, mapq=0,
                        cigar="*", seq=codes_to_ascii(codes).decode(), qual="*",
                    )
                else:
                    continue
                lines.append(rec.line())
        out.write("\n".join(lines) + ("\n" if lines else ""))
    finally:
        if close:
            out.close()


def write_alignments_sam(
    out,  # file-like (text) or path
    entry_names,
    entry_starts,  # (E+1,) absolute genome offsets
    names,         # list[str] read names
    reads,         # (B, L) int8 codes (as read from input, i.e. original strand)
    lengths,       # (B,) int32
    result,        # dict from AlignEngine.align_batch
    write_header=True,
    report_unmapped=True,
    space="base",  # "color": SOLiD reads; rc = reversal (no complement),
                   # SEQ is double-encoded colorspace (colors as ACGT)
):
    """Write one aligned block as SAM records.

    Unique hits: FLAG 0/16, POS 1-based within entry, CIGAR '<len>M'
    for a Hamming alignment, soft clips from `clip5`/`clip3` (chimeric
    and flank trims, which take precedence) or the indel/splice CIGAR of
    `cigar_op`, NM tag with mismatch count.
    Unaligned / multialigned reads are emitted as FLAG 4 records when
    `report_unmapped` (the reference reports them separately via
    ReportNoneAligned/ReportMultiAlign, Aligner.cpp:678-700).
    """
    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        starts = np.asarray(entry_starts)
        entry_lengths = np.diff(starts)
        if write_header:
            out.write(sam_header(entry_names, entry_lengths))
        unique = result["unique"]
        locus = result["locus"]
        is_rc = result["is_rc"]
        best_mm = result["best_mm"]
        cigar_op = result.get("cigar_op")
        op_len = result.get("op_len")
        split = result.get("split")
        ent = np.searchsorted(starts, locus, side="right") - 1
        pos_in_entry = locus - starts[np.clip(ent, 0, len(entry_names) - 1)]
        B = len(names)
        lines = []
        for i in range(B):
            L = int(lengths[i])
            codes = reads[i, :L]
            if unique[i]:
                rc = bool(is_rc[i])
                if rc and space == "color":
                    seq = codes_to_ascii(codes[::-1]).decode()
                else:
                    seq = codes_to_ascii(
                        revcomp(codes) if rc else codes).decode()
                clip5 = int(result["clip5"][i]) if "clip5" in result else 0
                clip3 = int(result["clip3"][i]) if "clip3" in result else 0
                if clip5 or clip3:  # chimeric soft-clips (AdaptiveTrim)
                    cig = (f"{clip5}S" if clip5 else "") + \
                          f"{L - clip5 - clip3}M" + \
                          (f"{clip3}S" if clip3 else "")
                elif cigar_op is not None and cigar_op[i] != 0:
                    cig = cigar_for(L, int(cigar_op[i]), int(op_len[i]),
                                    int(split[i]))
                else:
                    cig = f"{L}M"
                rec = SamRecord(
                    qname=names[i],
                    flag=16 if rc else 0,
                    rname=entry_names[int(ent[i])],
                    pos=int(pos_in_entry[i]) + 1,
                    mapq=60,
                    cigar=cig,
                    seq=seq,
                    qual="*",
                    tags=(f"NM:i:{int(best_mm[i])}",),
                )
            elif report_unmapped:
                rec = SamRecord(
                    qname=names[i],
                    flag=4,
                    rname="*",
                    pos=0,
                    mapq=0,
                    cigar="*",
                    seq=codes_to_ascii(codes).decode(),
                    qual="*",
                )
            else:
                continue
            lines.append(rec.line())
        out.write("\n".join(lines) + ("\n" if lines else ""))
    finally:
        if close:
            out.close()
