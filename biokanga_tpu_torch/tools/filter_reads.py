"""Copy of biokanga_tpu/tools/filter_reads.py (host numpy).

Read filtering — capability match for `biokanga filter`
(CArtefactReduce, biokanga/ArtefactReduce.cpp): end trims, max-N and
min-Phred acceptance, exact-duplicate removal (PE-aware), and 3' adaptor
(contaminant) trimming.

Host-side vectorised numpy over read blocks (this stage is IO-bound);
duplicate detection hashes 2-bit-packed sequences.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..seq.encode import revcomp
from ..seq.fasta import ReadBlock, read_blocks, write_fastq


@dataclass
class FilterParams:
    trim5: int = 0
    trim3: int = 0
    max_ns: int = 1              # reference -n MaxNs default 1 per 100bp
    min_phred: int = 0           # minimum mean Phred to accept
    min_len: int = 50            # reference MinAcceptReadLen-ish
    dedupe: bool = True
    adapters: list = field(default_factory=list)  # int8 code arrays
    adapter_min_overlap: int = 5
    adapter_max_subs: int = 1
    # full CContaminants DB (flank overlay types 5'/3' x PE1/PE2 + vector
    # containment, seq/contaminants.py); overrides `adapters` when set
    contaminants: object | None = None
    contam_min_overlap: int = 5
    contam_subs_rate: int = 1    # subs per 25bp of overlap (0 = exact)
    # near-duplicate reduction (ArtefactReduce sparse-index role)
    near_dedupe: bool = False
    near_max_subs: int = 2


@dataclass
class FilterStats:
    total: int = 0
    accepted: int = 0
    trimmed_adapter: int = 0
    trimmed_contam5: int = 0
    trimmed_contam3: int = 0
    rej_ns: int = 0
    rej_phred: int = 0
    rej_len: int = 0
    rej_dup: int = 0
    rej_near_dup: int = 0
    rej_vector: int = 0


def _pack_for_hash(codes: np.ndarray, length: int) -> bytes:
    return codes[:length].tobytes()


def near_duplicate_mask(seqs: list[np.ndarray], max_subs: int = 2,
                        anchors=(0, 16)) -> np.ndarray:
    """(N,) bool — True for reads that NEARLY duplicate an earlier read
    (same length, Hamming distance <= max_subs).

    The role of the reference's sparse-suffix-index near-duplicate pass
    (CKangadna etSfxSparsity / ArtefactReduce near-dup,
    biokanga/Kangadna.h:100-107): anchored detection — reads group by an
    exact 16-base window at each anchor offset; within a group every read
    compares (vectorised) against the group's first member.  A duplicate
    escapes only if it has a substitution inside EVERY anchor window,
    matching the reference's sparse-anchor guarantee."""
    N = len(seqs)
    dup = np.zeros(N, bool)
    if N == 0:
        return dup
    lens = np.array([len(s) for s in seqs])
    for L in np.unique(lens):
        rows = np.nonzero(lens == L)[0]
        if len(rows) < 2:
            continue
        mat = np.stack([seqs[i] for i in rows])
        k = min(16, int(L))
        for a in anchors:
            if a + k > L:
                continue
            live = np.nonzero(~dup[rows])[0]
            if len(live) < 2:
                break
            sub = mat[live]
            key = np.zeros(len(live), np.uint64)
            for j in range(k):
                key = (key << np.uint64(2)) | np.uint64(3) & sub[
                    :, a + j].astype(np.uint64)
            order = np.argsort(key, kind="stable")
            sk = key[order]
            run_start = np.concatenate([[True], sk[1:] != sk[:-1]])
            run_id = np.cumsum(run_start) - 1
            first_of_run = order[run_start][run_id]  # per sorted position
            reps = sub[first_of_run]
            mm = (sub[order] != reps).sum(axis=1)
            is_dup = (mm <= max_subs) & ~run_start
            dup[rows[live[order[is_dup]]]] = True
    return dup


def _trim_adapter_3p(seq: np.ndarray, adapter: np.ndarray,
                     min_ov: int, max_subs: int) -> int:
    """Return new length after trimming a 3' adapter overlap (or len(seq)).
    Checks every overlap where the adapter prefix overhangs the read 3' end,
    longest first (reference flank-overlay semantics, Contaminants.h:31)."""
    L = len(seq)
    amax = min(len(adapter), L)
    for ov in range(amax, min_ov - 1, -1):
        mm = int(np.sum(seq[L - ov :] != adapter[:ov]))
        if mm <= max_subs:
            return L - ov
    return L


def filter_reads(
    inpath: str,
    outpath: str,
    params: FilterParams | None = None,
    pair_inpath: str | None = None,
    pair_outpath: str | None = None,
) -> FilterStats:
    p = params or FilterParams()
    st = FilterStats()
    seen: set[bytes] = set()

    out1 = []
    out2 = []
    pe = pair_inpath is not None
    blocks1 = read_blocks(inpath, block_size=8192)
    blocks2 = read_blocks(pair_inpath, block_size=8192) if pe else None

    while True:
        try:
            blk1 = next(blocks1)
        except StopIteration:
            break
        blk2 = next(blocks2) if pe else None
        B = len(blk1.names)
        # block-vectorised contaminant matching (flank overlays + vector
        # containment) on the post-end-trim windows
        ctrims = {}
        if p.contaminants is not None:
            from ..seq.contaminants import T_3PE1, T_3PE2, T_5PE1, T_5PE2

            db = p.contaminants
            for mate, blk in enumerate((blk1, blk2) if pe else (blk1,)):
                c = blk.codes[:, p.trim5:]
                ln = np.clip(blk.lengths - p.trim5 - p.trim3, 0, None)
                t5 = db.match_flank(
                    c, ln, T_5PE2 if mate else T_5PE1,
                    min_overlap=p.contam_min_overlap,
                    subs_rate=p.contam_subs_rate,
                )
                t3 = db.match_flank(
                    c, ln, T_3PE2 if mate else T_3PE1,
                    min_overlap=p.contam_min_overlap,
                    subs_rate=p.contam_subs_rate,
                )
                vec = db.match_vectors(c, ln, is_pe2=bool(mate))
                ctrims[mate] = (t5, t3, vec)
        for i in range(B):
            st.total += 1
            recs = []
            ok = True
            for mate, blk in enumerate((blk1, blk2) if pe else (blk1,)):
                L = int(blk.lengths[i])
                seq = blk.codes[i, :L].copy()
                qual = blk.quals[i, :L].copy() if blk.quals is not None else None
                # end trims
                s5, s3 = p.trim5, L - p.trim3
                seq = seq[s5:s3]
                qual = qual[s5:s3] if qual is not None else None
                # contaminant DB: vector containment rejects; flank
                # overlays trim (CContaminants semantics)
                if ctrims:
                    t5, t3, vec = ctrims[mate]
                    if vec[i]:
                        st.rej_vector += 1
                        ok = False
                        break
                    a, b = int(t5[i]), len(seq) - int(t3[i])
                    if a > 0:
                        st.trimmed_contam5 += 1
                    if int(t3[i]) > 0:
                        st.trimmed_contam3 += 1
                    seq = seq[a:b]
                    qual = qual[a:b] if qual is not None else None
                # adaptor trim
                for ad in p.adapters:
                    nl = _trim_adapter_3p(seq, ad, p.adapter_min_overlap,
                                          p.adapter_max_subs)
                    if nl < len(seq):
                        st.trimmed_adapter += 1
                        seq = seq[:nl]
                        qual = qual[:nl] if qual is not None else None
                # acceptance
                n_ns = int(np.sum(seq >= 4))
                max_ns = max(1, (len(seq) * p.max_ns) // 100) if p.max_ns else 0
                if p.max_ns and n_ns > max_ns:
                    st.rej_ns += 1
                    ok = False
                    break
                if p.min_phred and qual is not None and len(qual):
                    if (qual.astype(np.int32) - 33).mean() < p.min_phred:
                        st.rej_phred += 1
                        ok = False
                        break
                if len(seq) < p.min_len:
                    st.rej_len += 1
                    ok = False
                    break
                recs.append((blk.names[i], seq, qual))
            if not ok:
                continue
            if p.dedupe:
                key = b"|".join(r[1].tobytes() for r in recs)
                if key in seen:
                    st.rej_dup += 1
                    continue
                seen.add(key)
            st.accepted += 1
            out1.append(recs[0])
            if pe:
                out2.append(recs[1])

    if p.near_dedupe and out1:
        # near-duplicate pass over the accepted set (PE: mates concatenate
        # so a pair is near-dup only when BOTH ends nearly match)
        if pe:
            seqs = [np.concatenate([a[1], b[1]])
                    for a, b in zip(out1, out2)]
        else:
            seqs = [r[1] for r in out1]
        dup = near_duplicate_mask(seqs, p.near_max_subs)
        st.rej_near_dup = int(dup.sum())
        st.accepted -= st.rej_near_dup
        out1 = [r for r, d in zip(out1, dup) if not d]
        if pe:
            out2 = [r for r, d in zip(out2, dup) if not d]
    write_fastq(outpath, out1)
    if pe and pair_outpath:
        write_fastq(pair_outpath, out2)
    return st
